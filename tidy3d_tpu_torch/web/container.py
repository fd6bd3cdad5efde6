"""Job / Batch / BatchData containers.

Behavioral model: the upstream tidy3d web/api/container.py (Job:35,
Batch:342, BatchData:426): pydantic containers wrapping the task API with
parallel upload/start, collective monitoring, and lazy data loading.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import pydantic

from ..components.base import Tidy3dBaseModel, cached_property
from ..components.data.sim_data import SimulationData
from ..components.simulation import Simulation
from ..log import log
from . import api


class WebContainer(Tidy3dBaseModel):
    """Base for web-API containers."""


class Job(WebContainer):
    """Interface for managing the run of one simulation, on ``device``
    (the GPU by default, as ``web.run``)."""

    simulation: Simulation = pydantic.Field(..., title="Simulation")
    task_name: str = pydantic.Field(..., title="Task Name")
    folder_name: str = pydantic.Field("default", title="Folder Name")
    callback_url: Optional[str] = pydantic.Field(None, title="Callback URL")
    verbose: bool = pydantic.Field(True, title="Verbose")
    solver_version: Optional[str] = pydantic.Field(None, title="Solver Version")
    simulation_type: str = pydantic.Field("tidy3d", title="Simulation Type")
    parent_tasks: Optional[Tuple[str, ...]] = pydantic.Field(None)
    device: str = pydantic.Field("cuda", title="Device")

    @cached_property
    def task_id(self) -> str:
        return api.upload(
            simulation=self.simulation, task_name=self.task_name,
            folder_name=self.folder_name, callback_url=self.callback_url,
            verbose=self.verbose, solver_version=self.solver_version,
            device=self.device,
        )

    def run(self, path: str = None) -> SimulationData:
        self.start()
        self.monitor()
        return self.load(path=path)

    def start(self) -> None:
        api.start(self.task_id)

    def get_info(self):
        return api.get_info(self.task_id)

    @property
    def status(self) -> str:
        return api.get_task(self.task_id).status

    def monitor(self) -> None:
        api.monitor(self.task_id, verbose=self.verbose)

    def download(self, path: str = "simulation_data.hdf5") -> None:
        api.download(self.task_id, path=path, verbose=self.verbose)

    def load(self, path: str = None) -> SimulationData:
        return api.load(self.task_id, path=path, verbose=self.verbose)

    def delete(self) -> None:
        api.delete(self.task_id)

    def estimate_cost(self, verbose: bool = True) -> float:
        return api.estimate_cost(self.task_id, verbose=verbose)

    def real_cost(self, verbose: bool = True) -> float:
        return api.real_cost(self.task_id, verbose=verbose)


class BatchData(Tidy3dBaseModel):
    """Dict-like holder of the SimulationData of a batch (lazily loaded)."""

    task_paths: Dict[str, str] = pydantic.Field(default_factory=dict)
    task_ids: Dict[str, str] = pydantic.Field(default_factory=dict)
    verbose: bool = pydantic.Field(True)

    def load_sim_data(self, task_name: str) -> SimulationData:
        return api.load(self.task_ids[task_name], verbose=self.verbose)

    def __getitem__(self, task_name: str) -> SimulationData:
        return self.load_sim_data(task_name)

    def items(self):
        for task_name in self.task_ids:
            yield task_name, self.load_sim_data(task_name)

    def keys(self):
        return self.task_ids.keys()

    def values(self):
        for task_name in self.task_ids:
            yield self.load_sim_data(task_name)

    def __iter__(self):
        return iter(self.task_ids)

    def __len__(self):
        return len(self.task_ids)


class Batch(WebContainer):
    """Interface for running multiple simulations as a batch; on a single
    chip the solves serialize on device but pipeline through lowering."""

    simulations: Dict[str, Simulation] = pydantic.Field(..., title="Simulations")
    folder_name: str = pydantic.Field("default", title="Folder Name")
    verbose: bool = pydantic.Field(True, title="Verbose")
    solver_version: Optional[str] = pydantic.Field(None, title="Solver Version")
    simulation_type: str = pydantic.Field("tidy3d", title="Simulation Type")
    callback_url: Optional[str] = pydantic.Field(None)
    num_workers: Optional[int] = pydantic.Field(None)
    device: str = pydantic.Field("cuda", title="Device")

    @cached_property
    def jobs(self) -> Dict[str, Job]:
        return {
            task_name: Job(
                simulation=sim, task_name=task_name, folder_name=self.folder_name,
                verbose=self.verbose, solver_version=self.solver_version,
                callback_url=self.callback_url, device=self.device,
            )
            for task_name, sim in self.simulations.items()
        }

    @property
    def num_jobs(self) -> int:
        return len(self.simulations)

    def upload(self) -> None:
        for job in self.jobs.values():
            _ = job.task_id

    def start(self) -> None:
        for job in self.jobs.values():
            job.start()

    def monitor(self) -> None:
        for job in self.jobs.values():
            job.monitor()

    def run(self, path_dir: str = None) -> BatchData:
        self.upload()
        self.start()
        self.monitor()
        return self.load(path_dir=path_dir)

    def load(self, path_dir: str = None) -> BatchData:
        task_ids = {name: job.task_id for name, job in self.jobs.items()}
        task_paths = {name: f"{path_dir or '.'}/{tid}.hdf5"
                      for name, tid in task_ids.items()}
        return BatchData(task_ids=task_ids, task_paths=task_paths,
                         verbose=self.verbose)

    def delete(self) -> None:
        for job in self.jobs.values():
            job.delete()

    def estimate_cost(self, verbose: bool = True) -> float:
        return sum(job.estimate_cost(verbose=False) for job in self.jobs.values())

    def real_cost(self, verbose: bool = True) -> float:
        return self.estimate_cost(verbose=verbose)

    @property
    def get_info(self):
        return {name: job.get_info() for name, job in self.jobs.items()}
