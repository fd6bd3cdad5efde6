"""Task-style API over the local TPU runner.

Behavioral model: the upstream tidy3d web/api/webapi.py (:49-945 —
upload/start/monitor/load/estimate_cost/abort against the cloud). Here tasks
are in-process records: ``upload`` registers + validates, ``start`` executes
(synchronously by default or on a worker thread), ``monitor`` waits, ``load``
returns the SimulationData. The signatures match so reference notebooks and
the Batch machinery run unchanged.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..components.simulation import Simulation
from ..exceptions import WebError
from ..log import log
from .run import run as _run_local

# in-process task registry
_TASKS: Dict[str, "LocalTask"] = {}
_LOCK = threading.Lock()


@dataclass
class LocalTask:
    task_id: str
    task_name: str
    simulation: Simulation
    folder_name: str = "default"
    verbose: bool = True
    status: str = "draft"
    sim_data: object = None
    error: Optional[BaseException] = None
    thread: Optional[threading.Thread] = None
    path: Optional[str] = None
    callback_url: Optional[str] = None
    solver_version: Optional[str] = None
    device: str = "cuda"

    def execute(self):
        self.status = "running"
        try:
            self.sim_data = _run_local(self.simulation, task_name=self.task_name,
                                       verbose=self.verbose, device=self.device)
            self.status = "success"
        except BaseException as exc:  # noqa: BLE001
            self.error = exc
            self.status = "diverged" if "diverged" in str(exc).lower() else "error"


def upload(simulation: Simulation, task_name: str = "task", folder_name: str = "default",
           callback_url: str = None, verbose: bool = True, simulation_type: str = None,
           parent_tasks=None, source_required: bool = True, solver_version=None,
           device: str = "cuda") -> str:
    """Validate + register a simulation; returns the task id. The task
    runs on ``device`` (the GPU by default; "cpu" for the plain path)."""
    simulation.validate_pre_upload(source_required=source_required)
    task_id = str(uuid.uuid4())[:13]
    task = LocalTask(task_id=task_id, task_name=task_name, simulation=simulation,
                     folder_name=folder_name, verbose=verbose,
                     callback_url=callback_url, solver_version=solver_version,
                     device=device)
    task.status = "uploaded"
    with _LOCK:
        _TASKS[task_id] = task
    if verbose:
        log.info(f"Created task '{task_name}' with task_id '{task_id}'.")
    return task_id


def get_task(task_id: str) -> LocalTask:
    with _LOCK:
        if task_id not in _TASKS:
            raise WebError(f"task '{task_id}' not found")
        return _TASKS[task_id]


def get_info(task_id: str, verbose: bool = True) -> LocalTask:
    return get_task(task_id)


def start(task_id: str, solver_version=None, worker_group=None, asynchronous: bool = True):
    """Start the solve. By default runs on a worker thread so ``start`` of a
    batch overlaps (the single TPU serializes execution anyway)."""
    task = get_task(task_id)
    if task.status in ("running", "success"):
        return
    if asynchronous:
        thread = threading.Thread(target=task.execute, daemon=True)
        task.thread = thread
        thread.start()
    else:
        task.execute()


def get_run_info(task_id: str):
    task = get_task(task_id)
    return {"status": task.status}


def monitor(task_id: str, verbose: bool = True) -> None:
    """Block until the task completes."""
    task = get_task(task_id)
    if task.thread is not None:
        task.thread.join()
    elif task.status == "uploaded":
        task.execute()
    if task.status == "error" and task.error is not None:
        raise WebError(f"task '{task.task_name}' failed: {task.error}") from task.error


def load(task_id: str, path: str = None, replace_existing: bool = True,
         verbose: bool = True, progress_callback=None):
    """Return the SimulationData of a completed task."""
    task = get_task(task_id)
    monitor(task_id, verbose=verbose)
    if task.sim_data is None:
        raise WebError(f"task '{task.task_name}' has no data (status={task.status})")
    if task.sim_data.final_decay_value > task.simulation.shutoff > 0:
        log.warning(
            f"Simulation final field decay value of {task.sim_data.final_decay_value:.2e} "
            f"is greater than the simulation shutoff threshold of "
            f"{task.simulation.shutoff:.2e}. Consider running the simulation again "
            "with a larger 'run_time' duration for more accurate results.")
    if path is not None:
        task.sim_data.to_file(path)
    return task.sim_data


def delete(task_id: str):
    with _LOCK:
        _TASKS.pop(task_id, None)


def delete_old(days_old: int = 100, folder: str = "default"):
    return 0


def abort(task_id: str):
    task = get_task(task_id)
    task.status = "aborted"


def estimate_cost(task_id: str, verbose: bool = True) -> float:
    """FlexCredit-style cost proxy ~ grid points x time steps
    (reference: webapi.py:793-877)."""
    task = get_task(task_id)
    sim = task.simulation
    cost = 2e-11 * sim.num_computational_grid_points * sim.num_time_steps
    cost = max(cost, 0.025)
    if verbose:
        log.info(f"Estimated cost: {cost:.3f} (local execution is free).")
    return cost


def real_cost(task_id: str, verbose: bool = True) -> float:
    return estimate_cost(task_id, verbose=verbose)


def download(task_id: str, path: str = "simulation_data.hdf5", verbose: bool = True,
             progress_callback=None):
    task = get_task(task_id)
    if task.sim_data is not None:
        task.sim_data.to_file(path)


def download_log(task_id: str, path: str = "tidy3d.log", verbose: bool = True):
    task = get_task(task_id)
    if task.sim_data is not None and task.sim_data.log:
        with open(path, "w", encoding="utf-8") as f:
            f.write(task.sim_data.log)


def test() -> None:
    """Connectivity check (always succeeds locally)."""
    log.info("Local TPU execution configured correctly.")
