"""run_async: submit multiple simulations as a batch.

Behavioral model: the upstream tidy3d web/api/asynchronous.py:10.
"""

from __future__ import annotations

from typing import Dict

from ..components.simulation import Simulation
from .container import Batch, BatchData


def run_async(
    simulations: Dict[str, Simulation],
    folder_name: str = "default",
    path_dir: str = None,
    callback_url: str = None,
    num_workers: int = None,
    verbose: bool = True,
    simulation_type: str = "tidy3d",
    solver_version: str = None,
    device: str = "cuda",
) -> BatchData:
    """Run a dict of simulations on ``device`` and return a lazy BatchData."""
    batch = Batch(
        simulations=simulations, folder_name=folder_name, verbose=verbose,
        callback_url=callback_url, num_workers=num_workers,
        simulation_type=simulation_type, solver_version=solver_version,
        device=device,
    )
    return batch.run(path_dir=path_dir)
