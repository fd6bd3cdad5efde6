"""Local execution with the reference's web API surface: ``run`` and the
task, ``Job`` / ``Batch`` and ``run_async`` layer over it, each on the GPU
unless the caller names another device."""

from .run import run
from .container import Batch, BatchData, Job
from .asynchronous import run_async
from .api import abort, delete, delete_old, estimate_cost, load, monitor, real_cost, start, upload

__all__ = [
    "run", "run_async", "Job", "Batch", "BatchData",
    "upload", "start", "monitor", "load", "estimate_cost", "real_cost",
    "abort", "delete", "delete_old",
]
