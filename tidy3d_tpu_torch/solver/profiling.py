"""Run telemetry of the port: the counterpart of
``tidy3d_tpu/solver/profiling.py``.

* every run records a :class:`RunMetrics` (Gcell·steps/s, wall, transfer and
  compile times, per-step cost), surfaced in the SimulationData log;
* set ``TIDY3D_TPU_PROFILE=/path/to/dir`` to capture a ``torch.profiler``
  trace of the run (``maybe_profile``): host activity always, the CUDA
  kernels on a CUDA device, with the runner's ranges ``fdtd.monitors``,
  ``fdtd.poles`` and ``fdtd.halo_exchange``. It is written as a Chrome
  trace (``chrome://tracing``, Perfetto) into that directory, where the
  JAX package writes its ``jax.profiler`` trace for TensorBoard.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


@dataclass
class RunMetrics:
    """Throughput counters for one solver execution."""

    num_cells: int = 0
    steps_run: int = 0
    wall_time: float = 0.0
    transfer_time: float = 0.0
    compile_time: float = 0.0
    final_decay: float = 1.0

    @property
    def gcell_steps_per_s(self) -> float:
        if self.wall_time <= 0:
            return 0.0
        return self.num_cells * self.steps_run / self.wall_time / 1e9

    @property
    def ms_per_step(self) -> float:
        if self.steps_run == 0:
            return 0.0
        return self.wall_time / self.steps_run * 1e3

    def log_lines(self) -> list:
        return [
            f"throughput: {self.gcell_steps_per_s:.3f} Gcell*steps/s",
            f"steps: {self.steps_run} ({self.ms_per_step:.3f} ms/step)",
            f"wall time: {self.wall_time:.3f} s "
            f"(+{self.transfer_time:.3f} s result transfer, "
            f"+{self.compile_time:.3f} s compile)",
            f"final field decay: {self.final_decay:.2e}",
        ]

    @classmethod
    def from_runner(cls, runner) -> "RunMetrics":
        return cls(
            num_cells=int(np.prod(runner.shape)),
            steps_run=getattr(runner, "steps_run", 0),
            wall_time=getattr(runner, "wall_time", 0.0),
            transfer_time=getattr(runner, "transfer_time", 0.0),
            compile_time=getattr(runner, "compile_time", 0.0),
            final_decay=getattr(runner, "final_decay", 1.0),
        )


@contextlib.contextmanager
def maybe_profile(device="cpu"):
    """A ``torch.profiler`` trace of the block, enabled by
    ``TIDY3D_TPU_PROFILE=<dir>``: CPU activity, and CUDA activity when
    ``device`` is a CUDA device. The trace goes to
    ``<dir>/tidy3d_tpu_torch_<pid>_<ns>.pt.trace.json``; the context yields
    that path, or None when profiling is off."""
    trace_dir = os.environ.get("TIDY3D_TPU_PROFILE")
    if not trace_dir:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"tidy3d_tpu_torch_{os.getpid()}_"
                                   f"{time.time_ns()}.pt.trace.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)

