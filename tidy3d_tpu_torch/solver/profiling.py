"""Throughput counters of a solver run: the port's copy of
``RunMetrics`` from ``tidy3d_tpu/solver/profiling.py``.

Every run records a :class:`RunMetrics` (Gcell·steps/s, wall, transfer and
compile times, per-step cost), surfaced in the SimulationData log. The JAX
package's device-trace context (``maybe_profile``, ``jax.profiler``) has no
counterpart here yet: its ``torch.profiler`` twin is a roadmap item.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
