"""The solver under test, driven through its public names as
``tidy3d_tpu_torch.web.run`` drives it: lowering once, then whole solves
(runner, memory gate, time loop, monitor data). Nothing here picks a
kernel tier or looks inside the solver's arithmetic; it reads the tier, k,
and the kernels' launch counters, which the solver keeps itself."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import time

import numpy as np
import torch

# per main kernel: the counter module, and the names its launches carry
KERNELS = {
    "kstep": ("kstep", ("kstep_kernel",)),
    "fused": ("fused", ("fused_step_kernel",)),
    "family": ("step", ("family_update_kernel", "family_update_bloch_kernel",
                        "family_bricks_kernel")),
    "poles": ("poles", ("poles_kernel",)),
}


class Spans:
    """Host spans of the harness, kept as ``(name, start, end)`` in
    seconds of the host's monotonic clock and ``(name, start, end)`` in ns
    of its wall clock, the clock the profiler stamps device events with."""

    def __init__(self):
        self.done = []
        self.wall = []

    @contextlib.contextmanager
    def __call__(self, name):
        t0, w0 = time.perf_counter(), time.time_ns()
        yield
        self.done.append((name, t0, time.perf_counter()))
        self.wall.append((name, w0, time.time_ns()))

    def last(self, name) -> float:
        """Seconds of the latest span called ``name``."""
        _, t0, t1 = [sp for sp in self.done if sp[0] == name][-1]
        return t1 - t0


def counters():
    """The launch counters of the main kernels: ``{kernel: (calls,
    device launches)}``."""
    out = {}
    for key, (mod, _) in KERNELS.items():
        m = importlib.import_module(f"tidy3d_tpu_torch.solver.kernels.{mod}")
        out[key] = (int(m.LAUNCHES), int(m.DEVICE_LAUNCHES))
    return out


def lower(sim, device):
    from tidy3d_tpu_torch.plugins.mode.device_solver import solve_on
    from tidy3d_tpu_torch.solver.lowering import lower as lower_sim

    with solve_on(device):
        return lower_sim(sim)


def solve(sim, plan, device, spans: Spans):
    """One whole solve as ``web.run`` makes it after lowering; returns the
    ``SimulationData`` and the runner's tier and k."""
    from tidy3d_tpu_torch.plugins.mode.device_solver import solve_on
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
    from tidy3d_tpu_torch.web.run import assemble_sim_data

    with spans("runner_init"):
        runner = FDTDRunner(plan, device=device)
        runner.check_memory_budget()
    with spans("run"):
        raw = runner.run()
    with spans("assemble"):
        with solve_on(device):
            data = assemble_sim_data(sim, plan, raw, runner)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    return data, runner.tier_name, runner.k


def warm_up(sim, plan, device, spans: Spans):
    """A solve of the plan's first tenth of steps (two of the solver's
    twenty chunks): every kernel the plan uses is loaded, every code path
    of a solve has run once."""
    n = max(2 * (plan.num_steps // 20), 2)
    short = dataclasses.replace(plan, num_steps=n, tmesh=plan.tmesh[:n],
                                waveforms=plan.waveforms[:, :n])
    solve(sim, short, device, spans)


def outputs(data, pb) -> dict:
    """The monitor data of a solve in the reference's layout: a flux
    spectrum per flux monitor, the DFT fields of a field monitor, and the
    samples (time first) of a time monitor."""
    out = {}
    for mon in pb.monitors:
        kind, name = mon[:2]
        md = data[name]
        if kind == "flux":
            out[name] = np.asarray(md.flux.values)
        elif kind == "field":
            out[name] = {c: np.asarray(getattr(md, c).values)
                         for c in mon[4]}
        else:
            out[name] = {c: np.moveaxis(np.asarray(getattr(md, c).values),
                                        -1, 0) for c in mon[3]}
    return out
