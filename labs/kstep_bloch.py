"""Lab: the two-copy (Bloch) k-step kernel against the real one, same grid.

    python3 labs/kstep_bloch.py

On the Bloch dipole case of ``chip_smoke.py`` (256^3 cells, an eps = 8
slab, so per-cell E coefficients) and on the same case without its slab
(scalar coefficients), times one group of k = 2 steps of
- the complex run: Bloch x 0.27 and y -0.13, two copies in one launch;
- the real run: the same walls plain periodic, one copy;
with CUDA events over 20 groups after a warm-up, in turns complex, real,
real, complex, and the host time of one wrapper call (20 calls without a
synchronise). Prints ms per group, the ratio complex / (2 x real) and the
card's name and power limit. Then three torch.profiler windows of 10
groups each (complex, real, complex, with the slab) print how many of the
10 kernel launches the profiler recorded, and their mean device time.
Needs a CUDA device.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("kstep_bloch: no CUDA device is available", file=sys.stderr)
        return 2
    import tidy3d_tpu_torch as td
    from tidy3d_tpu_torch import _build
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
    from tidy3d_tpu_torch.solver.kernels import kstep
    from tidy3d_tpu_torch.solver.lowering import lower

    smi = chip_smoke.nvidia_smi()
    _build.load_all(["kstep"])
    dev = torch.device("cuda")
    base = chip_smoke.bloch_case(td)
    real_walls = td.BoundarySpec(x=td.Boundary.periodic(),
                                 y=td.Boundary.periodic(),
                                 z=td.Boundary.pml())
    cases = {}
    for slab in (True, False):
        sim = base if slab else base.copy(update=dict(structures=[]))
        for name, s in (("complex", sim),
                        ("real", sim.copy(update=dict(
                            boundary_spec=real_walls)))):
            runner = FDTDRunner(lower(s), device=dev)
            assert runner.tier == "kstep"
            assert runner.is_complex == (name == "complex")
            cases[(slab, name)] = (runner, chip_smoke.random_state(runner, 1))

    def group(key):
        runner, st = cases[key]
        return lambda: kstep.kstep_group(st, runner.consts, runner.meta,
                                         runner.tables, 36, runner.k,
                                         out=st["alt"])

    for slab in (True, False):
        ms = {"complex": [], "real": []}
        for name in ("complex", "real", "real", "complex"):
            ms[name].append(chip_smoke.cuda_ms(group((slab, name)), 20))
        host = {}
        for name in ("complex", "real"):
            fn = group((slab, name))
            chip_smoke.sync()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            host[name] = (time.perf_counter() - t0) / 20 * 1e3
            chip_smoke.sync()
        c, r = float(np.mean(ms["complex"])), float(np.mean(ms["real"]))
        print(f"[lab] 256^3 Bloch dipole {'with' if slab else 'without'} "
              f"the slab: complex {ms['complex']} ms/group, real "
              f"{ms['real']} ms/group; complex / (2 x real) "
              f"{c / (2 * r):.3f}; host per call complex "
              f"{host['complex']:.3f} ms, real {host['real']:.3f} ms | "
              f"{smi}", flush=True)

    from torch.profiler import ProfilerActivity, profile

    for name in ("complex", "real", "complex"):
        fn = group((True, name))
        chip_smoke.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            chip_smoke.sync()
        rows = [e for e in prof.key_averages()
                if "kstep_kernel" in e.key and e.device_type.name == "CUDA"]
        n = sum(e.count for e in rows)
        us = sum(getattr(e, "self_device_time_total", 0.0) for e in rows)
        print(f"[lab] profiler window, {name}: {n} of 10 kernel launches "
              f"recorded, {us / max(n, 1) / 1e3:.3f} ms each | {smi}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
