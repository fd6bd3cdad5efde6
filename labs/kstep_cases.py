"""Lab: the k-step kernel's group time on the full-size cases of
``chip_smoke.py``, to compare two trees of the port in one run on the card.

    python3 labs/kstep_cases.py [--root DIR] [--poles 3,4,5,6]
        [--precision bfloat16] [case ...]

Imports ``tidy3d_tpu_torch`` and ``chip_smoke`` from DIR (default: the
checkout that holds this script), so that a second tree (an unpacked
``git archive`` of another commit) is measured with its own kernel. On each
case (``broadband`` and ``dispersive`` 384^3, ``au`` the 7-pole Au 280^3,
``bloch`` the Bloch dipole 256^3, ``sharded`` the dispersive case over 4
virtual x-shards of the card; all five by default) it checks one group of
k = 2 steps of the kernel against its plain version (to 1e-6 of the
largest magnitude, as ``chip_smoke.py`` does), times it (CUDA events, 20
groups after a warm-up) and prints it beside the group's bound (the bytes
of the state and constants once, ``chip_smoke.group_bound``). ``--poles``
adds the Au case's geometry filled with a Lorentz medium of each number
of poles given. Where the tree reports them, it prints the kernel's
registers and spills (ptxas) and blocks per SM of each instantiation. The
last line is the card's name and power limit. Needs a CUDA device.

``--precision bfloat16`` runs the cases (not ``sharded``) with the fields,
psi and pole currents stored in bf16, the kernel held to its plain version
to ``chip_smoke.TOL_BF16`` (1e-2) and the bound at the bf16 bytes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lorentz_case(td, chip_smoke, poles: int):
    """The Au case's half-space filled with a ``poles``-pole Lorentz medium
    (resonances spread over 1.2 to 3 f0)."""
    freq0 = td.C_0 / 1.55
    sim = chip_smoke.metal_case(td)
    coeffs = [(1.0 + 0.4 * i, freq0 * (1.2 + 1.8 * i / max(poles - 1, 1)),
               freq0 / 10) for i in range(poles)]
    return sim.copy(update=dict(structures=[sim.structures[0].copy(
        update=dict(medium=td.Lorentz(eps_inf=2.0, coeffs=coeffs)))]))


def time_case(case, make_sim, chip_smoke, td, dev, smi,
              precision=None) -> None:
    """One case: one group against plain, then 20 timed groups."""
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
    from tidy3d_tpu_torch.solver.kernels import kstep
    from tidy3d_tpu_torch.solver.lowering import lower

    t0 = time.perf_counter()
    plan = lower(make_sim(td))
    lower_s = time.perf_counter() - t0
    ncell = int(np.prod(plan.shape))
    runner = FDTDRunner(plan, device=dev, kernel="kstep",
                        **({"precision": precision} if precision else {}))
    k = runner.k
    if precision:
        st = chip_smoke.random_state(runner, 9)
        got = kstep.kstep_group(st, runner.consts, runner.meta,
                                runner.tables, 36, k, out=st["alt"])
        ref = kstep.kstep_group_reference(st, runner.consts, runner.meta,
                                          runner.tables, 36, k)
        chip_smoke.bf16_compare(chip_smoke.flat_state(got),
                                chip_smoke.flat_state(ref),
                                f"{plan.shape} {case}, {precision}")
        del got, ref
        bnd = chip_smoke.group_bound(runner, st, k)

        def group():
            return kstep.kstep_group(st, runner.consts, runner.meta,
                                     runner.tables, 36, k, out=st["alt"])
    elif case == "sharded":
        sr = chip_smoke.sharded_runner(plan, [dev] * 4)
        _, states = chip_smoke.compare_sharded_group(
            kstep, runner, sr, 14, f"{plan.shape} dispersive, 4 shards")
        bnd = chip_smoke.group_bound(runner, runner.init_state(), k)
        del runner

        def group():
            return chip_smoke.shard_group(kstep.kstep_group, sr, states, 36)
    else:
        st = chip_smoke.random_state(runner, 9)
        chip_smoke.compare_kstep(kstep, runner, st, f"{plan.shape} {case}, "
                                 f"{len(plan.poles)} poles")
        bnd = chip_smoke.group_bound(runner, st, k)

        def group():
            return kstep.kstep_group(st, runner.consts, runner.meta,
                                     runner.tables, 36, k, out=st["alt"])
    before = (kstep.LAUNCHES, getattr(kstep, "DEVICE_LAUNCHES", 0))
    ms = chip_smoke.cuda_ms(group, 20)
    groups = kstep.LAUNCHES - before[0]
    dev_launches = getattr(kstep, "DEVICE_LAUNCHES", groups) - before[1]
    print(f"[kstep_cases] {case} {plan.shape}, {len(plan.poles)} poles: "
          f"{ms:.3f} ms/group = {ms / k:.3f} ms/step "
          f"({ncell * k / ms / 1e6:.2f} Gcell*steps/s); bound "
          f"{bnd[0]:.3f} ms/group by {bnd[1]}, ratio {ms / bnd[0]:.2f}; "
          f"{dev_launches / max(groups, 1):.2f} device launches a kernel "
          f"call; lowered in {lower_s:.1f} s | {smi}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--poles", default="")
    ap.add_argument("--precision", default=None)
    ap.add_argument("cases", nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kstep_cases: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    import tidy3d_tpu_torch as td
    from tidy3d_tpu_torch import _build
    from tidy3d_tpu_torch.labs import _common
    from tidy3d_tpu_torch.solver.kernels import kstep

    assert os.path.dirname(td.__file__).startswith(root), td.__file__
    smi = _common.nvidia_smi()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    label = "kstep"
    if args.precision:
        from tidy3d_tpu_torch.solver.kernels import step

        bf = torch.bfloat16
        label = _build.label("kstep", step.storage_defines(bf, bf, bf))
        _build.load_all([("kstep", step.storage_defines(bf, bf, bf))])
    else:
        _build.load_all(["kstep"])
    print(f"[tree] {root}: {label} built in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    for mangled, (regs, st, ld) in sorted(
            _common.registers(label).items()):
        print(f"[ptxas] {mangled}: {regs} registers, spill {st}/{ld} B",
              flush=True)
    occupancy = getattr(kstep, "occupancy", None)
    if occupancy is not None:
        kw = {"storage": (torch.bfloat16,) * 3} if args.precision else {}
        rows = [f"{name} {'bulk' if bulk else 'shell'} "
                f"{occupancy(np_, bloch, bulk, **kw)}"
                for name, np_, bloch in [(f"NP={n}", n, False)
                                         for n in range(9)]
                + [("Bloch", 0, True)] for bulk in (True, False)]
        print(f"[occupancy] blocks per SM: {'; '.join(rows)}", flush=True)

    cases = args.cases or ["broadband", "dispersive", "au", "bloch"] + (
        [] if args.precision else ["sharded"])
    sims = {"broadband": chip_smoke.full_case,
            "dispersive": chip_smoke.dispersive_case,
            "au": chip_smoke.metal_case, "bloch": chip_smoke.bloch_case,
            "sharded": chip_smoke.dispersive_case}
    for n in [int(v) for v in args.poles.split(",") if v]:
        sims[f"lorentz{n}"] = (lambda n: lambda td: lorentz_case(
            td, chip_smoke, n))(n)
        cases.append(f"lorentz{n}")
    for case in cases:
        time_case(case, sims[case], chip_smoke, td, dev, smi,
                  args.precision)
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
