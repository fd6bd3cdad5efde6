"""Lab: the family kernel's halo mode and the brick step of several trees,
in turns.

    python3 tidy3d_tpu_torch/labs/brick_turns.py ROOT [ROOT ...]

For each ROOT (a checkout of this repository), in the order given, a child
process imports that tree's ``tidy3d_tpu_torch`` and runs on one card, each
case taken from the ``chip_smoke.py`` beside this script (so that every
tree runs the same one) and stepped through that tree's own brick runner:

* the halo launch, one family over every brick (an E and an H update,
  halved; device ms by CUDA events, queued behind a sleep kernel so that
  the host's enqueue is not counted), of the 13-slot Au-on-Cr stack
  (``many_poles_case``) at full depth, 280^3, and cut in depth to 280 x
  280 x 96, both in (2, 2, 1) bricks, beside the unsharded launch: through
  the tree's ``FDTDRunner._family_update_bricks`` where it has one (one
  call a family, into the bricks' second buffer sets as its steps write),
  else its ``_family_update`` brick by brick;
* the brick step of the Kerr + TPA block case in (2, 2, 1) and of the
  dispersive case on 5 uneven x-bricks, against the unsharded ``pallas2``
  step of the same plan: ms a step by CUDA events over 10 steps from the
  zero state (the host's enqueue included), and the host's ms a step to
  enqueue them.

It prints one JSON line per tree and turn, then the card's name and power
limit. Name a tree twice to run it in two turns (parent, this, this,
parent). Needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPS = 10
STEPS = 10


def _this_chip_smoke():
    """This tree's ``chip_smoke.py`` as a module of another name (its cases
    take the package as an argument)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_cases", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``, its calls queued behind a sleep
    kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _bricks(plan, dev, decomp):
    import numpy as np

    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
    from tidy3d_tpu_torch.solver.sharding import ShardingPlan, make_mesh

    mesh, _ = make_mesh(devices=[dev] * int(np.prod(decomp)), decomp=decomp)
    return FDTDRunner(plan, device=dev,
                      sharding_plan=ShardingPlan(mesh, plan.shape))


def _halo_launch(plan, dev, decomp) -> dict:
    """One family over every brick and the unsharded family, device ms a
    launch (E and H, halved)."""
    import torch

    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner

    br = _bricks(plan, dev, decomp)
    states = br.init_state()["shards"]
    views = [br._views(st) for st in states]
    batched = hasattr(br, "_family_update_bricks")
    alts = [br._brick_alt(st) for st in states] if batched else None

    def bricks():
        for fam, src in (("E", "H"), ("H", "E")):
            if batched:
                br._family_update_bricks(
                    fam, views, [[v[src] for v in vs] for vs in views],
                    [st["halo"][src] for st in states], alts)
            else:
                for sh, st, vs in zip(br.shards, states, views):
                    br._family_update(fam, vs, [v[src] for v in vs], sh,
                                      st["halo"][src])

    out = {"bricks_ms": _device_ms(bricks, REPS) / 2, "batched": batched}
    del br, states, views, alts
    torch.cuda.empty_cache()
    ur = FDTDRunner(plan, device=dev, kernel="pallas2")
    uv = ur._views(ur.init_state())
    out["unsharded_ms"] = _device_ms(lambda: (
        ur._family_update("E", uv, [v["H"] for v in uv]),
        ur._family_update("H", uv, [v["E"] for v in uv])), REPS) / 2
    del ur, uv
    torch.cuda.empty_cache()
    return out


def _step_ms(runner) -> dict:
    """ms a step over ``STEPS`` steps from the zero state (CUDA events),
    and the host's ms a step to enqueue them."""
    import torch

    state = runner.init_state()
    for t in range(2):
        state = runner.step(t, state)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    t0.record()
    for t in range(2, 2 + STEPS):
        state = runner.step(t, state)
    t1.record()
    host = (time.perf_counter() - h0) * 1e3 / STEPS
    torch.cuda.synchronize()
    return {"ms": t0.elapsed_time(t1) / STEPS, "host_ms": host}


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import tidy3d_tpu_torch as td
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
    from tidy3d_tpu_torch.solver.lowering import lower

    assert os.path.dirname(os.path.dirname(os.path.abspath(
        td.__file__))) == root
    cs = _this_chip_smoke()
    os.environ.pop("TIDY3D_TPU_KERNEL", None)
    dev = torch.device("cuda")
    out = {"root": root}
    for name, nz in (("13_slots_280", cs.N_METAL + 24),
                     ("13_slots_cut", cs.N_MP_Z_TURNS)):
        plan = lower(cs.many_poles_case(td, nz=nz))
        out[name] = dict(_halo_launch(plan, dev, cs.BRICK_MANY),
                         shape=list(plan.shape))
        del plan
    for name, sim, decomp in (
            ("kerr", cs.block_case(td, cs.kerr_medium(td), probe=True),
             cs.BRICK_KERR),
            ("dispersive", cs.dispersive_case(td), cs.BRICK_DISP)):
        plan = lower(sim)
        br = _bricks(plan, dev, decomp)
        out[name] = {"bricks": _step_ms(br)}
        del br
        torch.cuda.empty_cache()
        ur = FDTDRunner(plan, device=dev, kernel="pallas2")
        out[name]["unsharded"] = _step_ms(ur)
        out[name]["ratio"] = out[name]["bricks"]["ms"] / \
            out[name]["unsharded"]["ms"]
        del ur, plan
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        print(json.dumps(child(os.path.abspath(argv[1]))), flush=True)
        return 0
    roots = [os.path.abspath(r) for r in (argv or [HERE])]
    for root in roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root],
            capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
