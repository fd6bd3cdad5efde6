"""Lab: the one-step kernels and the fused tier's ``web.run`` of several
trees, in turns.

    python3 tidy3d_tpu_torch/labs/onestep_turns.py ROOT [ROOT ...]

For each ROOT (a checkout of this repository), in the order given, a child
process imports that tree's ``tidy3d_tpu_torch`` and ``chip_smoke.py`` and
runs on one card:

* ``web.run`` under the default tier of ``chip_smoke.timemonitor_case``
  (the 384^3 dispersive case with a point Ez probe and a flux-time monitor
  from the default start, which keep it off the k-step tier's group ends;
  the case is taken from the ``chip_smoke.py`` beside this script, so that
  every tree runs the same one): Gcell*steps/s, steps run, the tier logged
  and the peak of ``torch.cuda.max_memory_allocated``;
* the fused step on the 384^3 dispersive case from a random state, float32
  and bf16, in ms a step (CUDA events): the kernel with the pole update
  inside where the tree's ``fused_step`` returns the new pole currents,
  else the kernel followed by the tree's plain ``update_poles``, as that
  tree's fused tier steps;
* the family update on the 384^3 broadband case, float32 and bf16, in ms a
  launch (an E and an H launch, halved);
* the fused step of ``chip_smoke.many_poles_case`` (Au on Cr, 13 pole
  slots, 280^3) from a random state, float32 and bf16, in ms a step: the
  table path, through that tree's ``fused_step`` (with its drive and table
  cache where the tree's ``fused_step`` takes them), and its device ms a
  step by kernel instantiation (torch.profiler over 5 steps: the bulk and
  the shell launch).

It prints one JSON line per tree and turn, then the card's name and power
limit. Name a tree twice to run it in two turns (parent, this, this,
parent). ``--many-only`` first runs the 13-slot fused steps alone (for
variants of the table path). Needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPS = 20


def _this_chip_smoke():
    """This tree's ``chip_smoke.py`` as a module of another name (its cases
    take the package as an argument)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_cases", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: str, many_only: bool = False) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    import tidy3d_tpu_torch as td
    from tidy3d_tpu_torch.labs._common import cuda_ms
    from tidy3d_tpu_torch.solver import fdtd
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
    from tidy3d_tpu_torch.solver.kernels import fused, step
    from tidy3d_tpu_torch.solver.lowering import lower

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    out = {"root": root}
    os.environ.pop("TIDY3D_TPU_KERNEL", None)
    dev = torch.device("cuda")

    if many_only:
        return _many_poles(root, out)
    sim = _this_chip_smoke().timemonitor_case(td)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data = td.web.run(sim, task_name="onestep_turns", verbose=False)
    lines = data.log.splitlines()
    out["timemonitor_web_run"] = {
        "rate": float(lines[2].split("throughput: ")[1].split()[0]),
        "steps": int(lines[1].split("steps run: ")[1].split()[0]),
        "tier": lines[-1].split("kernel tier: ")[1].split(" [")[0],
        "peak": torch.cuda.max_memory_allocated()}
    del data

    plan_d = lower(cs.dispersive_case(td))
    plan_b = lower(cs.full_case(td))
    for prec in ("float32", "bfloat16"):
        r = FDTDRunner(plan_d, device=dev, kernel="fused", precision=prec)
        st = cs.random_state(r, 5)
        src = cs.step_sources(r)
        inside = len(fused.fused_step(st, r.consts, r.meta, src)) == 4
        if inside:
            q_out = [{c: (torch.empty_like(a), torch.empty_like(b))
                      for c, (a, b) in Qp.items()} for Qp in st["Q"]]

            def once():
                fused.fused_step(st, r.consts, r.meta, src, q_out=q_out)
        else:
            def once():
                new_e = fused.fused_step(st, r.consts, r.meta, src)[0]
                fdtd.update_poles(new_e, st["E"], st["Q"], r.consts)
        out[f"fused_step_{prec}"] = {"ms": cuda_ms(once, REPS),
                                     "pole_update_inside": inside}
        del st, r
        torch.cuda.empty_cache()

        r = FDTDRunner(plan_b, device=dev, kernel="pallas2", precision=prec)
        st = cs.random_state(r, 2)

        def pair():
            new_e, _ = step.family_update("E", st, r.consts, st["H"], r.meta)
            step.family_update("H", st, r.consts, new_e, r.meta)

        out[f"family_update_{prec}"] = {"ms": cuda_ms(pair, REPS) / 2}
        del st, r
        torch.cuda.empty_cache()
    out["cells"] = int(np.prod(plan_d.shape))
    return _many_poles(root, out)


def _many_poles(root: str, out: dict) -> dict:
    """The 13-slot fused steps of the tree at ``root`` (imported by
    ``child``) into ``out``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    import tidy3d_tpu_torch as td
    from tidy3d_tpu_torch.labs._common import cuda_ms
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
    from tidy3d_tpu_torch.solver.kernels import fused
    from tidy3d_tpu_torch.solver.lowering import lower

    dev = torch.device("cuda")
    plan_m = lower(_this_chip_smoke().many_poles_case(td))
    carries = "drive_out" in inspect.signature(fused.fused_step).parameters
    for prec in ("float32", "bfloat16"):
        r = FDTDRunner(plan_m, device=dev, kernel="fused", precision=prec)
        st = cs.random_state(r, 34)
        src = cs.step_sources(r)
        kw = {"q_out": [{c: (torch.empty_like(a), torch.empty_like(b))
                         for c, (a, b) in Qp.items()} for Qp in st["Q"]]}
        if carries:
            kw.update(cache={}, drive_out={
                c: torch.empty(v.shape, dtype=torch.float32, device=dev)
                for c, v in st["E"].items()})
        out[f"fused_step_13_slots_{prec}"] = {
            "ms": cuda_ms(lambda: fused.fused_step(
                st, r.consts, r.meta, src, **kw), REPS),
            "launch_ms": _launch_ms(lambda: fused.fused_step(
                st, r.consts, r.meta, src, **kw), 5),
            "drive": carries}
        del st, r, kw
        torch.cuda.empty_cache()
    out["cells_13_slots"] = int(np.prod(plan_m.shape))
    return out


def _launch_ms(fn, reps: int) -> dict:
    """Device ms per call of each kernel ``fn`` launches, by name
    (torch.profiler over ``reps`` calls after one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us:
            out[evt.key] = dev_us / 1e3 / reps
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    many_only = "--many-only" in argv
    argv = [a for a in argv if a != "--many-only"]
    if argv[:1] == ["--child"]:
        print(json.dumps(child(os.path.abspath(argv[1]), many_only)),
              flush=True)
        return 0
    roots = [os.path.abspath(r) for r in (argv or [HERE])]
    for root in roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root]
            + ["--many-only"] * many_only,
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
