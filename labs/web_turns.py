"""Lab: the ``web.run`` throughput of several trees, in turns.

    python3 labs/web_turns.py [ROOT ...]

For each ROOT (a checkout of this repository, default: the one that holds
this script), in the order given, a child process imports that tree's
``tidy3d_tpu_torch`` and ``chip_smoke.py`` and runs, on one card, the
main paths of ``chip_smoke.py`` phases 9, 11 and 14: ``web.run`` of the
broadband case on the two-phase tier, the dispersive case on the fused
tier, both on the default (kstep) tier, the Bloch dipole and the angled
plane wave, and a full-length run of the broadband case over 4 virtual
x-shards through ``FDTDRunner.run``. It prints, per run, Gcell*steps/s,
steps run and the peak of ``torch.cuda.max_memory_allocated`` (reset just
before the run) as one JSON line per tree and turn, then the card's name
and power limit. Name a tree twice to run it in two turns (parent, this,
this, parent). Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    import tidy3d_tpu_torch as td
    from tidy3d_tpu_torch.solver.lowering import lower

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    out = {"root": root}

    def web(name, sim, tier=None):
        if tier is None:
            os.environ.pop("TIDY3D_TPU_KERNEL", None)
        else:
            os.environ["TIDY3D_TPU_KERNEL"] = tier
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        data = td.web.run(sim, task_name="web_turns", verbose=False)
        lines = data.log.splitlines()
        out[name] = {
            "rate": float(lines[2].split("throughput: ")[1].split()[0]),
            "steps": int(lines[1].split("steps run: ")[1].split()[0]),
            "peak": torch.cuda.max_memory_allocated()}

    web("broadband_pallas2", cs.full_case(td), "pallas2")
    web("dispersive_fused", cs.dispersive_case(td), "fused")
    web("dispersive_kstep", cs.dispersive_case(td))
    web("broadband_kstep", cs.full_case(td))
    web("bloch_dipole", cs.bloch_case(td))
    web("angled_plane_wave", cs.planewave_case(td))
    os.environ.pop("TIDY3D_TPU_KERNEL", None)
    plan = lower(cs.full_case(td))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runner = cs.sharded_runner(plan, [torch.device("cuda")] * 4)
    runner.run()
    out["broadband_4_shards"] = {
        "rate": float(np.prod(plan.shape)) * runner.steps_run
        / runner.wall_time / 1e9,
        "steps": runner.steps_run,
        "peak": torch.cuda.max_memory_allocated()}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        print(json.dumps(child(os.path.abspath(argv[1]))), flush=True)
        return 0
    roots = [os.path.abspath(r) for r in (argv or [HERE])]
    for turn, root in enumerate(roots):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", root], capture_output=True,
                              text=True, timeout=1800, cwd=root)
        if proc.returncode:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(json.dumps({"turn": turn, **json.loads(line)}), flush=True)
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    print(proc.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
