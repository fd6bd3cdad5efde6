"""Lab: the k-step lab and the bf16 pole update of several trees, in turns.

    python3 labs/lab_turns.py [ROOT ...]

For each ROOT (a checkout of this repository, default: the one that holds
this script), in the order given, a child process builds that tree's
``csrc/lab_kstep.cu`` and ``csrc/lab_pole.cu`` and times, on one card:
``kernel_lab2.lab_kstep`` at 384^3, bx = 8, k = 1..4, f32 and bf16 storage
(ms per group, best of 3 runs of 10 calls, CUDA events; with the
registers, shared bytes, blocks per SM and chunks where the tree reports
them), each first held to
its plain version (1e-6 f32, 1e-2 bf16, relative to the largest magnitude),
and ``pole_lab``'s ``pole_chan_bf16`` at the lab's size (ms per call, best
of 3 runs of 3, after a check against plain within 1e-2). Name a tree twice
to run it in two turns (parent, this, this, parent). Prints one JSON line
per tree and turn, then the card's name and power limit. Needs a CUDA
device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 384


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from tidy3d_tpu_torch.labs import _common, kernel_lab2, pole_lab

    assert os.path.dirname(kernel_lab2.__file__).startswith(root)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)
    names = kernel_lab2.E + kernel_lab2.H
    out = {"root": root, "kstep": {}}
    for dname, dtype, tol in (("f32", torch.float32, 1e-6),
                              ("bf16", torch.bfloat16, 1e-2)):
        f = {c: torch.randn((N,) * 3, generator=gen, device=dev).to(dtype)
             for c in names}
        o = {c: torch.empty_like(v) for c, v in f.items()}
        for k in kernel_lab2.KS:
            got = kernel_lab2.lab_kstep(f, k, 8)
            ref = kernel_lab2.lab_kstep_reference(f, k, 8)
            scale = max(float(v.float().abs().max()) for v in ref.values())
            err = max(float((got[c].float() - ref[c].float()).abs().max())
                      for c in names) / scale
            assert err <= tol, f"{root} k={k} {dname}: {err:.3e}"
            del got, ref
            ms = min(_common.cuda_ms(lambda: kernel_lab2.lab_kstep(
                f, k, 8, out=o), 10) for _ in range(3))
            out["kstep"][f"k{k}_{dname}"] = {"ms": ms, "err": err}
            if hasattr(kernel_lab2, "resources"):
                out["kstep"][f"k{k}_{dname}"].update(
                    kernel_lab2.resources(k, dtype),
                    chunks=kernel_lab2.chunks_on(N, k, dtype, dev))
        del f, o
        torch.cuda.empty_cache()
    inputs = pole_lab.make_inputs("pole_chan_bf16", seed=9, device=dev)
    got = pole_lab.run("pole_chan_bf16", inputs)
    ref = pole_lab.pole_chan_reference(*inputs)[0]
    err = float((got.float() - ref.float()).abs().max()
                / ref.float().abs().max())
    assert err <= 1e-2, f"{root} pole_chan_bf16: {err:.3e}"
    ms = min(_common.cuda_ms(lambda: pole_lab.run("pole_chan_bf16", inputs),
                             3) for _ in range(3))
    out["pole_chan_bf16"] = {"ms": ms, "err": err}
    out["ptxas"] = _common.registers_of("lab_kstep", "lab_kstep_kernel")
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
                              text=True, timeout=1800)
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
