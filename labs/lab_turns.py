"""Lab: the redesigned lab kernels of several trees, in turns.

    python3 labs/lab_turns.py [ROOT ...]

For each ROOT (a checkout of this repository, default: the one that holds
this script), in the order given, a child process builds that tree's
``csrc/lab_kstep.cu``, ``csrc/lab_pole.cu`` and ``csrc/lab_step.cu`` (one
nvcc each, all at once) and times, on one card, each call first held to
its plain version (relative to the largest magnitude):
``kernel_lab2.lab_kstep`` at 384^3, bx = 8, k = 1..4, f32 and bf16
storage (ms per group, best of 3 runs of 10 calls, CUDA events; to 1e-6
f32, 1e-2 bf16; with the registers, shared bytes, blocks per SM and
chunks where the tree reports them); ``kernel_lab.lab_step``'s curl,
noroll and copy at 384^3, f32 and bf16, bx = 8 and 4 (ms per step, best
of 3 runs of 20; to 1e-6 and 1e-2; with the tree's resources for the
stencil where it reports them); ``pole_lab``'s ``pole_chan_bf16`` at the
lab's size (ms per call, best of 3 runs of 3, within 1e-2) and
``curl_mix`` (ms per call on the
lab's constant window at R = 600, best of 3 runs of 3; held to plain
there and on a seeded window at R = 40, within
``pole_lab.kernel_tolerance``). Name a tree twice to run it in two turns
(parent, this, this, parent). Prints one JSON line per tree and turn, then
the card's name and power limit. Needs a CUDA device.
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
    from tidy3d_tpu_torch import _build
    from tidy3d_tpu_torch.labs import _common, kernel_lab2, pole_lab

    assert os.path.dirname(kernel_lab2.__file__).startswith(root)
    _build.load_all(["lab_kstep", "lab_pole", "lab_step"])
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
    out["step"] = step_lab(gen)
    inputs = pole_lab.make_inputs("pole_chan_bf16", seed=9, device=dev)
    got = pole_lab.run("pole_chan_bf16", inputs)
    ref = pole_lab.pole_chan_reference(*inputs)[0]
    err = float((got.float() - ref.float()).abs().max()
                / ref.float().abs().max())
    assert err <= 1e-2, f"{root} pole_chan_bf16: {err:.3e}"
    ms = min(_common.cuda_ms(lambda: pole_lab.run("pole_chan_bf16", inputs),
                             3) for _ in range(3))
    out["pole_chan_bf16"] = {"ms": ms, "err": err}
    out["curl_mix"] = curl_mix()
    out["ptxas"] = _common.registers_of("lab_kstep", "lab_kstep_kernel")
    out["ptxas_step"] = _common.registers_of("lab_step", "lab_step_kernel")
    out["ptxas_curl_mix"] = _common.registers_of("lab_pole", "curl_mix")
    return out


def step_lab(gen) -> dict:
    """The step lab's variants, ms per step by key and bx (the tree's
    modules, imported by ``child``)."""
    import torch
    from tidy3d_tpu_torch.labs import _common, kernel_lab

    dev = torch.device("cuda")
    names = kernel_lab.E + kernel_lab.H
    out = {}
    for dname, dtype, tol in (("f32", torch.float32, 1e-6),
                              ("bf16", torch.bfloat16, 1e-2)):
        f = {c: torch.randn((N,) * 3, generator=gen, device=dev).to(dtype)
             for c in names}
        o = {c: torch.empty_like(v) for c, v in f.items()}
        for variant in ("curl", "noroll", "copy"):
            ref = kernel_lab.lab_step_reference(f, variant)
            scale = max(float(v.float().abs().max()) for v in ref.values())
            for bx in (8, 4):
                got = kernel_lab.lab_step(f, variant, bx)
                err = max(float((got[c].float() - ref[c].float()).abs().max())
                          for c in names) / scale
                assert err <= tol, f"{variant} {dname} bx={bx}: {err:.3e}"
                del got
                ms = min(_common.cuda_ms(lambda: kernel_lab.lab_step(
                    f, variant, bx, out=o), 20) for _ in range(3))
                row = {"ms": ms, "err": err}
                if hasattr(kernel_lab, "resources") and variant != "copy":
                    row.update(kernel_lab.resources(variant, dtype))
                out[f"{variant}_{dname}_bx{bx}"] = row
            del ref
        del f, o
        torch.cuda.empty_cache()
    return out


def curl_mix() -> dict:
    """``curl_mix`` at the lab's size: held to plain on the constant window
    at R = 600 and on a seeded one at R = 40, timed on the constant one."""
    import torch
    from tidy3d_tpu_torch.labs import _common, pole_lab

    dev = torch.device("cuda")
    errs = {}
    for reps, constant in ((pole_lab.R, pole_lab.CURL_MIX_WINDOW),
                           (40, None)):
        inputs = pole_lab.make_inputs("curl_mix", seed=10, device=dev,
                                      constant=constant)
        got = pole_lab.run("curl_mix", inputs, reps=reps)
        ref = pole_lab.curl_mix_reference(*inputs, reps=reps, grid=1)[0]
        err = float((got - ref).abs().max() / ref.abs().max())
        tol = pole_lab.kernel_tolerance("curl_mix", reps)
        assert err <= tol, f"curl_mix R={reps}: {err:.3e}"
        errs[f"err_r{reps}"] = err
    inputs = pole_lab.make_inputs("curl_mix", device=dev,
                                  constant=pole_lab.CURL_MIX_WINDOW)
    ms = min(_common.cuda_ms(lambda: pole_lab.run("curl_mix", inputs), 3)
             for _ in range(3))
    out = {"ms": ms, **errs}
    if hasattr(pole_lab, "curl_mix_resources"):
        out.update(pole_lab.curl_mix_resources())
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
