"""Kernel lab: one vacuum leapfrog step per launch, to split what the fused
FDTD kernel pays for. The counterpart of ``scripts/kernel_lab.py``
(``make_step``, its ``pallas_call`` at :117).

Variants (one launch per step, both the E and the H update inside):
  curl    full leapfrog curl update: periodic y/z differences, x differences
          clamped at the domain's x ends
  noroll  the same arithmetic with neighbour = self in y and z
          (``f - f * 0.99``), the x differences kept
  copy    read and write of the 6 fields only (the memory ceiling)

``lab_step(fields, variant, bx)`` runs the CUDA kernel ``csrc/lab_step.cu``
for CUDA tensors and the plain version ``lab_step_reference`` for CPU
tensors. The result does not depend on ``bx``, the x depth of a block: on
the TPU it was the grid's block, here it is the x planes one CUDA block
writes. f32, or bf16 storage with bf16 arithmetic (every operation rounded
to bf16, the constants too, as the JAX lab's weak-typed scalars make it).
The stencil variants march each ``TY`` x ``TZ`` y/z tile through its x
chunks of ``bx`` planes: ``chunk_planes`` gives the planes a chunk stages
(a lead-in, its own, a lead-out), ``tile_rows`` and ``tile_cols`` the
wrapped y rows and z columns a tile stages.

    python3 -m tidy3d_tpu_torch.labs.kernel_lab [n] [bx list]

prints ms per step and Gcell*steps/s per variant (after copy, the time of
``torch._foreach_copy_`` of the same fields: the copy ceiling), the bound
and the card's name and power limit; ``LAB_BF16=1`` adds the bf16 runs.
Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import sys

import torch

from . import _common
from ..solver.kernels.step import launch

E = ("Ex", "Ey", "Ez")
H = ("Hx", "Hy", "Hz")
CA, CB = 0.999, 0.37
KEEP = 0.99             # the noroll variant's stand-in neighbour factor
VARIANTS = ("curl", "noroll", "copy")
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES: dict = {}     # kernel launches by ``launch_key``
TY, TZ = 16, 32         # owned y rows and z columns of a stencil tile
MAX_N = 46340           # the stencil kernel's y n + z in 32 bits


def launch_key(variant: str, dtype) -> str:
    return variant + ("_bf16" if dtype == torch.bfloat16 else "")


def constants(dtype):
    """``(ca, cb, keep)`` as the arithmetic of ``dtype`` sees them: rounded
    to bf16 for bf16 fields (a weak-typed scalar takes the array's type)."""
    return tuple(float(torch.tensor(c, dtype=dtype).item())
                 for c in (CA, CB, KEEP))


# --------------------------------------------------------------------------- #
# the plain PyTorch version
# --------------------------------------------------------------------------- #


def lab_step_reference(fields: dict, variant: str) -> dict:
    """One step on whole arrays. The E x differences are backward with
    plane 0 its own neighbour; the H x differences are forward, reading
    past plane n-1 a virtual E plane computed with a zero x difference (the
    Pallas kernel's clamped halo planes)."""
    if variant == "copy":
        return {c: fields[c].clone() for c in E + H}
    ca, cb, keep = constants(fields["Ex"].dtype)
    Ex, Ey, Ez = (fields[c] for c in E)
    Hx, Hy, Hz = (fields[c] for c in H)

    def bd(f, dim):
        if variant == "noroll":
            return f - f * keep
        return f - torch.roll(f, 1, dim)

    def fd(f, dim):
        if variant == "noroll":
            return f * keep - f
        return torch.roll(f, -1, dim) - f

    def bdx(f):
        return f - torch.cat([f[:1], f[:-1]])

    nEx = ca * Ex + cb * (bd(Hz, 1) - bd(Hy, 2))
    nEy = ca * Ey + cb * (bd(Hx, 2) - bdx(Hz))
    nEz = ca * Ez + cb * (bdx(Hy) - bd(Hx, 1))
    # the virtual plane n: the last plane's update with a zero x difference
    top = slice(-1, None)
    zero = Hz[top] - Hz[top]
    vEy = ca * Ey[top] + cb * (bd(Hx[top], 2) - zero)
    vEz = ca * Ez[top] + cb * ((Hy[top] - Hy[top]) - bd(Hx[top], 1))
    nHx = ca * Hx - cb * (fd(nEz, 1) - fd(nEy, 2))
    nHy = ca * Hy - cb * (fd(nEx, 2) - (torch.cat([nEz[1:], vEz]) - nEz))
    nHz = ca * Hz - cb * ((torch.cat([nEy[1:], vEy]) - nEy) - fd(nEx, 1))
    return dict(zip(E + H, (nEx, nEy, nEz, nHx, nHy, nHz)))


# --------------------------------------------------------------------------- #
# the CUDA kernel (csrc/lab_step.cu) through ctypes
# --------------------------------------------------------------------------- #


class LabStepParams(ctypes.Structure):
    """Mirror of ``struct LabStepParams`` in ``csrc/lab_step.cu``."""

    _fields_ = [
        ("inp", ctypes.c_void_p * 6), ("out", ctypes.c_void_p * 6),
        ("n", ctypes.c_int64),
        ("bx", ctypes.c_int32), ("variant", ctypes.c_int32),
        ("bf16", ctypes.c_int32),
        ("ca", ctypes.c_float), ("cb", ctypes.c_float),
        ("keep", ctypes.c_float),
    ]


def _library():
    return _common.library("lab_step", "t3d_lab_step", LabStepParams,
                           "t3d_lab_step_params_size")


def _lab_step_cuda(fields, variant, bx, out):
    first = fields["Ex"]
    n = first.shape[0]
    shape, dtype = (n, n, n), first.dtype
    if dtype not in DTYPES:
        raise ValueError(f"lab_step: unsupported dtype {dtype}")
    if bx < 1 or n % bx:
        raise ValueError(f"lab_step: bx = {bx} must divide n = {n}")
    if variant != "copy" and n > MAX_N:
        raise ValueError(f"lab_step: n = {n}; the stencil march indexes a "
                         f"plane in 32 bits (n <= {MAX_N})")
    if out is None:
        out = {c: torch.empty(shape, dtype=dtype, device=first.device)
               for c in E + H}
    p = LabStepParams()
    for i, c in enumerate(E + H):
        p.inp[i] = _common.check_cuda(fields[c], shape, (dtype,),
                                      c).data_ptr()
        p.out[i] = _common.check_cuda(out[c], shape, (dtype,),
                                      f"out {c}").data_ptr()
    if variant == "copy" and any(ptr % 16 for ptr in (*p.inp, *p.out)):
        raise ValueError("lab_step: the copy variant moves 16-byte vectors "
                         "and needs 16-byte aligned fields")
    p.n, p.bx = n, bx
    p.variant = VARIANTS.index(variant)
    p.bf16 = int(dtype == torch.bfloat16)
    p.ca, p.cb, p.keep = constants(dtype)
    launch(_library(), p, first.device, "lab_step")
    key = launch_key(variant, dtype)
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    return out


def lab_step(fields: dict, variant: str = "curl", bx: int = 8,
             out: dict = None) -> dict:
    """One step of ``variant``: the CUDA kernel for CUDA tensors (into
    ``out`` where given), the plain version for CPU tensors."""
    if variant not in VARIANTS:
        raise ValueError(f"lab_step: unknown variant '{variant}'")
    device = fields["Ex"].device
    if device.type == "cpu":
        return lab_step_reference(fields, variant)
    if device.type != "cuda":
        raise ValueError(f"lab_step: unsupported device '{device}'")
    return _lab_step_cuda(fields, variant, bx, out)


def tile_rows(n: int, y0: int) -> list:
    """The y rows a tile at ``y0`` stages: ``y0 - 1 .. y0 + TY``, wrapped
    (onto itself where n < TY + 2)."""
    return [(y0 - 1 + j) % n for j in range(TY + 2)]


def tile_cols(n: int, z0: int) -> list:
    """The z columns a tile at ``z0`` stages: ``z0 - 2 .. z0 + TZ + 1``
    (whole pairs on each side), wrapped."""
    return [(z0 - 2 + k) % n for k in range(TZ + 4)]


def chunk_planes(n: int, bx: int) -> list:
    """Per x chunk of ``bx`` planes, the planes the stencil march stages, in
    order: the lead-in (the plane before, or plane 0 again: only its Hy and
    Hz are read, for the x difference), the chunk's own planes, the
    lead-out (the plane after, whose E' its last H' reads; at the hi end
    plane n - 1 again, which gives the virtual plane's zero x
    difference)."""
    if bx < 1 or n % bx:
        raise ValueError(f"lab_step: bx = {bx} must divide n = {n}")
    return [[max(x0 - 1, 0), *range(x0, x0 + bx), min(x0 + bx, n - 1)]
            for x0 in range(0, n, bx)]


def kernel_symbol(variant: str, dtype) -> str:
    """What the mangled name of the stencil kernel's instantiation for
    ``variant``, ``dtype`` and pair-aligned fields holds (for ptxas's
    report and the SASS)."""
    return (f"lab_step_kernelILi{VARIANTS.index(variant)}E"
            + ("13__nv_bfloat16" if dtype == torch.bfloat16 else "f")
            + "Lb1E")


_RESOURCES: dict = {}


def resources(variant: str, dtype) -> dict:
    """Threads, shared bytes, blocks per SM (the CUDA occupancy
    calculator), registers and owned y rows of a tile (``ty``) of a stencil
    variant's instantiation for ``dtype``, as the library reports them."""
    key = (variant, dtype)
    if key not in _RESOURCES:
        fn = _common.library("lab_step", "t3d_lab_step_info", LabStepParams,
                             "t3d_lab_step_params_size")
        p = LabStepParams(variant=VARIANTS.index(variant),
                          bf16=int(dtype == torch.bfloat16))
        out = (ctypes.c_int * 5)()
        err = fn(ctypes.byref(p), out)
        if err:
            raise RuntimeError(f"lab_step: no stencil instantiation for "
                               f"{variant} (CUDA error {err})")
        _RESOURCES[key] = dict(threads=out[0], smem=out[1],
                               blocks_per_sm=out[2], registers=out[3],
                               ty=out[4])
        if out[4] != TY:
            raise RuntimeError(f"lab_step: the library's tile height "
                               f"{out[4]} is not TY = {TY}")
    return _RESOURCES[key]


def step_bytes(n: int, dtype) -> int:
    """Bytes one step must move: 6 fields read, 6 written."""
    return 12 * n ** 3 * torch.empty((), dtype=dtype).element_size()


FLOPS_PER_CELL = 36     # the curl: per component 2 differences, their
#                         difference and ca * f + cb * d (6), E and H


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not _common.need_cuda("kernel_lab"):
        return 2
    n = int(argv[0]) if argv else 384
    bxs = [int(x) for x in (argv[1].split(",") if len(argv) > 1
                            else ["4", "8"])]
    steps = 30
    dtypes = [("f32", torch.float32)]
    if os.environ.get("LAB_BF16"):
        dtypes.append(("bf16", torch.bfloat16))
    smi = _common.nvidia_smi()
    dev = torch.device("cuda")
    for dname, dtype in dtypes:
        fields = {c: torch.zeros((n, n, n), dtype=dtype, device=dev)
                  for c in E + H}
        other = {c: torch.empty_like(v) for c, v in fields.items()}
        for variant in ("copy", "noroll", "curl"):
            for bx in bxs:
                if n % bx:
                    continue
                sets = [fields, other]

                def loop():
                    for s in range(steps):
                        lab_step(sets[s % 2], variant, bx,
                                 out=sets[(s + 1) % 2])

                ms = min(_common.cuda_ms(loop, 1) for _ in range(3)) / steps
                rate = n ** 3 / ms / 1e6
                print(f"{dname} {variant:7s} bx={bx}: {ms:6.3f} ms/step  "
                      f"{rate:6.2f} Gcell*steps/s", flush=True)
            if variant == "copy":
                # the copy ceiling: one library call moving the same bytes
                src = [fields[c] for c in E + H]
                dst = [other[c] for c in E + H]

                def lib():
                    for _ in range(steps):
                        torch._foreach_copy_(dst, src)

                ms = min(_common.cuda_ms(lib, 1) for _ in range(3)) / steps
                print(f"{dname} torch._foreach_copy_: {ms:6.3f} ms/step "
                      f"({step_bytes(n, dtype) / ms / 1e6:.0f} GB/s)",
                      flush=True)
        peak = _common.PEAK_BF16 if dtype == torch.bfloat16 else \
            _common.PEAK_F32
        bnd = _common.bound(step_bytes(n, dtype), FLOPS_PER_CELL * n ** 3,
                            peak)
        print(f"{dname} bound: {bnd[0]:.3f} ms/step by {bnd[1]} (12 fields "
              f"once at 3.35 TB/s, 36 flop/cell at {peak / 1e12:.1f} "
              f"TFLOP/s)", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
