"""Temporal-blocking lab: k vacuum leapfrog steps per launch. The
counterpart of ``scripts/kernel_lab2.py`` (``make_kstep``, its
``pallas_call`` at :118).

The Pallas kernel steps x-windows of ``W = bx + 2 hw`` planes: ``hw`` (the
smallest width >= k that divides ``bx``) planes below the block, its ``bx``
planes, ``hw`` above. The halo windows are whole blocks of ``hw`` planes,
clamped at the x ends, so the first window repeats planes ``[0, hw)`` below
its block and the last repeats ``[n - hw, n)`` above it. Inside a window
the x differences are zero at its end planes, y and z are periodic, and
only the block's own planes are written. Interior planes come out as k
steps of ``kernel_lab``'s curl; the first and last k planes differ, and the
port computes what the Pallas kernel computes on every plane.

Read as one computation, the windows are slices of a virtual x sequence V
(``virtual_rows``): ``[0, hw) ++ [0, n) ++ [n - hw, n)``, stepped k times
with zero x differences at V's two ends; the output is V's rows
``[hw, hw + n)``. A window's stale zone (k rows at each end) never reaches
the rows it writes, so the CUDA kernel marches along V instead of stepping
windows: ``lab_kstep(fields, k, bx)`` runs ``csrc/lab_kstep.cu`` for CUDA
tensors (x chunks of V per y/z tile, ``chunk_rows`` and ``chunk_count``)
and the plain version ``lab_kstep_reference`` for CPU tensors.
Storage f32 or bf16, arithmetic in f32, one rounding at the store.

    python3 -m tidy3d_tpu_torch.labs.kernel_lab2 [n] [k list] [bx list]

prints ms per step and Gcell*steps/s for f32 and bf16 storage, each k and
bx, beside the bound, and the card's name and power limit. Needs a CUDA
device.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import torch

from . import _common
from ..solver.kernels.step import launch
from .kernel_lab import CA, CB, E, FLOPS_PER_CELL, H, step_bytes

KS = (1, 2, 3, 4)       # the k the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES: dict = {}     # kernel launches by ``launch_key``


def launch_key(k: int, dtype) -> str:
    return f"k{k}" + ("_bf16" if dtype == torch.bfloat16 else "")


def halo_width(k: int, bx: int) -> int:
    """The smallest halo width >= k that divides ``bx``."""
    hw = k
    while bx % hw:
        hw += 1
    return hw


def window_rows(n: int, bx: int, k: int) -> torch.Tensor:
    """``(n // bx, bx + 2 hw)`` global x plane of each window row, as the
    Pallas kernel's clamped block index maps pick them."""
    hw = halo_width(k, bx)
    rb, nb = bx // hw, n // hw
    rows = []
    for i in range(n // bx):
        lo = max(i * rb - 1, 0) * hw
        hi = min(i * rb + rb, nb - 1) * hw
        rows.append(list(range(lo, lo + hw))
                    + list(range(i * bx, i * bx + bx))
                    + list(range(hi, hi + hw)))
    return torch.tensor(rows, dtype=torch.long)


def virtual_rows(n: int, bx: int, k: int) -> torch.Tensor:
    """The global x plane of each row of V: ``[0, hw) ++ [0, n) ++
    [n - hw, n)``. Every window of ``window_rows`` is a slice of V."""
    hw = halo_width(k, bx)
    return torch.cat([torch.arange(hw), torch.arange(n),
                      torch.arange(n - hw, n)])


TZ = 32                 # owned z columns of a kernel tile


def chunk_rows(n: int, k: int, hw: int, chunks: int) -> list:
    """``(a, s, e, b)`` per x chunk of the kernel's march: it stores V's
    rows ``[s, e)`` (the output rows ``[hw, hw + n)`` cut into ``chunks``
    near-equal parts) and marches over ``[a, b)``, k lead-in and k lead-out
    rows more where V has them, as ``csrc/lab_kstep.cu`` computes them."""
    length = n + 2 * hw
    out = []
    for c in range(chunks):
        s, e = hw + c * n // chunks, hw + (c + 1) * n // chunks
        out.append((max(s - k, 0), s, e, min(e + k, length)))
    return out


def chunk_count(n: int, k: int, tiles: int, slots: int) -> int:
    """The x chunks per tile that give the least march time: the waves of
    ``tiles * chunks`` blocks over ``slots`` resident blocks, times the
    positions a block marches (its rows plus k lead-in, k lead-out and k
    to drain the levels)."""
    def cost(c):
        return -(-tiles * c // slots) * (-(-n // c) + 3 * k)

    return min(range(1, n + 1), key=lambda c: (cost(c), c))


# --------------------------------------------------------------------------- #
# the plain PyTorch version
# --------------------------------------------------------------------------- #


def lab_kstep_reference(fields: dict, k: int, bx: int) -> dict:
    """k steps on every window at once: the windows are a leading batch
    dimension, x their second."""
    first = fields["Ex"]
    n, dtype = first.shape[0], first.dtype
    if n % bx:
        raise ValueError(f"lab_kstep: bx = {bx} must divide n = {n}")
    hw = halo_width(k, bx)
    idx = window_rows(n, bx, k).to(first.device)
    fE = {c: fields[c].float()[idx] for c in E}
    fH = {c: fields[c].float()[idx] for c in H}

    def bd(f, dim):
        return f - torch.roll(f, 1, dim)

    def fd(f, dim):
        return torch.roll(f, -1, dim) - f

    def bdx(f):
        return f - torch.cat([f[:, :1], f[:, :-1]], dim=1)

    def fdx(f):
        return torch.cat([f[:, 1:], f[:, -1:]], dim=1) - f

    for _ in range(k):
        hx, hy, hz = fH["Hx"], fH["Hy"], fH["Hz"]
        fE = {"Ex": CA * fE["Ex"] + CB * (bd(hz, 2) - bd(hy, 3)),
              "Ey": CA * fE["Ey"] + CB * (bd(hx, 3) - bdx(hz)),
              "Ez": CA * fE["Ez"] + CB * (bdx(hy) - bd(hx, 2))}
        ex, ey, ez = fE["Ex"], fE["Ey"], fE["Ez"]
        fH = {"Hx": CA * hx - CB * (fd(ez, 2) - fd(ey, 3)),
              "Hy": CA * hy - CB * (fd(ex, 3) - fdx(ez)),
              "Hz": CA * hz - CB * (fdx(ey) - fd(ex, 2))}
    out = {**fE, **fH}
    return {c: out[c][:, hw:hw + bx].reshape(n, n, n).to(dtype)
            for c in E + H}


# --------------------------------------------------------------------------- #
# the CUDA kernel (csrc/lab_kstep.cu) through ctypes
# --------------------------------------------------------------------------- #


class LabKStepParams(ctypes.Structure):
    """Mirror of ``struct LabKStepParams`` in ``csrc/lab_kstep.cu``."""

    _fields_ = [
        ("inp", ctypes.c_void_p * 6), ("out", ctypes.c_void_p * 6),
        ("n", ctypes.c_int64),
        ("bx", ctypes.c_int32), ("k", ctypes.c_int32),
        ("hw", ctypes.c_int32), ("bf16", ctypes.c_int32),
        ("ca", ctypes.c_float), ("cb", ctypes.c_float),
        ("chunks", ctypes.c_int32),
    ]


def _library():
    return _common.library("lab_kstep", "t3d_lab_kstep", LabKStepParams,
                           "t3d_lab_kstep_params_size")


_RESOURCES: dict = {}


def resources(k: int, dtype) -> dict:
    """Threads, shared bytes, blocks per SM (the CUDA occupancy calculator),
    registers and owned y rows of a tile (``ty``) of the kernel's
    instantiation for k and ``dtype``, as the library reports them."""
    key = (k, dtype)
    if key not in _RESOURCES:
        fn = _common.library("lab_kstep", "t3d_lab_kstep_info",
                             LabKStepParams, "t3d_lab_kstep_params_size")
        p = LabKStepParams(k=k, bf16=int(dtype == torch.bfloat16))
        out = (ctypes.c_int * 5)()
        err = fn(ctypes.byref(p), out)
        if err:
            raise RuntimeError(f"lab_kstep: no instantiation for k = {k} "
                               f"(CUDA error {err})")
        _RESOURCES[key] = dict(threads=out[0], smem=out[1],
                               blocks_per_sm=out[2], registers=out[3],
                               ty=out[4])
    return _RESOURCES[key]


@functools.lru_cache(maxsize=None)
def chunks_on(n: int, k: int, dtype, device) -> int:
    """The x chunks per tile of a launch at ``n`` on ``device``."""
    res = resources(k, dtype)
    tiles = -(-n // TZ) * -(-n // res["ty"])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return chunk_count(n, k, tiles, sms * max(1, res["blocks_per_sm"]))


def _lab_kstep_cuda(fields, k, bx, out):
    first = fields["Ex"]
    n = first.shape[0]
    shape, dtype = (n, n, n), first.dtype
    if dtype not in DTYPES:
        raise ValueError(f"lab_kstep: unsupported dtype {dtype}")
    if k not in KS:
        raise ValueError(f"lab_kstep: k = {k}; the kernel is built for {KS}")
    if bx < 1 or n % bx:
        raise ValueError(f"lab_kstep: bx = {bx} must divide n = {n}")
    hw = halo_width(k, bx)
    if n % hw:
        raise ValueError(f"lab_kstep: the halo width {hw} must divide n")
    if n % 2:
        raise ValueError(f"lab_kstep: n = {n}; the kernel stages pairs of "
                         f"z cells, so n must be even")
    if out is None:
        out = {c: torch.empty(shape, dtype=dtype, device=first.device)
               for c in E + H}
    p = LabKStepParams()
    for i, c in enumerate(E + H):
        p.inp[i] = _common.check_cuda(fields[c], shape, (dtype,),
                                      c).data_ptr()
        p.out[i] = _common.check_cuda(out[c], shape, (dtype,),
                                      f"out {c}").data_ptr()
    p.n, p.bx, p.k, p.hw = n, bx, k, hw
    p.bf16 = int(dtype == torch.bfloat16)
    p.ca, p.cb = CA, CB
    p.chunks = chunks_on(n, k, dtype, first.device)
    launch(_library(), p, first.device, "lab_kstep")
    key = launch_key(k, dtype)
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    return out


def lab_kstep(fields: dict, k: int = 2, bx: int = 8,
              out: dict = None) -> dict:
    """k steps in one call: the CUDA kernel for CUDA tensors (into ``out``
    where given), the plain version for CPU tensors."""
    device = fields["Ex"].device
    if device.type == "cpu":
        return lab_kstep_reference(fields, k, bx)
    if device.type != "cuda":
        raise ValueError(f"lab_kstep: unsupported device '{device}'")
    return _lab_kstep_cuda(fields, k, bx, out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not _common.need_cuda("kernel_lab2"):
        return 2
    n = int(argv[0]) if argv else 384
    ks = [int(x) for x in (argv[1].split(",") if len(argv) > 1
                           else ["1", "2", "3", "4"])]
    bxs = [int(x) for x in (argv[2].split(",") if len(argv) > 2
                            else ["8"])]
    groups = 10
    smi = _common.nvidia_smi()
    dev = torch.device("cuda")
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        fields = {c: torch.zeros((n, n, n), dtype=dtype, device=dev)
                  for c in E + H}
        other = {c: torch.empty_like(v) for c, v in fields.items()}
        for k in ks:
            for bx in bxs:
                if n % bx:
                    continue
                sets = [fields, other]

                def loop():
                    for g in range(groups):
                        lab_kstep(sets[g % 2], k, bx, out=sets[(g + 1) % 2])

                ms = min(_common.cuda_ms(loop, 1) for _ in range(3)) \
                    / (groups * k)
                bnd = _common.bound(step_bytes(n, dtype) / k,
                                    FLOPS_PER_CELL * n ** 3)
                print(f"{dname} k={k} bx={bx}: {ms:6.3f} ms/step  "
                      f"{n ** 3 / ms / 1e6:6.2f} Gcell*steps/s  (bound "
                      f"{bnd[0]:.3f} ms/step by {bnd[1]})", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
