"""Pole lab: the f32 FMA ceiling and two formulations of the ADE pole update
on one on-chip window. The counterpart of ``scripts/pole_lab.py``.

Every variant repeats its update ``reps`` times (600) on a window of
``(Wx, Wy, Z)`` = (24, 64, 128) cells that stays on the chip, ``grid`` (16)
times over, so the time isolates arithmetic and scheduling, not device
memory:
  vpu_peak       8 independent chains of 8 FMAs a repeat; out: their sum
  fma_peak       2 chains of 16 FMAs a repeat; out: their sum
  pole_chan      the ADE update of 4 real + 3 complex poles (30 Q channels)
                 per channel, unrolled, with the 6 x 7 coefficients as
                 kernel parameters (the TPU's immediates); out: e0 + e1 +
                 e2 + q0. f32, and ``pole_chan_bf16`` (bf16 storage and
                 arithmetic, every operation rounded to bf16)
  pole_packed    the same maths channel-packed: per-channel coefficient
                 vectors read from memory, a loop over the 10 three-channel
                 slots, the qr/qi swap by index
  curl_mix       6 carried fields, a curl-like mix of periodic y and z
                 differences and FMAs (the kernel keeps the fields in
                 registers, ``curl_mix_plan``); out: field 0 + field 3. The
                 mix is not a stable curl: a window that varies in y or z grows
                 about 1.8x a repeat and overflows float32 within 400
                 repeats, so ``main`` times it, as the JAX lab does, on a
                 window full of 0.01 (``CURL_MIX_WINDOW``)

Each function runs its CUDA kernel (``csrc/lab_pole.cu``) for CUDA tensors
and its plain version for CPU tensors. The kernel writes every repeat into
its own slice of a ``(grid, Wx, Wy, Z)`` output, so no repeat is dead work;
the function returns slice 0, or all of them with ``copies=True``.

    python3 -m tidy3d_tpu_torch.labs.pole_lab [variants...]

prints ms per call and TFLOP/s under the lab's flop model, the registers
ptxas gave each kernel, and the card's name and power limit. Needs a CUDA
device.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from . import _common
from ..solver.kernels.step import launch

Wx, Wy, Z = 24, 64, 128
NR, NC = 4, 3                   # real poles, complex poles (Au RBB-like)
C = NR * 3 + NC * 6             # packed channels (30)
R = 600                         # repetitions inside the kernel
GRID = 16                       # repeats of the same window
NSLOT = NR + 2 * NC             # 3-channel blocks of the packed layout
CA, CB = 0.999, 0.37
CURL_MIX_WINDOW = 0.01          # the JAX lab's curl_mix input value
CM_ROWS, CM_CELLS = 4, 4        # curl_mix's kernel: rows x cells a thread
CM_MAX_WARPS = 16               # of a curl_mix block (wy <= 64)

VARIANTS = ("vpu_peak", "fma_peak", "pole_chan", "pole_chan_bf16",
            "pole_packed", "curl_mix")
LAUNCHES: dict = {}             # kernel launches by variant


def _pole_consts():
    rng = np.random.default_rng(0)
    Ar = rng.uniform(0.9, 0.99, NR + NC)
    Ai = np.concatenate([np.zeros(NR), rng.uniform(0.01, 0.1, NC)])
    B0r = rng.uniform(-0.01, 0.01, NR + NC)
    B0i = np.concatenate([np.zeros(NR), rng.uniform(-0.01, 0.01, NC)])
    Gr = rng.uniform(-0.01, 0.01, NR + NC)
    Gi = np.concatenate([np.zeros(NR), rng.uniform(-0.01, 0.01, NC)])
    return Ar, Ai, B0r, B0i, Gr, Gi


def flops(variant: str, wx: int = Wx, wy: int = Wy, z: int = Z,
          reps: int = R, grid: int = GRID) -> int:
    """The lab's own flop model (an FMA counts 2) times reps and grid."""
    cells = wx * wy * z
    per = {
        "vpu_peak": 2 * 64,
        "fma_peak": 2 * 32,
        "curl_mix": 54,
        # coupling sums + E update, esum + mes, Q recursion
        "pole": 3 * (2 * (NR + NC) + 2 * NC + 2) + 3 * (2 + 1)
        + 3 * (NR * 4 + NC * 10),
    }[variant if not variant.startswith("pole") else "pole"]
    return per * cells * reps * grid


def ops(variant: str, wx: int = Wx, wy: int = Wy, z: int = Z,
        reps: int = R, grid: int = GRID) -> int:
    """The operations the function itself needs (an FMA counts 2), times
    reps and grid, plus the output's final sum: what a bound counts. Per
    cell and repeat: the chains' FMAs; ``curl_mix`` 8 a component (two
    differences and their halving, ``CA * f + CB * (d1 - d2)``); the pole
    update 198 (a component: the coupling sum 2 NR + 4 NC - 1, the E update
    3, ``mask * (E' + E)`` 2, the recursions 3 a real and 10 a complex
    pole). ``flops`` charges esum and mes 3, a real recursion 4 and
    ``curl_mix`` 54."""
    cells = wx * wy * z
    pole = 3 * ((2 * NR + 4 * NC - 1) + 3 + 2 + (3 * NR + 10 * NC))
    per, final = {"vpu_peak": (128, 7), "fma_peak": (64, 1),
                  "curl_mix": (48, 1), "pole": (pole, 3)}[
        "pole" if variant.startswith("pole") else variant]
    return (per * reps + final) * cells * grid


def peak(variant: str) -> float:
    """The card's peak FLOP/s for the variant's arithmetic: bf16 for
    ``pole_chan_bf16``, float32 for the others."""
    return _common.PEAK_BF16 if variant.endswith("bf16") else \
        _common.PEAK_F32


def chain_steps(variant: str, reps: int = R) -> int:
    """Multiply-adds one carry of an FMA-chain variant goes through (0 for
    the other variants)."""
    return {"vpu_peak": 8, "fma_peak": 16}.get(variant, 0) * reps


# Kernel against plain version at the lab's R = 600 (relative), about 4x
# the error the card gave on chip_smoke's seeded inputs (H100 80GB HBM3,
# 700 W): vpu_peak 7.4e-5, fma_peak 1.3e-4, pole_chan 2.8e-7, pole_packed
# 1.9e-6, curl_mix 0 on the constant window
LIMITS_AT_R = {"vpu_peak": 3e-4, "fma_peak": 5e-4, "pole_chan": 1e-5,
               "pole_packed": 1e-5, "curl_mix": 1e-5}


def kernel_tolerance(variant: str, reps: int = R) -> float:
    """Kernel against plain version, relative to the largest magnitude.
    The kernel contracts ``a * b + c`` into one FMA where the plain version
    rounds product and sum apart: up to 1.5 ulp of a carry a step. On an
    FMA chain (carry times ~1) that drift is undamped over every step; the
    pole and curl carries are damped (0.999 a repeat), so about one such
    step a repeat adds up. That worst case is held to ``LIMITS_AT_R``,
    scaled by ``reps / R`` above R. bf16: both round every operation, so
    1e-2 (bf16's epsilon is 7.8e-3)."""
    if variant.endswith("bf16"):
        return 1e-2
    steps = chain_steps(variant, reps) or reps
    worst = max(1e-6, 1.5 * steps * 2.0 ** -23)
    return min(worst, LIMITS_AT_R[variant] * max(1.0, reps / R))


def chan_to_packed() -> list:
    """For each channel of the packed layout (real qr | complex qr |
    complex qi), the channel of the per-channel layout that holds it."""
    idx = list(range(NR * 3))
    for part in (0, 3):
        for p in range(NC):
            idx += [NR * 3 + 6 * p + part + ci for ci in range(3)]
    return idx


def packed_coeffs() -> np.ndarray:
    """``(4, C, 1, 1)`` float32 coefficient vectors ``ARV, AIV, B0V, GRV``
    of the packed layout."""
    Ar, Ai, B0r, B0i, Gr, Gi = _pole_consts()
    arv = np.concatenate([np.repeat(Ar[:NR], 3), np.repeat(Ar[NR:], 3),
                          np.repeat(Ar[NR:], 3)])
    aiv = np.concatenate([np.zeros(NR * 3), -np.repeat(Ai[NR:], 3),
                          np.repeat(Ai[NR:], 3)])
    b0v = np.concatenate([np.repeat(B0r[:NR], 3), np.repeat(B0r[NR:], 3),
                          np.repeat(B0i[NR:], 3)])
    grv = np.concatenate([np.repeat(Gr[:NR], 3), np.repeat(Gr[NR:], 3),
                          -np.repeat(Gi[NR:], 3)])
    return np.stack([arv, aiv, b0v, grv]).astype(np.float32) \
        .reshape(4, C, 1, 1)


def make_inputs(variant: str, wx: int = Wx, wy: int = Wy, z: int = Z,
                seed: int = 0, device="cpu", constant: float = None) -> tuple:
    """Seeded random inputs of ``variant`` (numpy, then moved): a window
    ``x`` for the FMA and curl variants (full of ``constant`` where given);
    fields ``e``, a 0/1 ``mask`` and currents ``q`` for the pole variants
    (``q`` in the packed layout for ``pole_packed``, the same values as
    ``pole_chan``'s from one seed), and ``cv`` for ``pole_packed``."""
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    if not variant.startswith("pole"):
        if constant is not None:
            return (t(np.full((wx, wy, z), constant, np.float32)),)
        return (t(rng.uniform(-1e-3, 1e-3, (wx, wy, z)).astype(np.float32)),)
    e = rng.standard_normal((wx, 3, wy, z)).astype(np.float32)
    m = (rng.uniform(size=(wx, wy, z)) < 0.7).astype(np.float32)
    q = rng.standard_normal((wx, C, wy, z)).astype(np.float32)
    dtype = torch.bfloat16 if variant == "pole_chan_bf16" else torch.float32
    if variant == "pole_packed":
        return t(e), t(m), t(q[:, chan_to_packed()]), t(packed_coeffs())
    return t(e, dtype), t(m, dtype), t(q, dtype)


def chan_constants(dtype) -> dict:
    """The per-channel variant's coefficients as its arithmetic sees them:
    python floats, rounded to bf16 for bf16 (weak-typed scalars)."""
    def rnd(v):
        return float(torch.tensor(float(v), dtype=dtype).item())

    names = ("ar", "ai", "b0r", "b0i", "gr", "gi")
    out = {k: [rnd(v) for v in a] for k, a in zip(names, _pole_consts())}
    out["ca"], out["cb"] = rnd(CA), rnd(CB)
    return out


# --------------------------------------------------------------------------- #
# the plain PyTorch versions: (grid, Wx, Wy, Z) out
# --------------------------------------------------------------------------- #


def _rep(t, grid):
    return t.unsqueeze(0).expand(grid, *t.shape)


def vpu_peak_reference(x, reps: int = R, grid: int = GRID):
    v = _rep(x, grid)
    accs = [torch.full(v.shape, 0.1 * i, dtype=torch.float32,
                       device=x.device) for i in range(8)]
    for _ in range(reps):
        for i in range(8):
            for _ in range(8):
                accs[i] = accs[i] * 1.000001 + v
    return sum(accs)


def fma_peak_reference(x, reps: int = R, grid: int = GRID):
    v = _rep(x, grid)
    a = torch.zeros(v.shape, dtype=torch.float32, device=x.device)
    b = torch.ones(v.shape, dtype=torch.float32, device=x.device)
    for _ in range(reps):
        for _ in range(16):
            a = a * 1.0000001 + v
            b = b * 0.9999999 + v
    return a + b


def pole_chan_reference(e, m, q, reps: int = R, grid: int = GRID):
    k = chan_constants(e.dtype)
    Ar, Ai, B0r, B0i, Gr, Gi = (k[n] for n in ("ar", "ai", "b0r", "b0i",
                                               "gr", "gi"))
    ca, cb = k["ca"], k["cb"]
    mask = _rep(m, grid)
    es = [_rep(e[:, ci], grid) for ci in range(3)]
    qs = [_rep(q[:, ch], grid) for ch in range(C)]
    for _ in range(reps):
        new_es = []
        for ci in range(3):
            pt = None
            for p in range(NR + NC):
                ch0 = p * 3 if p < NR else NR * 3 + (p - NR) * 6
                t = Gr[p] * qs[ch0 + ci]
                if p >= NR:
                    t = t - Gi[p] * qs[ch0 + 3 + ci]
                pt = t if pt is None else pt + t
            new_es.append(ca * es[ci] + cb * pt)
        for ci in range(3):
            mes = mask * (new_es[ci] + es[ci])
            for p in range(NR + NC):
                ch0 = p * 3 if p < NR else NR * 3 + (p - NR) * 6
                qr = qs[ch0 + ci]
                nqr = Ar[p] * qr
                if p >= NR:
                    qi = qs[ch0 + 3 + ci]
                    nqr = nqr - Ai[p] * qi
                    qs[ch0 + 3 + ci] = Ai[p] * qr + Ar[p] * qi + B0i[p] * mes
                qs[ch0 + ci] = nqr + B0r[p] * mes
        es = new_es
    return es[0] + es[1] + es[2] + qs[0]


def pole_packed_reference(e, m, q, cv, reps: int = R, grid: int = GRID):
    ARV, AIV, B0V, GRV = cv[0], cv[1], cv[2], cv[3]     # (C, 1, 1)
    nqr = NR * 3 + NC * 3
    mask = _rep(m, grid)
    es, Q = _rep(e, grid), _rep(q, grid)                # (grid, Wx, ., Wy, Z)
    for _ in range(reps):
        W = GRV * Q
        S = W[:, :, 0:3]
        for p in range(1, NSLOT):
            S = S + W[:, :, 3 * p:3 * p + 3]
        newE = CA * es + CB * S
        mes = mask[:, :, None] * (newE + es)
        drv = torch.cat([mes] * NSLOT, dim=2)
        qswap = torch.cat([torch.zeros_like(Q[:, :, :NR * 3]),
                           Q[:, :, nqr:], Q[:, :, NR * 3:nqr]], dim=2)
        Q = ARV * Q + AIV * qswap + B0V * drv
        es = newE
    return es[:, :, 0] + es[:, :, 1] + es[:, :, 2] + Q[:, :, 0]


def curl_mix_reference(x, reps: int = R, grid: int = GRID):
    xb = _rep(x, grid)
    fs = [xb * (0.1 * i + 0.1) for i in range(6)]
    e, h = fs[:3], fs[3:]
    for _ in range(reps):
        for ci in range(3):
            hj, hk = h[(ci + 1) % 3], h[(ci + 2) % 3]
            d1 = (hj - torch.roll(hj, 1, 2)) * 0.5
            d2 = (hk - torch.roll(hk, 1, 3)) * 0.5
            e[ci] = CA * e[ci] + CB * (d1 - d2)
        for ci in range(3):
            ej, ek = e[(ci + 1) % 3], e[(ci + 2) % 3]
            d1 = (torch.roll(ej, -1, 2) - ej) * 0.5
            d2 = (torch.roll(ek, -1, 3) - ek) * 0.5
            h[ci] = CA * h[ci] - CB * (d1 - d2)
    return e[0] + h[0]


REFERENCES = {
    "vpu_peak": vpu_peak_reference, "fma_peak": fma_peak_reference,
    "pole_chan": pole_chan_reference, "pole_chan_bf16": pole_chan_reference,
    "pole_packed": pole_packed_reference, "curl_mix": curl_mix_reference,
}


# --------------------------------------------------------------------------- #
# the CUDA kernels (csrc/lab_pole.cu) through ctypes
# --------------------------------------------------------------------------- #

_P8 = ctypes.c_float * 8
_U8 = ctypes.c_uint32 * 8


def bf16x2_bits(v: float) -> int:
    """The bf16x2 bit pattern that holds the bf16 of ``v`` in both halves."""
    b = int(torch.tensor(v, dtype=torch.bfloat16).view(torch.int16)) & 0xFFFF
    return b | b << 16


class LabPoleParams(ctypes.Structure):
    """Mirror of ``struct LabPoleParams`` in ``csrc/lab_pole.cu``."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("e", ctypes.c_void_p),
        ("m", ctypes.c_void_p), ("q", ctypes.c_void_p),
        ("cv", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("wx", ctypes.c_int64), ("wy", ctypes.c_int64), ("z", ctypes.c_int64),
        ("reps", ctypes.c_int32), ("grid", ctypes.c_int32),
        ("variant", ctypes.c_int32), ("bf16", ctypes.c_int32),
        ("ca", ctypes.c_float), ("cb", ctypes.c_float),
        ("ar", _P8), ("ai", _P8), ("b0r", _P8), ("b0i", _P8),
        ("gr", _P8), ("gi", _P8),
        ("ca2", ctypes.c_uint32), ("cb2", ctypes.c_uint32),
        ("ar2", _U8), ("ai2", _U8), ("b0r2", _U8), ("b0i2", _U8),
        ("gr2", _U8), ("gi2", _U8),
    ]


# the kernel's variant numbers (pole_chan_bf16 is pole_chan on bf16)
_KERNEL = {"vpu_peak": 0, "fma_peak": 1, "pole_chan": 2, "pole_chan_bf16": 2,
           "pole_packed": 3, "curl_mix": 4}


def _library():
    return _common.library("lab_pole", "t3d_lab_pole", LabPoleParams,
                           "t3d_lab_pole_params_size")


def curl_mix_plan(wy: int, z: int) -> dict:
    """How ``csrc/lab_pole.cu``'s ``curl_mix`` splits a ``(wy, z)`` window
    plane: one block of ``warps`` warps, a thread ``rows`` y rows x
    ``cells`` z cells, a warp all z. Raises ``ValueError`` for a window the
    kernel does not take."""
    if z != 32 * CM_CELLS or wy % CM_ROWS or not \
            CM_ROWS <= wy <= CM_ROWS * CM_MAX_WARPS:
        raise ValueError(
            f"curl_mix: the kernel takes z = {32 * CM_CELLS} and wy a "
            f"multiple of {CM_ROWS} up to {CM_ROWS * CM_MAX_WARPS}, not "
            f"(wy, z) = ({wy}, {z})")
    return dict(warps=wy // CM_ROWS, rows=CM_ROWS, cells=CM_CELLS)


def curl_mix_resources(wy: int = Wy, z: int = Z) -> dict:
    """``curl_mix``'s threads, shared bytes, blocks per SM and registers at
    window ``(wy, z)``, as the library reports them."""
    curl_mix_plan(wy, z)
    fn = _common.library("lab_pole", "t3d_lab_pole_curl_mix_info",
                         LabPoleParams, "t3d_lab_pole_params_size")
    p = LabPoleParams(wx=Wx, wy=wy, z=z, grid=GRID)
    out = (ctypes.c_int * 4)()
    err = fn(ctypes.byref(p), out)
    if err:
        raise RuntimeError(f"curl_mix: resources not reported (CUDA error "
                           f"{err})")
    res = dict(zip(("threads", "smem", "blocks_per_sm", "registers"), out))
    if res["threads"] != 32 * curl_mix_plan(wy, z)["warps"]:
        raise RuntimeError(f"curl_mix: the library's {res['threads']} "
                           f"threads do not match curl_mix_plan")
    return res


def _run_cuda(variant, inputs, reps, grid):
    f32, bf16 = (torch.float32,), (torch.bfloat16,)
    p = LabPoleParams()
    if variant.startswith("pole"):
        e = inputs[0]
        wx, _, wy, z = e.shape
        dt = bf16 if variant == "pole_chan_bf16" else f32
        p.e = _common.check_cuda(e, (wx, 3, wy, z), dt, "e").data_ptr()
        p.m = _common.check_cuda(inputs[1], (wx, wy, z), dt,
                                 "mask").data_ptr()
        p.q = _common.check_cuda(inputs[2], (wx, C, wy, z), dt,
                                 "q").data_ptr()
        if variant == "pole_packed":
            p.cv = _common.check_cuda(inputs[3], (4, C, 1, 1), f32,
                                      "cv").data_ptr()
        out_dtype = dt[0]
    else:
        x = inputs[0]
        wx, wy, z = x.shape
        if variant == "curl_mix":
            curl_mix_plan(wy, z)
        p.x = _common.check_cuda(x, (wx, wy, z), f32, "x").data_ptr()
        out_dtype = torch.float32
    device = inputs[0].device
    out = torch.empty((grid, wx, wy, z), dtype=out_dtype, device=device)
    p.out = out.data_ptr()
    p.wx, p.wy, p.z = wx, wy, z
    p.reps, p.grid = reps, grid
    p.variant = _KERNEL[variant]
    p.bf16 = int(variant == "pole_chan_bf16")
    k = chan_constants(out_dtype)
    p.ca, p.cb = k["ca"], k["cb"]
    for name in ("ar", "ai", "b0r", "b0i", "gr", "gi"):
        arr, arr2 = getattr(p, name), getattr(p, name + "2")
        for i, v in enumerate(k[name]):
            arr[i], arr2[i] = v, bf16x2_bits(v)
    p.ca2, p.cb2 = bf16x2_bits(k["ca"]), bf16x2_bits(k["cb"])
    launch(_library(), p, device, variant)
    LAUNCHES[variant] = LAUNCHES.get(variant, 0) + 1
    return out


def run(variant: str, inputs: tuple, reps: int = R, grid: int = GRID,
        copies: bool = False):
    """``variant`` on ``inputs`` (as ``make_inputs`` gives them): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. Returns the
    ``(Wx, Wy, Z)`` result, or with ``copies`` the ``(grid, Wx, Wy, Z)``
    tensor of every repeat."""
    if variant not in VARIANTS:
        raise ValueError(f"pole_lab: unknown variant '{variant}'")
    if reps < 0 or grid < 1:
        raise ValueError(f"pole_lab: reps = {reps}, grid = {grid}")
    device = inputs[0].device
    if device.type == "cpu":
        out = REFERENCES[variant](*inputs, reps=reps, grid=grid)
    elif device.type == "cuda":
        out = _run_cuda(variant, inputs, reps, grid)
    else:
        raise ValueError(f"pole_lab: unsupported device '{device}'")
    return out if copies else out[0]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not _common.need_cuda("pole_lab"):
        return 2
    variants = argv or ["vpu_peak", "pole_packed", "pole_chan"]
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        print(f"pole_lab: unknown variants {unknown}; known: {VARIANTS}",
              file=sys.stderr)
        return 2
    smi = _common.nvidia_smi()
    dev = torch.device("cuda")
    for v in variants:
        inputs = make_inputs(v, device=dev, constant=CURL_MIX_WINDOW
                             if v == "curl_mix" else None)
        out = {}

        def call():
            out["o"] = run(v, inputs)

        ms = _common.cuda_ms(call, 3)
        chk = float(out["o"].float().sum())
        tf = flops(v) / (ms * 1e-3) / 1e12
        print(f"{v:14s}: {ms:8.3f} ms/call  {tf:6.2f} Tflop/s "
              f"(chk {chk:.3e})", flush=True)
    for name in sorted({v.replace("_bf16", "") for v in variants}):
        print(f"ptxas {name}: {_common.registers_of('lab_pole', name)}",
              flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
