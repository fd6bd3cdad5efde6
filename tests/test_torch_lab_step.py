"""The port's kernel lab (``tidy3d_tpu_torch.labs.kernel_lab``) against the
JAX lab ``scripts/kernel_lab.py``.

``make_step`` runs in Pallas interpret mode on the CPU, built and called
inside ``force_tpu_interpret_mode``; ``lab_step`` on CPU tensors is the
plain version. Both get the same seeded numpy fields. Tolerances, relative
to the largest magnitude: 1e-6 in f32 (rounding of the same expression
tree), 1e-2 in bf16 (bf16's epsilon is 7.8e-3; XLA on the CPU may keep
excess precision between the bf16 operations the port rounds).

Without JAX: the stencil kernel's march (chunks with their lead-in and
lead-out planes, tiles wrapped) emulated in torch from the wrapper's plan
equals the plain version bit for bit in f32, and the plain bf16 step
equals a float64 emulation that rounds each operation once. The
kernel-against-plain tests at the end need a CUDA card and skip without
one.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tidy3d_tpu_torch.labs import kernel_lab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16
TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@functools.lru_cache(maxsize=None)
def jax_lab(name: str):
    """The JAX package's lab script ``scripts/<name>.py``, loaded under a
    private module name."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_lab_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def random_fields(seed: int, n: int = N) -> dict:
    rng = np.random.default_rng(seed)
    return {c: rng.standard_normal((n, n, n)).astype(np.float32)
            for c in kernel_lab.E + kernel_lab.H}


def to_torch(fields: dict, dtype, device="cpu") -> dict:
    return {c: torch.from_numpy(v).to(device=device, dtype=dtype)
            for c, v in fields.items()}


def rel_err(ref: dict, got: dict) -> float:
    """Largest difference over all fields, relative to the largest
    magnitude; both as float64 numpy."""
    assert set(ref) == set(got)
    scale = max(float(np.abs(v).max()) for v in ref.values())
    return max(float(np.abs(got[c] - ref[c]).max()) for c in ref) / scale


def as_np(fields: dict) -> dict:
    return {c: v.double().cpu().numpy() for c, v in fields.items()}


def jax_step(fields_np: dict, variant: str, bx: int, dtype) -> dict:
    lab = jax_lab("kernel_lab")
    with pltpu.force_tpu_interpret_mode():
        step = lab.make_step(N, bx, variant, JNP[dtype])
        out = step({c: jnp.asarray(v, dtype=JNP[dtype])
                    for c, v in fields_np.items()})
        return {c: np.asarray(v.astype(jnp.float32), dtype=np.float64)
                for c, v in out.items()}


@pytest.mark.parametrize("bx", [4, 8])
@pytest.mark.parametrize("variant", kernel_lab.VARIANTS)
def test_step_matches_the_jax_lab(variant, bx):
    f = random_fields(1)
    ref = jax_step(f, variant, bx, torch.float32)
    got = as_np(kernel_lab.lab_step(to_torch(f, torch.float32), variant, bx))
    err = rel_err(ref, got)
    assert err <= TOL[torch.float32], f"{variant} bx={bx}: {err:.2e}"


@pytest.mark.parametrize("bx", [4, 8])
def test_bf16_curl_matches_the_jax_lab(bx):
    f = random_fields(2)
    ref = jax_step(f, "curl", bx, torch.bfloat16)
    got = kernel_lab.lab_step(to_torch(f, torch.bfloat16), "curl", bx)
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    err = rel_err(ref, as_np(got))
    assert err <= TOL[torch.bfloat16], f"bf16 curl bx={bx}: {err:.2e}"


def march_emulated(fields: dict, variant: str, bx: int) -> dict:
    """The stencil kernel's march in torch on the CPU, from the plan the
    wrapper computes: every chunk of ``kernel_lab.chunk_planes`` over every
    tile at once (the staged rows and columns of ``tile_rows`` and
    ``tile_cols``, wrapped). A chunk's lead-in gives the carried H of the x
    difference; at each of its planes E' is computed on the tile plus one
    row and column above, then H' of the plane before on the own cells from
    the E' of both planes; only the own cells (y, z < n) are written."""
    ca, cb, keep = kernel_lab.constants(fields["Ex"].dtype)
    n = fields["Ex"].shape[0]
    ty, tz = kernel_lab.TY, kernel_lab.TZ
    rows = torch.tensor([kernel_lab.tile_rows(n, y0)
                         for y0 in range(0, n, ty)])[:, :, None, None]
    cols = torch.tensor([kernel_lab.tile_cols(n, z0)
                         for z0 in range(0, n, tz)])[None, None]
    oy = (torch.arange(0, n, ty)[:, None] + torch.arange(ty)).flatten()
    oz = (torch.arange(0, n, tz)[:, None] + torch.arange(tz)).flatten()
    keep_y, keep_z = oy < n, oz < n
    out = {c: torch.full_like(fields[c], float("nan"))
           for c in kernel_lab.E + kernel_lab.H}

    def staged(plane):   # (y tiles, TY + 2, z tiles, TZ + 4) per field
        return [fields[c][plane][rows, cols]
                for c in kernel_lab.E + kernel_lab.H]

    def bd(f, lower):
        return f - f * keep if variant == "noroll" else f - lower

    def fd(f, upper):
        return f * keep - f if variant == "noroll" else upper - f

    def curl_e(s, hp):
        # E' on rows 1 .. TY + 1 and columns 2 .. TZ + 3 of the staged tile
        ex, ey, ez, hx, hy, hz = (f[:, 1:, :, 2:] for f in s)
        dzy = bd(hz, s[5][:, :-1, :, 2:])
        dyz = bd(hy, s[4][:, 1:, :, 1:-1])
        dxz = bd(hx, s[3][:, 1:, :, 1:-1])
        dxy = bd(hx, s[3][:, :-1, :, 2:])
        return ([ca * ex + cb * (dzy - dyz),
                 ca * ey + cb * (dxz - (hz - hp[1])),
                 ca * ez + cb * ((hy - hp[0]) - dxy)], [hx, hy, hz])

    def own(f):          # the own cells of an E' or H tile, as (n, n)
        f = f[:, :ty, :, :tz].reshape(len(oy), len(oz))
        return f[keep_y][:, keep_z]

    # H' reads its E' tiles' own cells and their y + 1 and z + 1 shifts
    all_ = slice(None)
    own_ = (all_, slice(0, ty), all_, slice(0, tz))
    yp = (all_, slice(1, ty + 1), all_, slice(0, tz))
    zp = (all_, slice(0, ty), all_, slice(1, tz + 1))
    for planes in kernel_lab.chunk_planes(n, bx):
        s = staged(planes[0])
        hp = [s[4][:, 1:, :, 2:], s[5][:, 1:, :, 2:]]
        for pos, x in enumerate(planes[1:], start=1):
            e, h = curl_e(staged(x), hp)
            if pos < len(planes) - 1:
                for c, v in zip(kernel_lab.E, e):
                    out[c][x] = own(v)
            if pos > 1:
                o0, o1, o2 = (v[own_] for v in eo)
                hn = [ca * ho[0][own_] - cb * (fd(o2, eo[2][yp]) -
                                               fd(o1, eo[1][zp])),
                      ca * ho[1][own_] - cb * (fd(o0, eo[0][zp]) -
                                               (e[2][own_] - o2)),
                      ca * ho[2][own_] - cb * ((e[1][own_] - o1) -
                                               fd(o0, eo[0][yp]))]
                for c, v in zip(kernel_lab.H, hn):
                    out[c][planes[pos - 1]] = own(v)
            eo, ho, hp = e, h, h[1:]
    return out


@pytest.mark.parametrize("n,bx", [(15, 1), (15, 5), (16, 1), (16, 4),
                                  (16, 8), (40, 1), (40, 4), (40, 5),
                                  (40, 8)])
@pytest.mark.parametrize("variant", ["curl", "noroll"])
def test_march_plan_equals_plain_bit_for_bit(variant, n, bx):
    """The stencil march's decomposition (chunks with their lead-in and
    lead-out planes, tiles wrapped where 32 or 16 does not divide n) gives
    the plain version's f32 result bit for bit."""
    f = to_torch(random_fields(9, n), torch.float32)
    got = march_emulated(f, variant, bx)
    ref = kernel_lab.lab_step_reference(f, variant)
    for c in kernel_lab.E + kernel_lab.H:
        assert torch.equal(got[c], ref[c]), (c, float(
            (got[c] - ref[c]).abs().nan_to_num(float("inf")).max()))


def test_chunk_planes():
    assert kernel_lab.chunk_planes(8, 4) == [[0, 0, 1, 2, 3, 4],
                                             [3, 4, 5, 6, 7, 7]]
    assert kernel_lab.chunk_planes(3, 1) == [[0, 0, 1], [0, 1, 2],
                                             [1, 2, 2]]
    with pytest.raises(ValueError, match="bx = 3"):
        kernel_lab.chunk_planes(8, 3)
    assert kernel_lab.tile_rows(15, 0)[:2] == [14, 0]
    assert kernel_lab.tile_cols(16, 0)[-3:] == [15, 0, 1]


def round_bf16(x: np.ndarray) -> np.ndarray:
    """float64 values rounded once to bf16 (8 significant bits, nearest
    even)."""
    m, e = np.frexp(x)
    return np.ldexp(np.rint(m * 256.0), e - 8)


def step_bf16_emulated(fields: dict, variant: str) -> dict:
    """``lab_step_reference`` in float64 with each multiply, add and
    subtract rounded once to bf16 (the native bf16x2 kernel's arithmetic),
    at the lab's bf16 constants."""
    ca, cb, keep = kernel_lab.constants(torch.bfloat16)
    r = round_bf16
    Ex, Ey, Ez, Hx, Hy, Hz = (fields[c].double().numpy()
                              for c in kernel_lab.E + kernel_lab.H)

    def bd(f, ax):
        if variant == "noroll":
            return r(f - r(f * keep))
        return r(f - np.roll(f, 1, ax))

    def fd(f, ax):
        if variant == "noroll":
            return r(r(f * keep) - f)
        return r(np.roll(f, -1, ax) - f)

    def bdx(f):
        return r(f - np.concatenate([f[:1], f[:-1]]))

    def upd(f, d, sign):
        return r(r(ca * f) + sign * r(cb * d))

    nEx = upd(Ex, r(bd(Hz, 1) - bd(Hy, 2)), 1)
    nEy = upd(Ey, r(bd(Hx, 2) - bdx(Hz)), 1)
    nEz = upd(Ez, r(bdx(Hy) - bd(Hx, 1)), 1)
    top = slice(-1, None)
    vEy = upd(Ey[top], bd(Hx[top], 2), 1)
    vEz = upd(Ez[top], r(0.0 - bd(Hx[top], 1)), 1)
    nHx = upd(Hx, r(fd(nEz, 1) - fd(nEy, 2)), -1)
    nHy = upd(Hy, r(fd(nEx, 2) - r(np.concatenate([nEz[1:], vEz]) - nEz)),
              -1)
    nHz = upd(Hz, r(r(np.concatenate([nEy[1:], vEy]) - nEy) - fd(nEx, 1)),
              -1)
    return dict(zip(kernel_lab.E + kernel_lab.H,
                    (nEx, nEy, nEz, nHx, nHy, nHz)))


@pytest.mark.parametrize("variant", ["curl", "noroll"])
def test_bf16_reference_rounds_each_operation_once(variant):
    """The plain bf16 step against a float64 emulation that rounds each
    exact operation once to bf16: bit for bit (PyTorch rounds each bf16
    operation's float result to bf16, and float's 24 bits are at least
    2 x 8 + 2, so the double rounding of a product, sum or difference of
    two bf16 values is the single rounding)."""
    f = to_torch(random_fields(10, 12), torch.bfloat16)
    got = as_np(kernel_lab.lab_step_reference(f, variant))
    want = step_bf16_emulated(f, variant)
    for c in kernel_lab.E + kernel_lab.H:
        assert np.array_equal(got[c], want[c]), (c, int(
            np.count_nonzero(got[c] != want[c])))


def test_cpu_dispatch_counts_no_launch():
    before = dict(kernel_lab.LAUNCHES)
    kernel_lab.lab_step(to_torch(random_fields(4), torch.float32), "copy")
    assert kernel_lab.LAUNCHES == before


def test_step_bound_at_384():
    """12 f32 fields of 384^3 once: 2.72 GB, 0.811 ms at 3.35 TB/s."""
    from tidy3d_tpu_torch.labs import _common

    ms, by = _common.bound(kernel_lab.step_bytes(384, torch.float32),
                           kernel_lab.FLOPS_PER_CELL * 384 ** 3)
    assert by == "bytes" and abs(ms - 0.811) < 1e-3


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_lab.main(["16"]) == 2


# --------------------------------------------------------------------------- #
# kernel against plain version, on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bx", [4, 8])
@pytest.mark.parametrize("variant", kernel_lab.VARIANTS)
def test_kernel_matches_plain(variant, bx, dtype, cuda):
    f = to_torch(random_fields(5), dtype, cuda)
    key = kernel_lab.launch_key(variant, dtype)
    before = kernel_lab.LAUNCHES.get(key, 0)
    got = kernel_lab.lab_step(f, variant, bx)
    torch.cuda.synchronize()
    assert kernel_lab.LAUNCHES[key] == before + 1
    ref = kernel_lab.lab_step_reference(f, variant)
    err = rel_err(as_np(ref), as_np(got))
    assert err <= TOL[dtype], f"{variant} bx={bx} {dtype}: {err:.2e}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,bx", [(16, 8), (15, 5)])
def test_copy_is_bit_identical(n, bx, dtype, cuda):
    """The copy variant's 16-byte vectors and its scalar tail: 15^3 values
    leave 7 (bf16) or 3 (f32) past the last whole vector of each field."""
    f = to_torch(random_fields(6, n), dtype, cuda)
    got = kernel_lab.lab_step(f, "copy", bx)
    torch.cuda.synchronize()
    ref = kernel_lab.lab_step_reference(f, "copy")
    for c in kernel_lab.E + kernel_lab.H:
        assert torch.equal(got[c].view(torch.int16 if dtype == torch.bfloat16
                                       else torch.int32),
                           ref[c].view(torch.int16 if dtype == torch.bfloat16
                                       else torch.int32)), c


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,bx", [(15, 1), (15, 5), (40, 1), (40, 5),
                                  (40, 8)])
@pytest.mark.parametrize("variant", ["curl", "noroll"])
def test_stencil_march_odd_and_ragged_n(variant, n, bx, dtype, cuda):
    """n = 15 stages and stores cell by cell (no whole z pair); at n = 40
    neither 32 nor 16 divides n and the last tiles wrap."""
    f = to_torch(random_fields(12, n), dtype, cuda)
    got = kernel_lab.lab_step(f, variant, bx)
    torch.cuda.synchronize()
    ref = kernel_lab.lab_step_reference(f, variant)
    err = rel_err(as_np(ref), as_np(got))
    assert err <= TOL[dtype], f"{variant} n={n} bx={bx} {dtype}: {err:.2e}"
