"""The port's temporal-blocking lab (``tidy3d_tpu_torch.labs.kernel_lab2``)
against the JAX lab ``scripts/kernel_lab2.py``.

``make_kstep`` runs in Pallas interpret mode on the CPU, built and called
inside ``force_tpu_interpret_mode``; ``lab_kstep`` on CPU tensors is the
plain version. Both get the same seeded numpy fields, stored in f32 or
bf16 and stepped in f32. Every plane is compared, the x-edge planes of the
clamped first and last windows included. Tolerances, relative to the
largest magnitude: 1e-6 in f32, 1e-2 in bf16 (one rounding at the store,
bf16's epsilon is 7.8e-3).

Without JAX: the planes ``[k, n-k)`` equal k curl steps of
``kernel_lab.lab_step``. The kernel-against-plain tests at the end need a
CUDA card and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tidy3d_tpu_torch.labs import kernel_lab, kernel_lab2

from tests.test_torch_lab_step import (
    JNP, N, TOL, as_np, jax_lab, random_fields, rel_err, to_torch,
)


def jax_kstep(fields_np: dict, k: int, bx: int, dtype) -> dict:
    lab = jax_lab("kernel_lab2")
    with pltpu.force_tpu_interpret_mode():
        group = lab.make_kstep(N, bx, k, JNP[dtype])
        out = group({c: jnp.asarray(v, dtype=JNP[dtype])
                     for c, v in fields_np.items()})
        return {c: np.asarray(v.astype(jnp.float32), dtype=np.float64)
                for c, v in out.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bx", [4, 8])
@pytest.mark.parametrize("k", kernel_lab2.KS)
def test_kstep_matches_the_jax_lab(k, bx, dtype):
    f = random_fields(10 + k)
    ref = jax_kstep(f, k, bx, dtype)
    got = kernel_lab2.lab_kstep(to_torch(f, dtype), k, bx)
    assert all(v.dtype == dtype for v in got.values())
    err = rel_err(ref, as_np(got))
    assert err <= TOL[dtype], f"k={k} bx={bx} {dtype}: {err:.2e}"


@pytest.mark.parametrize("k", kernel_lab2.KS)
def test_interior_planes_are_k_curl_steps(k):
    f = to_torch(random_fields(20 + k), torch.float32)
    got = kernel_lab2.lab_kstep(f, k, 8)
    ref = f
    for _ in range(k):
        ref = kernel_lab.lab_step(ref, "curl")
    inner = slice(k, N - k)
    err = rel_err(as_np({c: v[inner] for c, v in ref.items()}),
                  as_np({c: v[inner] for c, v in got.items()}))
    assert err <= 1e-6, f"k={k}: {err:.2e}"
    # from k = 2 on, the clamped edge windows (planes [0, hw) below the
    # first block, [n - hw, n) above the last) make planes 0 and n-1 differ
    edge = max(float((got[c][[0, -1]] - ref[c][[0, -1]]).abs().max())
               for c in got)
    assert (edge > 1e-3) == (k > 1), edge


def test_window_rows_clamp_at_the_ends():
    rows = kernel_lab2.window_rows(16, 8, 3).tolist()  # hw = 4
    assert rows[0] == [0, 1, 2, 3] + list(range(8)) + [8, 9, 10, 11]
    assert rows[1] == [4, 5, 6, 7] + list(range(8, 16)) + [12, 13, 14, 15]
    assert kernel_lab2.halo_width(3, 8) == 4
    assert kernel_lab2.halo_width(2, 8) == 2


def steps_on(rows: dict, k: int) -> dict:
    """k steps of the lab's curl on x rows of fields (x first), x
    differences zero at the first and last row, y and z periodic, in f32."""
    f = {c: v.float() for c, v in rows.items()}
    ca, cb = kernel_lab.CA, kernel_lab.CB

    def bd(v, dim):
        return v - torch.roll(v, 1, dim)

    def fd(v, dim):
        return torch.roll(v, -1, dim) - v

    def bdx(v):
        return v - torch.cat([v[:1], v[:-1]])

    def fdx(v):
        return torch.cat([v[1:], v[-1:]]) - v

    for _ in range(k):
        hx, hy, hz = f["Hx"], f["Hy"], f["Hz"]
        f["Ex"] = ca * f["Ex"] + cb * (bd(hz, 1) - bd(hy, 2))
        f["Ey"] = ca * f["Ey"] + cb * (bd(hx, 2) - bdx(hz))
        f["Ez"] = ca * f["Ez"] + cb * (bdx(hy) - bd(hx, 1))
        ex, ey, ez = f["Ex"], f["Ey"], f["Ez"]
        f["Hx"] = ca * hx - cb * (fd(ez, 1) - fd(ey, 2))
        f["Hy"] = ca * hy - cb * (fd(ex, 2) - fdx(ez))
        f["Hz"] = ca * hz - cb * (fdx(ey) - fd(ex, 1))
    return f


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bx", [4, 8])
@pytest.mark.parametrize("k", kernel_lab2.KS)
def test_reference_is_k_steps_on_the_virtual_sequence(k, bx, dtype):
    """The windows' output equals k steps on V, rows [hw, hw + n): the
    windows' stale zones never reach the rows they write."""
    f = to_torch(random_fields(40 + k), dtype)
    hw = kernel_lab2.halo_width(k, bx)
    rows = kernel_lab2.virtual_rows(N, bx, k)
    assert rows.tolist() == (list(range(hw)) + list(range(N))
                             + list(range(N - hw, N)))
    on_v = steps_on({c: v[rows] for c, v in f.items()}, k)
    want = {c: v[hw:hw + N].to(dtype) for c, v in on_v.items()}
    got = kernel_lab2.lab_kstep_reference(f, k, bx)
    err = rel_err(as_np(want), as_np(got))
    assert err <= 1e-6, f"k={k} bx={bx} {dtype}: {err:.2e}"
    assert all(torch.equal(want[c], got[c]) for c in got)


@pytest.mark.parametrize("n,k,hw,chunks", [
    (16, 1, 1, 1), (16, 2, 2, 3), (16, 3, 4, 5), (16, 4, 4, 16),
    (384, 4, 4, 4), (384, 1, 1, 11), (20, 3, 3, 7)])
def test_chunk_plan_holds_every_stored_cone(n, k, hw, chunks):
    """The chunks store V's rows [hw, hw + n) once each, and each stored
    row's dependency cone (k rows each way: E_k(x) reads level-0 rows
    [x - k, x + k - 1], H_k(x) rows [x - k, x + k]) lies inside its chunk's
    march rows, or is cut by V's own ends."""
    length = n + 2 * hw
    plan = kernel_lab2.chunk_rows(n, k, hw, chunks)
    stored = [x for _, s, e, _ in plan for x in range(s, e)]
    assert stored == list(range(hw, hw + n))
    for a, s, e, b in plan:
        assert 0 <= a <= s <= e <= b <= length
        for x in range(s, e):
            assert max(x - k, 0) >= a and min(x + k + 1, length) <= b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunks", [1, 3, 16])
@pytest.mark.parametrize("bx,k", [(8, 1), (4, 2), (4, 3), (8, 4)])
def test_chunked_march_equals_the_reference(k, bx, chunks, dtype):
    """The kernel's chunked march, each chunk stepped alone with zero x
    differences at its own first and last march row, gives the reference
    bit for bit: the lead-in and lead-out rows absorb the chunk ends."""
    f = to_torch(random_fields(50 + k), dtype)
    hw = kernel_lab2.halo_width(k, bx)
    rows = kernel_lab2.virtual_rows(N, bx, k)
    v = {c: t[rows] for c, t in f.items()}
    parts = []
    for a, s, e, b in kernel_lab2.chunk_rows(N, k, hw, chunks):
        out = steps_on({c: t[a:b] for c, t in v.items()}, k)
        parts.append({c: t[s - a:e - a] for c, t in out.items()})
    got = {c: torch.cat([p[c] for p in parts]).to(dtype) for c in f}
    ref = kernel_lab2.lab_kstep_reference(f, k, bx)
    assert all(torch.equal(got[c], ref[c]) for c in ref), (k, bx, chunks)


def test_chunk_count_balances_the_waves():
    # 384^3 at k = 4, 16 x 32 tiles (288), one block per SM on 132 SMs:
    # 4 chunks, 9 waves of 108 march positions
    assert kernel_lab2.chunk_count(384, 4, 288, 132) == 4
    # one chunk where the tiles alone fill whole waves
    assert kernel_lab2.chunk_count(384, 1, 264, 264) == 1
    for n, k, tiles, slots in ((16, 2, 1, 132), (384, 3, 288, 264)):
        c = kernel_lab2.chunk_count(n, k, tiles, slots)
        assert 1 <= c <= n


def test_cpu_dispatch_counts_no_launch():
    before = dict(kernel_lab2.LAUNCHES)
    kernel_lab2.lab_kstep(to_torch(random_fields(4), torch.float32), 2, 8)
    assert kernel_lab2.LAUNCHES == before


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_lab2.main(["16"]) == 2


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
@pytest.mark.parametrize("k", kernel_lab2.KS)
def test_kernel_matches_plain(k, bx, dtype, cuda):
    f = to_torch(random_fields(30 + k), dtype, cuda)
    key = kernel_lab2.launch_key(k, dtype)
    before = kernel_lab2.LAUNCHES.get(key, 0)
    got = kernel_lab2.lab_kstep(f, k, bx)
    torch.cuda.synchronize()
    assert kernel_lab2.LAUNCHES[key] == before + 1
    ref = kernel_lab2.lab_kstep_reference(f, k, bx)
    err = rel_err(as_np(ref), as_np(got))
    assert err <= TOL[dtype], f"k={k} bx={bx} {dtype}: {err:.2e}"
