"""The port's pole lab (``tidy3d_tpu_torch.labs.pole_lab``) against the JAX
lab ``scripts/pole_lab.py``.

The JAX lab's kernels read its module globals (``Wx``, ``Wy``, ``Z``,
``R``, ``GRID``) at trace time, so the test sets them small on the loaded
module (2 x 8 x 128 cells, 3 repeats, a grid of 2) and builds and calls
each ``make_*`` inside ``force_tpu_interpret_mode``; the port's function
gets the same sizes as arguments and the same seeded numpy inputs.
Tolerances, relative to the largest magnitude: 1e-6 in f32, 1e-2 for the
bf16 ``pole_chan`` (bf16's epsilon is 7.8e-3).

Without JAX: ``pole_chan`` and ``pole_packed`` agree, every repeat of the
grid gives the same window, the flop model is the JAX lab's, and
``curl_mix``'s kernel decomposition emulated in torch equals the plain
version bit for bit. The
kernel-against-plain tests at the end need a CUDA card and skip without
one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tidy3d_tpu_torch.labs import _common, pole_lab

from tests.test_torch_lab_step import jax_lab, round_bf16

SIZES = dict(wx=2, wy=8, z=128)
REPS, GRID = 3, 2


def rel(ref, got) -> float:
    ref = np.asarray(ref, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    assert ref.shape == got.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def as_np(t) -> np.ndarray:
    return t.double().cpu().numpy()


def jax_run(variant, inputs, monkeypatch):
    lab = jax_lab("pole_lab")
    for name, value in (("Wx", SIZES["wx"]), ("Wy", SIZES["wy"]),
                        ("Z", SIZES["z"]), ("R", REPS), ("GRID", GRID)):
        monkeypatch.setattr(lab, name, value)
    makers = {"vpu_peak": lab.make_vpu_peak, "fma_peak": lab.make_fma_peak,
              "pole_chan": lab.make_pole_chan,
              "pole_chan_bf16": lambda: lab.make_pole_chan(jnp.bfloat16),
              "pole_packed": lab.make_pole_packed,
              "curl_mix": lab.make_curl_mix}
    with pltpu.force_tpu_interpret_mode():
        fn, args, _ = makers[variant]()
        ours = [jnp.asarray(t.float().numpy(), dtype=a.dtype)
                for t, a in zip(inputs, args)]
        assert [a.shape for a in ours] == [a.shape for a in args]
        return np.asarray(fn(*ours).astype(jnp.float32))


def jax_tolerance(variant: str) -> float:
    """1e-6 in f32 and 1e-2 in bf16, but for the FMA chains: XLA on the CPU
    contracts each ``a * c + v`` into one FMA (bit for bit an FMA emulated
    in float64), the plain version rounds product and sum apart, so the two
    drift by up to 1.5 ulp of the carry a chain step, undamped (c ~ 1)."""
    if variant.endswith("bf16"):
        return 1e-2
    steps = pole_lab.chain_steps(variant, REPS)
    return max(1e-6, 1.5 * steps * 2.0 ** -23)


@pytest.mark.parametrize("variant", pole_lab.VARIANTS)
def test_matches_the_jax_lab(variant, monkeypatch):
    inputs = pole_lab.make_inputs(variant, seed=1, **SIZES)
    ref = jax_run(variant, inputs, monkeypatch)
    got = pole_lab.run(variant, inputs, reps=REPS, grid=GRID)
    tol = jax_tolerance(variant)
    err = rel(ref, as_np(got))
    assert err <= tol, f"{variant}: {err:.2e}"


def test_packed_coefficients_are_the_jax_labs():
    lab = jax_lab("pole_lab")
    with pltpu.force_tpu_interpret_mode():
        _, args, _ = lab.make_pole_packed()
    assert np.array_equal(np.asarray(args[3]), pole_lab.packed_coeffs())


def test_chan_and_packed_agree():
    """The two formulations on the same values (``q`` permuted into the
    packed layout) agree to the rounding of their different sum orders
    over 60 repeats."""
    chan = pole_lab.make_inputs("pole_chan", seed=2, **SIZES)
    packed = pole_lab.make_inputs("pole_packed", seed=2, **SIZES)
    assert torch.equal(packed[2], chan[2][:, pole_lab.chan_to_packed()])
    a = pole_lab.run("pole_chan", chan, reps=60, grid=1)
    b = pole_lab.run("pole_packed", packed, reps=60, grid=1)
    assert rel(as_np(a), as_np(b)) <= 1e-5


@pytest.mark.parametrize("variant", pole_lab.VARIANTS)
def test_grid_copies_are_equal(variant):
    inputs = pole_lab.make_inputs(variant, seed=3, **SIZES)
    out = pole_lab.run(variant, inputs, reps=2, grid=3, copies=True)
    assert out.shape == (3, SIZES["wx"], SIZES["wy"], SIZES["z"])
    assert all(torch.equal(out[0], out[g]) for g in range(1, 3))
    assert bool(torch.isfinite(out.float()).all())


def test_flop_model_is_the_jax_labs():
    lab = jax_lab("pole_lab")
    assert pole_lab.flops("pole_chan", reps=1, grid=1) == lab.POLE_FLOPS
    # the lab's sizes: 241.6, 120.8, 402.0 and 101.9 GFLOP a call
    for variant, gflop in (("vpu_peak", 241.6), ("fma_peak", 120.8),
                           ("pole_packed", 402.0), ("curl_mix", 101.9)):
        assert abs(pole_lab.flops(variant) / 1e9 - gflop) < 0.05


def test_operation_count_is_the_functions():
    """``ops``, what the bounds count, is the function's own work: 198
    operations a cell and repeat for the pole update, 48 for ``curl_mix``
    (fewer than the flop model's 213 and 54), plus the final sum; the bf16
    ``pole_chan`` is held to the bf16 peak."""
    one = dict(wx=1, wy=1, z=1, grid=1)
    for variant, per, final in (("vpu_peak", 128, 7), ("fma_peak", 64, 1),
                                ("pole_chan", 198, 3), ("pole_packed", 198, 3),
                                ("curl_mix", 48, 1)):
        assert pole_lab.ops(variant, reps=0, **one) == final
        assert pole_lab.ops(variant, reps=5, **one) == 5 * per + final
        assert pole_lab.ops(variant) <= pole_lab.flops(variant) + final * (
            pole_lab.Wx * pole_lab.Wy * pole_lab.Z * pole_lab.GRID)
    assert pole_lab.flops("pole_chan", reps=1, grid=1, wx=1, wy=1, z=1) == 213
    assert pole_lab.peak("pole_chan_bf16") == _common.PEAK_BF16 == 133.8e12
    assert pole_lab.peak("pole_chan") == _common.PEAK_F32


def pole_chan_bf16_emulated(e, m, q, reps: int) -> np.ndarray:
    """``pole_chan`` in float64 with each multiply, add and subtract
    rounded once to bf16, left to right, at the lab's bf16 constants."""
    k = pole_lab.chan_constants(torch.bfloat16)
    r = round_bf16
    mask = m.double().numpy()
    es = [e[:, ci].double().numpy() for ci in range(3)]
    qs = [q[:, ch].double().numpy() for ch in range(pole_lab.C)]
    for _ in range(reps):
        new_es = []
        for ci in range(3):
            pt = None
            for p in range(pole_lab.NR + pole_lab.NC):
                ch0 = p * 3 if p < pole_lab.NR else \
                    pole_lab.NR * 3 + (p - pole_lab.NR) * 6
                t = r(k["gr"][p] * qs[ch0 + ci])
                if p >= pole_lab.NR:
                    t = r(t - r(k["gi"][p] * qs[ch0 + 3 + ci]))
                pt = t if pt is None else r(pt + t)
            new_es.append(r(r(k["ca"] * es[ci]) + r(k["cb"] * pt)))
        for ci in range(3):
            mes = r(mask * r(new_es[ci] + es[ci]))
            for p in range(pole_lab.NR + pole_lab.NC):
                ch0 = p * 3 if p < pole_lab.NR else \
                    pole_lab.NR * 3 + (p - pole_lab.NR) * 6
                qr = qs[ch0 + ci]
                nqr = r(k["ar"][p] * qr)
                if p >= pole_lab.NR:
                    qi = qs[ch0 + 3 + ci]
                    nqr = r(nqr - r(k["ai"][p] * qi))
                    qs[ch0 + 3 + ci] = r(r(r(k["ai"][p] * qr)
                                           + r(k["ar"][p] * qi))
                                         + r(k["b0i"][p] * mes))
                qs[ch0 + ci] = r(nqr + r(k["b0r"][p] * mes))
        es = new_es
    return r(r(r(es[0] + es[1]) + es[2]) + qs[0])


def test_round_bf16_is_torchs():
    x = np.random.default_rng(5).standard_normal(4096) * 10.0 ** \
        np.random.default_rng(6).integers(-6, 6, 4096)
    want = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    assert np.array_equal(round_bf16(x), want)


@pytest.mark.parametrize("reps", [1, pole_lab.R])
def test_bf16_reference_rounds_each_operation_once(reps):
    """The plain bf16 ``pole_chan`` against a float64 emulation that rounds
    each exact operation once to bf16 (the native bf16x2 kernel's
    arithmetic): within the 1e-2 kernel tolerance at R = 600; the one-ulp
    differences after one repeat are counted and printed."""
    sizes = dict(wx=1, wy=4, z=32)
    e, m, q = pole_lab.make_inputs("pole_chan_bf16", seed=7, **sizes)
    got = pole_lab.run("pole_chan_bf16", (e, m, q), reps=reps, grid=1)
    want = pole_chan_bf16_emulated(e, m, q, reps)
    got = got.double().numpy()
    err = rel(want, got)
    assert err <= pole_lab.kernel_tolerance("pole_chan_bf16"), err
    if reps == 1:
        ulp = np.ldexp(1.0, np.frexp(np.abs(want))[1] - 8)
        diffs = int(np.count_nonzero(got != want))
        ones = int(np.count_nonzero(np.abs(got - want) == ulp))
        print(f"pole_chan_bf16, one repeat: {diffs} of {want.size} outputs "
              f"differ from single rounding, {ones} by one ulp")
        assert diffs == ones


def curl_mix_emulated(x, reps: int):
    """``curl_mix`` (one grid copy) as its kernel decomposes a window plane
    (``pole_lab.curl_mix_plan``): each thread's rows x cells in registers;
    along z a lane's own cells, and for its first (last) cell the last
    (first) cell of the lane before (after), lane 0 and 31 wrapping; along y
    the thread's other rows, and for its first (last) row the edge row that
    the warp before (after) stores, the first and last warp wrapping."""
    wx, wy, z = x.shape
    plan = pole_lab.curl_mix_plan(wy, z)
    nw = plan["warps"]
    xb = x.reshape(wx, nw, plan["rows"], 32, plan["cells"])
    e = [xb * (0.1 * i + 0.1) for i in range(3)]
    h = [xb * (0.1 * i + 0.1) for i in range(3, 6)]
    below = [(w - 1) % nw for w in range(nw)]   # whose edge row a warp reads
    above = [(w + 1) % nw for w in range(nw)]

    def zm(f):
        last = f[..., -1:][:, :, :, [31, *range(31)]]
        return torch.cat([last, f[..., :-1]], -1)

    def zp(f):
        first = f[..., :1][:, :, :, [*range(1, 32), 0]]
        return torch.cat([f[..., 1:], first], -1)

    def ym(f):
        return torch.cat([f[:, below, -1:], f[:, :, :-1]], 2)

    def yp(f):
        return torch.cat([f[:, :, 1:], f[:, above, :1]], 2)

    for _ in range(reps):
        for ci in range(3):
            hj, hk = h[(ci + 1) % 3], h[(ci + 2) % 3]
            d1 = (hj - ym(hj)) * 0.5
            d2 = (hk - zm(hk)) * 0.5
            e[ci] = pole_lab.CA * e[ci] + pole_lab.CB * (d1 - d2)
        for ci in range(3):
            ej, ek = e[(ci + 1) % 3], e[(ci + 2) % 3]
            d1 = (yp(ej) - ej) * 0.5
            d2 = (zp(ek) - ek) * 0.5
            h[ci] = pole_lab.CA * h[ci] - pole_lab.CB * (d1 - d2)
    return (e[0] + h[0]).reshape(wx, wy, z)


@pytest.mark.parametrize("wy", [8, 64])
def test_curl_mix_decomposition_equals_plain(wy):
    """The kernel's decomposition of a window plane (cells per lane, rows
    per thread, warp edges, both wraps) gives the plain version's result
    bit for bit over 3 repeats of a seeded window."""
    (x,) = pole_lab.make_inputs("curl_mix", wx=2, wy=wy, z=128, seed=11)
    want = pole_lab.curl_mix_reference(x, reps=3, grid=1)[0]
    assert torch.equal(curl_mix_emulated(x, 3), want)


@pytest.mark.parametrize("wy,z", [(6, 128), (8, 64), (68, 128), (0, 128)])
def test_curl_mix_plan_refuses_other_windows(wy, z):
    with pytest.raises(ValueError, match=f"\\(wy, z\\) = \\({wy}, {z}\\)"):
        pole_lab.curl_mix_plan(wy, z)


def test_cpu_dispatch_counts_no_launch():
    before = dict(pole_lab.LAUNCHES)
    pole_lab.run("fma_peak", pole_lab.make_inputs("fma_peak", **SIZES),
                 reps=1, grid=1)
    assert pole_lab.LAUNCHES == before


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pole_lab.main(["fma_peak"]) == 2


# --------------------------------------------------------------------------- #
# kernel against plain version, on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", pole_lab.VARIANTS)
def test_kernel_matches_plain(variant, cuda):
    inputs = pole_lab.make_inputs(variant, seed=4, device=cuda, **SIZES)
    before = pole_lab.LAUNCHES.get(variant, 0)
    got = pole_lab.run(variant, inputs, reps=REPS, grid=GRID, copies=True)
    torch.cuda.synchronize()
    assert pole_lab.LAUNCHES[variant] == before + 1
    assert all(torch.equal(got[0], got[g]) for g in range(1, GRID))
    ref = pole_lab.REFERENCES[variant](*inputs, reps=REPS, grid=GRID)
    tol = pole_lab.kernel_tolerance(variant, REPS)
    err = rel(as_np(ref[0]), as_np(got[0]))
    assert err <= tol, f"{variant}: {err:.2e}"


@pytest.mark.gpu
@pytest.mark.parametrize("wx,wy,reps", [(2, 8, 40), (pole_lab.Wx, pole_lab.Wy,
                                                     40)])
def test_curl_mix_kernel_on_seeded_windows(wx, wy, reps, cuda):
    (x,) = pole_lab.make_inputs("curl_mix", wx=wx, wy=wy, z=pole_lab.Z,
                                seed=13, device=cuda)
    got = pole_lab.run("curl_mix", (x,), reps=reps, grid=2, copies=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])
    ref = pole_lab.curl_mix_reference(x, reps=reps, grid=1)
    err = rel(as_np(ref[0]), as_np(got[0]))
    assert err <= pole_lab.kernel_tolerance("curl_mix", reps), err


@pytest.mark.gpu
def test_curl_mix_kernel_refuses_other_windows(cuda):
    (x,) = pole_lab.make_inputs("curl_mix", wx=1, wy=6, z=128, device=cuda)
    with pytest.raises(ValueError, match="6, 128"):
        pole_lab.run("curl_mix", (x,), reps=1, grid=1)
