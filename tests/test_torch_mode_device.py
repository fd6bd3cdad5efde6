"""The device mode solver (``plugins/mode/device_solver.py``) against the
JAX package's (``tidy3d_tpu/plugins/mode/tpu_solver.py``) and against the
port's own ARPACK path, on the CPU.

- The real-proxy operator on seeded random blocks of the strip of
  ``tests/test_plugins/test_mode_tpu.py``: the port's against the JAX
  package's and both against the host float64 evaluation, to 2e-5 of the
  largest magnitude. 1e-5 would sit on the float32 floor of the operator
  itself: the JAX package's own operator is 7.1e-6 to 1.1e-5 off its
  float64 evaluation on seeds 0 to 5 of an 8-column block (white noise
  makes the second differences cancel the most).
- One filter pass of degree 50 against the float64 sparse filter
  (``_host_cheb_filter``) on the same proxy, to 5e-5 of the largest
  magnitude (measured 8.3e-6).
- Whole solves forced to the filter on the CPU: against the port's ARPACK
  at the bars of ``tests/test_plugins/test_mode_tpu.py`` (n_eff within
  2e-5, 5e-5 for the bend; field overlap above 0.999), with and without an
  8-layer PML, and against the JAX package's filter on the same strip.
- The routing by device, the fallback counter and the TF32 guard.
- A plane whose filtered block loses rank: the port falls back to ARPACK
  where the reference's ``cholqr2`` raises.
- The slice: ``web.run(device="cpu")`` of a mode source and a mode monitor
  on a plane of 2N = 648 under ``TIDY3D_TPU_MODE_SOLVER=filter`` against
  ``tidy3d_tpu.web.run`` under the same knob, mode amplitudes and
  n_complex to 2e-5 of the largest.
"""

import contextlib

import numpy as np
import pytest
import torch

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import DL, FREQ0, to_reference, waveguide
from tests.test_plugins.test_mode_tpu import overlap, strip_eps
from tidy3d_tpu import web as ref_web
from tidy3d_tpu.components.mode import ModeSpec as RefModeSpec
from tidy3d_tpu.plugins.mode import compute_modes as ref_compute_modes
from tidy3d_tpu.plugins.mode import tpu_solver as ref_solver

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch.constants import C_0
from tidy3d_tpu_torch.components.mode import ModeSpec
from tidy3d_tpu_torch.plugins.mode import compute_modes, device_solver
from tidy3d_tpu_torch.plugins.mode.solver import _derivative_mats

TOL_OPERATOR = 2e-5     # float32 operator against float64 / the reference
TOL_FILTER = 5e-5       # one float32 filter pass against the float64 one
TOL_NEFF = 2e-5         # tests/test_plugins/test_mode_tpu.py:57
TOL_NEFF_BEND = 5e-5    # tests/test_plugins/test_mode_tpu.py:72
MIN_OVERLAP = 0.999
TOL_AMPS = 2e-5         # the slice's mode data, of the largest


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """One torch and one BLAS thread: the suite runs these small solves
    beside other test processes, where spinning thread pools oversubscribe
    the cores (six processes on eight cores, three of these tests: 10 s
    with one thread each, over 600 s with the default eight)."""
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:      # without it, BLAS keeps its own thread count
        limits = contextlib.nullcontext()
    else:
        limits = threadpool_limits(1)
    with limits:
        yield
    torch.set_num_threads(threads)


def _strip_operator():
    """The strip's real-proxy ingredients (the unstretched derivative
    matrices, as ``_eigs_filter_device`` builds them)."""
    eps, (x_b, y_b) = strip_eps()
    nx, ny = eps[0].shape
    ones_x, ones_y = np.ones(nx, complex), np.ones(ny, complex)
    dxf, dxb = (m.toarray() for m in _derivative_mats(x_b, ones_x, ones_x))
    dyf, dyb = (m.toarray() for m in _derivative_mats(y_b, ones_y, ones_y))
    eps_x, eps_y, eps_z = (np.real(e) for e in eps)
    ones = np.ones((nx, ny))
    k0 = 2 * np.pi * FREQ0 / C_0
    return (dxf, dxb, dyf, dyb, eps_x, eps_y, 1.0 / eps_z, ones, ones,
            ones, ones, ones, k0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_operator_matches_the_reference(seed):
    import jax.numpy as jnp

    args = _strip_operator()
    nx, ny = args[4].shape
    port = device_solver.make_apply_real(*args, device="cpu")
    ref = ref_solver.make_apply_real(*args)
    x = np.random.default_rng(seed).standard_normal(
        (2, nx, ny, 8)).astype(np.float32)
    got = port(torch.from_numpy(x)).numpy()
    want = np.asarray(ref(jnp.asarray(x)))
    exact = port.apply_np64(x.astype(np.float64))
    assert np.array_equal(exact, ref.apply_np64(x.astype(np.float64)))
    scale = float(np.max(np.abs(exact)))
    for name, a in (("port", got), ("reference", want)):
        err = float(np.max(np.abs(a - exact))) / scale
        assert err <= TOL_OPERATOR, f"{name} vs float64: {err:.2e}"
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= TOL_OPERATOR, f"port vs reference: {err:.2e}"
    # the sparse proxy of the host polish is the same operator
    proxy = device_solver.assemble_real_proxy(*args)
    n2 = 2 * nx * ny
    flat = proxy @ x.astype(np.float64).reshape(n2, -1)
    assert np.max(np.abs(flat - exact.reshape(n2, -1))) <= 1e-12 * scale


def test_filter_pass_matches_the_host_filter():
    args = _strip_operator()
    nx, ny = args[4].shape
    n2 = 2 * nx * ny
    apply_m = device_solver.make_apply_real(*args, device="cpu")
    proxy = device_solver.assemble_real_proxy(*args)
    rows = np.repeat(np.arange(n2), np.diff(proxy.indptr))
    lo = -float(np.bincount(rows, weights=np.abs(proxy.data),
                            minlength=n2).max())
    lam_hi = (3.0 * args[-1]) ** 2
    x = np.random.default_rng(3).standard_normal((n2, 6))
    want = device_solver._host_cheb_filter(proxy, x, lo, 0.0, lam_hi, 50)
    got = device_solver._chebyshev_filter(
        lambda q: apply_m(q.reshape(2, nx, ny, -1)).reshape(n2, -1),
        torch.from_numpy(x.astype(np.float32)), lo, 0.0, lam_hi, 50)
    err = float(np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)))
    assert err <= TOL_FILTER, err


def _solve(monkeypatch, mode, spec, device="cpu"):
    eps, coords = strip_eps()
    monkeypatch.setenv("TIDY3D_TPU_MODE_SOLVER", mode)
    return compute_modes(eps, coords, FREQ0, spec, device=device)


@pytest.mark.parametrize("num_pml", [(0, 0), (8, 8)])
def test_filter_matches_arpack(monkeypatch, num_pml):
    spec = ModeSpec(num_modes=3, target_neff=2.2, num_pml=num_pml)
    fields_a, n_a = _solve(monkeypatch, "arpack", spec)
    solves, fallbacks = device_solver.SOLVES, device_solver.FALLBACKS
    fields_f, n_f = _solve(monkeypatch, "filter", spec)
    assert device_solver.SOLVES == solves + 1
    assert device_solver.FALLBACKS == fallbacks
    assert np.allclose(n_f.real, n_a.real, atol=TOL_NEFF), (n_f, n_a)
    for mi in range(2):  # the two clearly-guided modes
        for comp in ("Ex", "Ey"):
            ov = overlap(fields_a[comp][..., mi], fields_f[comp][..., mi])
            assert ov > MIN_OVERLAP, (comp, mi, ov)


def test_filter_bend(monkeypatch):
    spec = ModeSpec(num_modes=2, target_neff=2.2, bend_radius=8.0,
                    bend_axis=1)
    _, n_a = _solve(monkeypatch, "arpack", spec)
    fallbacks = device_solver.FALLBACKS
    _, n_f = _solve(monkeypatch, "filter", spec)
    assert device_solver.FALLBACKS == fallbacks
    assert np.allclose(n_f.real, n_a.real, atol=TOL_NEFF_BEND)


@pytest.mark.parametrize("num_pml", [(0, 0), (8, 8)])
def test_filter_matches_the_reference_filter(monkeypatch, num_pml):
    """Both packages forced to their filter on the CPU, from different
    random starts (``torch.Generator`` here, ``jax.random`` there)."""
    eps, coords = strip_eps()
    spec = dict(num_modes=3, target_neff=2.2, num_pml=num_pml)
    monkeypatch.setenv("TIDY3D_TPU_MODE_SOLVER", "filter")
    fields_r, n_r = ref_compute_modes(eps, coords, FREQ0,
                                      RefModeSpec(**spec))
    fields_p, n_p = compute_modes(eps, coords, FREQ0, ModeSpec(**spec),
                                  device="cpu")
    assert np.allclose(n_p.real, n_r.real, atol=TOL_NEFF), (n_p, n_r)
    for mi in range(2):
        for comp in ("Ex", "Ey"):
            ov = overlap(fields_r[comp][..., mi], fields_p[comp][..., mi])
            assert ov > MIN_OVERLAP, (comp, mi, ov)


def test_auto_routing(monkeypatch):
    """auto takes the filter only for a CUDA device and 2N >= 20000; a
    device object needs no card to route; filter forces it; arpack and
    off-axis planes never take it."""
    route = device_solver.use_filter_path
    cuda = torch.device("cuda")
    monkeypatch.setenv("TIDY3D_TPU_MODE_SOLVER", "auto")
    assert not route(200000, has_offaxis=False, device="cpu")
    assert route(20000, has_offaxis=False, device=cuda)
    assert not route(19998, has_offaxis=False, device=cuda)
    assert not route(200000, has_offaxis=True, device=cuda)
    # no device named: the innermost scope's, else CUDA
    assert route(20000, has_offaxis=False)
    with device_solver.solve_on("cpu"):
        assert not route(20000, has_offaxis=False)
        with device_solver.solve_on(cuda):
            assert route(20000, has_offaxis=False)
        assert device_solver.solve_device() == torch.device("cpu")
    assert device_solver.solve_device() == cuda
    monkeypatch.setenv("TIDY3D_TPU_MODE_SOLVER", "filter")
    assert route(1000, has_offaxis=False, device="cpu")
    assert not route(1000, has_offaxis=True, device="cpu")
    monkeypatch.setenv("TIDY3D_TPU_MODE_SOLVER", "arpack")
    assert not route(200000, has_offaxis=False, device=cuda)


def test_auto_on_the_cpu_stays_arpack(monkeypatch):
    """``auto`` with the CPU named runs no filter solve; a forced filter
    with the default device and no card raises, it does not fall back."""
    spec = ModeSpec(num_modes=2, target_neff=2.2)
    solves = device_solver.SOLVES
    _solve(monkeypatch, "auto", spec)
    assert device_solver.SOLVES == solves
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            _solve(monkeypatch, "filter", spec, device=None)
        assert device_solver.SOLVES == solves


def test_fallback_is_counted(monkeypatch):
    """A filter that cannot converge (one outer iteration, a residual
    target it cannot reach) falls back to ARPACK, warns, and counts."""
    spec = ModeSpec(num_modes=2, target_neff=2.2)
    _, n_a = _solve(monkeypatch, "arpack", spec)
    monkeypatch.setattr(device_solver, "MAX_OUTER", 1)
    monkeypatch.setattr(device_solver, "RESIDUAL_TOL", 1e-14)
    solves, fallbacks = device_solver.SOLVES, device_solver.FALLBACKS
    _, n_f = _solve(monkeypatch, "filter", spec)
    assert device_solver.SOLVES == solves + 1
    assert device_solver.FALLBACKS == fallbacks + 1
    assert device_solver.RECORDS[-1]["fallback"]
    assert np.array_equal(n_f, n_a)


@pytest.mark.parametrize("num_modes", [1, 3])
def test_rank_collapse_falls_back_to_arpack(monkeypatch, num_modes):
    """A plane with fewer propagating states than the filter's block (30 x
    24 at dl = 0.05 um, eps 12.1 in 2.085): the first filter pass
    collapses the block's rank and the float32 Gram is not positive
    definite. The port's ``cholqr2`` returns None and the solve falls back
    to ARPACK (``fallback`` and its ``reason`` recorded), giving ARPACK's
    n_eff within 1e-6; the reference's raises ``LinAlgError`` there (a
    deliberate divergence, ROADMAP.md queue 3)."""
    eps, coords = strip_eps(nx=30, ny=24, dl=0.05, n_core=np.sqrt(12.1),
                            n_clad=np.sqrt(2.085), w=0.5, h=0.22)
    monkeypatch.setenv("TIDY3D_TPU_MODE_SOLVER", "arpack")
    _, n_a = compute_modes(eps, coords, FREQ0, ModeSpec(num_modes=num_modes),
                           device="cpu")
    monkeypatch.setenv("TIDY3D_TPU_MODE_SOLVER", "filter")
    solves, fallbacks = device_solver.SOLVES, device_solver.FALLBACKS
    _, n_f = compute_modes(eps, coords, FREQ0, ModeSpec(num_modes=num_modes),
                           device="cpu")
    assert device_solver.SOLVES == solves + 1
    assert device_solver.FALLBACKS == fallbacks + 1
    record = device_solver.RECORDS[-1]
    assert record["fallback"] and "cholqr2" in record["reason"]
    assert np.max(np.abs(n_f - n_a)) <= 1e-6
    with pytest.raises(np.linalg.LinAlgError):
        ref_compute_modes(eps, coords, FREQ0,
                          RefModeSpec(num_modes=num_modes))


def test_matmuls_run_in_full_float32(monkeypatch):
    """Inside a solve TF32 is off whatever the process set, and the
    process's setting is back after it."""
    seen = []
    make = device_solver.make_apply_real

    def spying(*args, **kw):
        apply_m = make(*args, **kw)

        def wrapped(x):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.get_float32_matmul_precision()))
            return apply_m(x)

        for name in ("apply_np64", "device", "shape2d"):
            setattr(wrapped, name, getattr(apply_m, name))
        return wrapped

    monkeypatch.setattr(device_solver, "make_apply_real", spying)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        _solve(monkeypatch, "filter", ModeSpec(num_modes=2, target_neff=2.2))
        assert seen and set(seen) == {(False, "highest")}
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev[1])
        torch.backends.cuda.matmul.allow_tf32 = prev[0]


def _slice_case():
    """``tests/torch_cases.waveguide`` widened to a 0.9 x 0.9 um mode
    plane (18 x 18 cells, 2N = 648, above the dense cut of 600): a mode
    source of mode 0 and a mode monitor of 2 modes at 3 frequencies."""
    plane = dict(size=(0, 0.9, 0.9))
    sim = waveguide(monitors=[], run_time=2e-14)
    freqs = list(np.linspace(0.95 * FREQ0, 1.05 * FREQ0, 3))
    return sim.copy(update=dict(
        size=(sim.size[0], 1.0, 1.0),
        sources=[sim.sources[0].copy(update=plane)],
        monitors=[tt.ModeMonitor(center=(0.15, 0, 0), **plane, freqs=freqs,
                                 mode_spec=tt.ModeSpec(num_modes=2),
                                 name="mode")]))


def test_web_run_on_the_filter_matches_the_reference(monkeypatch):
    """The slice: both ``web.run``s with every mode solve forced to their
    filter. The two filters start from different random blocks, but the
    float64 polish and refinement converge both to the same modes: the
    amplitudes differ by 2.1e-7 of the largest and n_complex by 7.8e-9
    (measured), so the repo's bar of ``tests/test_torch_web.py``,
    ``TOL_AMPS`` = 2e-5, holds with room."""
    monkeypatch.setenv("TIDY3D_TPU_MODE_SOLVER", "filter")
    sim = _slice_case()
    assert round(0.9 / DL) == 18
    solves, fallbacks = device_solver.SOLVES, device_solver.FALLBACKS
    got = tt.web.run(sim, device="cpu", verbose=False)
    # the source's solve in lower() and the monitor's three, on the CPU
    assert device_solver.SOLVES == solves + 4
    assert device_solver.FALLBACKS == fallbacks
    assert all(r["device"] == "cpu" and r["shape"] == (18, 18)
               for r in device_solver.RECORDS[-4:])
    ref = ref_web.run(to_reference(sim), verbose=False)
    for name in ("amps", "n_complex"):
        r = np.asarray(getattr(ref["mode"], name).values)
        g = np.asarray(getattr(got["mode"], name).values)
        assert r.shape == g.shape and np.all(np.isfinite(g))
        err = float(np.max(np.abs(g - r)) / np.max(np.abs(r)))
        assert err <= TOL_AMPS, f"{name}: rel err {err:.2e}"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the filter's graphs run on a card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("num_pml", [(0, 0), (8, 8)])
def test_filter_on_the_card_matches_arpack(monkeypatch, num_pml, cuda):
    spec = ModeSpec(num_modes=3, target_neff=2.2, num_pml=num_pml)
    fields_a, n_a = _solve(monkeypatch, "arpack", spec)
    fallbacks = device_solver.FALLBACKS
    fields_f, n_f = _solve(monkeypatch, "filter", spec, device=cuda)
    assert device_solver.RECORDS[-1]["device"] == "cuda"
    assert device_solver.FALLBACKS == fallbacks
    assert np.allclose(n_f.real, n_a.real, atol=TOL_NEFF), (n_f, n_a)
    for mi in range(2):
        for comp in ("Ex", "Ey"):
            ov = overlap(fields_a[comp][..., mi], fields_f[comp][..., mi])
            assert ov > MIN_OVERLAP, (comp, mi, ov)


@pytest.mark.gpu
def test_graph_pass_equals_the_eager_pass(cuda):
    """A captured filter pass replays the eager pass's kernels: the same
    result to float32 rounding, on a second replay with new scalars too."""
    args = _strip_operator()
    nx, ny = args[4].shape
    n2 = 2 * nx * ny
    apply_m = device_solver.make_apply_real(*args, device=cuda)

    def block(q):
        return apply_m(q.reshape(2, nx, ny, -1)).reshape(n2, -1)

    x = torch.randn((n2, 12), generator=torch.Generator().manual_seed(4)
                    ).to(cuda)
    graph = device_solver._GraphFilter(block, (n2, 12), cuda)
    with device_solver.full_f32_matmul():
        for lo, cut in ((-8e3, 0.0), (-9e3, 20.0)):
            want = device_solver._chebyshev_filter(block, x, lo, cut, 200.0,
                                                   50)
            got = graph(x, lo, cut, 200.0, 50)
            err = float((got - want).abs().max() / want.abs().max())
            assert err <= 1e-6, err
    assert len(graph.graphs) == 1
