"""The JAX-free plugins of the port against the JAX package's.

``plugins/{waveguide,resonance,expressions,microwave,polyslab,smatrix,
design}`` are copies of the JAX package's; the modelers and the design
batch run this package's ``web.container.Batch`` on the device the caller
names (``device="cpu"`` here). One case a plugin, from
``tests/test_plugins/test_aux_plugins.py``, ``test_smatrix.py`` and
``test_analysis_plugins.py``, through both packages:

- waveguide: the strip's n_eff, within ``TOL_NEFF`` (both ARPACK);
- microwave: the analytic coax's impedance, within ``TOL_EXACT`` relative;
- smatrix: the straight-waveguide modeler, its S-matrix within
  ``TOL_SMATRIX`` of max |S| (the port's runs on its fused tier, the
  reference's on its XLA path), and the terminal modeler's S-matrix and
  symmetry;
- expressions: a round trip through JSON into the other package, and the
  values on the same mode amplitudes;
- design: grid and Monte Carlo samples and values, and ``run_batch`` with
  ``device="cpu"`` against the reference's batch;
- resonance: the synthetic two-pole signal, within ``TOL_EXACT``, cut
  from 5000 samples to 2000 (the matrix pencil's SVD then takes 1 s, not
  14 s, on one thread; the physics bars hold at 4e-3);
- polyslab: its import.

BLAS and torch run one thread each: the suite runs these beside other
test processes, where spinning thread pools oversubscribe the cores.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import SIMS, to_reference
import tidy3d_tpu
from tidy3d_tpu.constants import ETA_0

import tidy3d_tpu_torch as td
from tidy3d_tpu_torch.constants import C_0
from tidy3d_tpu_torch.plugins.mode.device_solver import solve_on

TOL_NEFF = 1e-6
TOL_EXACT = 1e-9        # relative: the same numpy arithmetic
TOL_SMATRIX = 1e-4      # of max |S|
WL = 1.55
FREQ0 = C_0 / WL


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:      # without it, BLAS keeps its own thread count
        limits = contextlib.nullcontext()
    else:
        limits = threadpool_limits(1)
    with limits, solve_on("cpu"):
        yield
    torch.set_num_threads(threads)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_waveguide_strip_neff():
    from tidy3d_tpu.plugins.waveguide import RectangularDielectric as Ref
    from tidy3d_tpu_torch.plugins.waveguide import RectangularDielectric

    kw = dict(wavelength=WL, core_width=0.5, core_thickness=0.22,
              core_medium=td.Medium(permittivity=3.476**2),
              clad_medium=td.Medium(permittivity=1.444**2),
              mode_spec=td.ModeSpec(num_modes=1, target_neff=2.5))
    wg = RectangularDielectric(**kw)
    ref = Ref.parse_raw(wg.json())
    n_port = np.asarray(wg.mode_data.n_complex.values)
    n_ref = np.asarray(ref.mode_data.n_complex.values)
    assert 2.3 < float(np.real(n_port[0, 0])) < 2.6
    assert np.max(np.abs(n_port - n_ref)) <= TOL_NEFF


def _coax(pkg, a=0.2, b=0.8, n=161):
    """The analytic coax TEM line of ``test_aux_plugins.py`` as ``pkg``'s
    ``FieldData``."""
    lin = np.linspace(-1.0, 1.0, n)
    x, y = np.meshgrid(lin, lin, indexing="ij")
    r = np.sqrt(x**2 + y**2)
    r_safe = np.where(r < a / 2, a / 2, r)
    e_full = 1.0 / (r_safe * np.log(b / a))
    er = np.where((r >= a) & (r <= b), e_full, 0.0)
    hmag = np.where(r >= a, e_full / ETA_0, 0.0)
    vals = dict(Ex=er * x / r_safe, Ey=er * y / r_safe,
                Ez=np.zeros_like(er), Hx=-hmag * y / r_safe,
                Hy=hmag * x / r_safe, Hz=np.zeros_like(er))
    coords = dict(x=lin, y=lin, z=np.array([0.0]), f=np.array([FREQ0]))
    comps = {name: pkg.ScalarFieldDataArray(
        v[:, :, None, None].astype(complex), coords=coords)
        for name, v in vals.items()}
    mon = pkg.FieldMonitor(center=(0, 0, 0), size=(2, 2, 0), freqs=[FREQ0],
                           name="coax")
    return pkg.FieldData(monitor=mon, **comps)


def test_microwave_coax_impedance():
    import tidy3d_tpu.plugins.microwave as ref_mw
    import tidy3d_tpu_torch.plugins.microwave as port_mw

    a, b = 0.2, 0.8
    out = []
    for pkg, mw in ((td, port_mw), (tidy3d_tpu, ref_mw)):
        calc = mw.ImpedanceCalculator(
            voltage_integral=mw.VoltageIntegralAxisAligned(
                center=((a + b) / 2, 0, 0), size=(b - a, 0, 0), sign="-"),
            current_integral=mw.CurrentIntegralAxisAligned(
                center=(0, 0, 0), size=(1.2, 1.2, 0), sign="+"))
        out.append(complex(np.asarray(
            calc.compute_impedance(_coax(pkg, a, b)).values)[0]))
    z_theory = ETA_0 * np.log(b / a) / (2 * np.pi)
    assert abs(out[0] - z_theory) / z_theory < 0.02
    assert abs(out[0] - out[1]) <= TOL_EXACT * abs(out[1])


def _straight_modeler():
    from tidy3d_tpu_torch.plugins.smatrix import ComponentModeler, Port

    wg = td.Structure(geometry=td.Box(center=(0, 0, 0),
                                      size=(td.inf, 0.5, td.inf)),
                      medium=td.Medium(permittivity=6.25))
    sim = td.Simulation(
        center=(0, 0, 0), size=(4.4, 3.2, 0), run_time=1.6e-13,
        structures=[wg], shutoff=0.0,
        boundary_spec=td.BoundarySpec(x=td.Boundary.pml(),
                                      y=td.Boundary.pml(),
                                      z=td.Boundary.periodic()),
        grid_spec=td.GridSpec.uniform(dl=0.05))
    spec = td.ModeSpec(num_modes=1, target_neff=2.3)
    ports = [Port(center=(-1.6, 0, 0), size=(0, 2.4, td.inf), direction="+",
                  mode_spec=spec, name="left"),
             Port(center=(1.6, 0, 0), size=(0, 2.4, td.inf), direction="-",
                  mode_spec=spec, name="right")]
    return ComponentModeler(simulation=sim, ports=ports,
                            freqs=[C_0 / 1.5], verbose=False)


def _element(smat, port_in, port_out) -> complex:
    return complex(smat.sel(port_in=port_in, port_out=port_out,
                            mode_index_in=0,
                            mode_index_out=0).values.ravel()[0])


def test_smatrix_straight_waveguide():
    from tidy3d_tpu.plugins.smatrix import ComponentModeler as Ref

    modeler = _straight_modeler()
    batch = modeler.make_batch("cpu")
    assert batch.device == "cpu" and modeler.batch.device == "cuda"
    got = modeler.run(device="cpu")
    want = Ref.parse_raw(modeler.json()).run()
    assert type(got).__module__.startswith("tidy3d_tpu_torch.")
    err = _rel(got.values, want.values)
    print(f"straight modeler: S-matrix {err:.1e} of max |S|")
    assert err <= TOL_SMATRIX
    s21, s12 = _element(got, "left", "right"), _element(got, "right", "left")
    assert 0.97 < abs(s21) < 1.02 and abs(_element(got, "left", "left")) < 0.1
    assert abs(s21 - s12) < 0.05


def _terminal_modeler(pkg, smatrix):
    sim = pkg.Simulation(
        center=(0, 0, 0), size=(3.0, 2.0, 2.0), run_time=4e-13,
        boundary_spec=pkg.BoundarySpec.all_sides(pkg.PML(num_layers=8)),
        grid_spec=pkg.GridSpec.uniform(dl=0.1), shutoff=1e-4)
    ports = (smatrix.LumpedPort(center=(-0.6, 0, 0), size=(0, 0.4, 0.4),
                                voltage_axis=2, name="p1"),
             smatrix.LumpedPort(center=(0.6, 0, 0), size=(0, 0.4, 0.4),
                                voltage_axis=2, name="p2"))
    return smatrix.TerminalComponentModeler(simulation=sim, ports=ports,
                                            freqs=[FREQ0])


def test_terminal_modeler_symmetry():
    """Built in each package (a ``LumpedPort``'s complex impedance does not
    parse back from JSON in either)."""
    import tidy3d_tpu.plugins.smatrix as ref_smatrix
    import tidy3d_tpu_torch.plugins.smatrix as port_smatrix

    modeler = _terminal_modeler(td, port_smatrix)
    ref = _terminal_modeler(tidy3d_tpu, ref_smatrix)
    assert modeler.json() == ref.json()
    got = np.asarray(modeler.run(device="cpu").values)
    want = np.asarray(ref.run().values)
    err = _rel(got, want)
    print(f"terminal modeler: S-matrix {err:.1e} of max |S|")
    assert got.shape == (2, 2, 1) and np.all(np.isfinite(got))
    assert err <= TOL_SMATRIX
    assert abs(got[0, 0, 0] - got[1, 1, 0]) < 5e-2 * abs(got[0, 0, 0])
    assert abs(got[0, 1, 0] - got[1, 0, 0]) < 5e-2 * abs(got[0, 1, 0])


def _mode_data(pkg, amps):
    mon = pkg.ModeMonitor(center=(0, 0, 0.5), size=(2, 2, 0),
                          freqs=[FREQ0, 1.1 * FREQ0],
                          mode_spec=pkg.ModeSpec(num_modes=2), name="mode")
    coords = dict(direction=["+", "-"], f=[FREQ0, 1.1 * FREQ0],
                  mode_index=[0, 1])
    return {"mode": pkg.ModeData(
        monitor=mon, amps=pkg.ModeAmpsDataArray(amps, coords=coords),
        n_complex=pkg.ModeIndexDataArray(
            np.full((2, 2), 2.0 + 0j),
            coords=dict(f=coords["f"], mode_index=[0, 1])))}


def test_expressions_roundtrip_and_eval(tmp_path):
    import tidy3d_tpu.plugins.expressions.operators  # noqa: F401 (registers)
    from tidy3d_tpu.plugins.expressions import (
        expression_from_dict as ref_from_dict,
    )
    from tidy3d_tpu_torch.plugins.expressions import (
        Expression, ModeAmp, ModePower,
    )

    amps = np.random.default_rng(5).standard_normal((2, 2, 2, 2)) @ [1, 1j]
    data = _mode_data(td, amps)
    expr = 2.0 * ModePower(monitor_name="mode", mode_index=0, f=FREQ0) + 0.5
    val = expr(data)
    assert val == pytest.approx(2.0 * abs(amps[0, 0, 0]) ** 2 + 0.5)
    fname = str(tmp_path / "objective.json")
    expr.to_file(fname)
    assert type(expr).from_file(fname)(data) == pytest.approx(val)
    # the same expression in the reference, on the same amplitudes
    ref = ref_from_dict(json.loads(expr.json()))
    assert type(ref).__module__.startswith("tidy3d_tpu.")
    assert ref(_mode_data(tidy3d_tpu, amps)) == pytest.approx(val, rel=1e-12)
    amp = ModeAmp(monitor_name="mode", mode_index=1, f=FREQ0)(data)
    assert np.iscomplexobj(amp) and amp == amps[0, 0, 1]
    assert isinstance(expr, Expression)


def test_design_space_grid_and_mc():
    import tidy3d_tpu.plugins.design as ref_design
    import tidy3d_tpu_torch.plugins.design as port_design

    results = []
    for mod in (port_design, ref_design):
        params = (mod.ParameterFloat(name="a", span=(0.0, 1.0), num_points=3),
                  mod.ParameterFloat(name="b", span=(2.0, 4.0), num_points=2))
        grid = mod.DesignSpace(parameters=params, method=mod.MethodGrid())
        mc = mod.DesignSpace(parameters=params,
                             method=mod.MethodMonteCarlo(num_points=7))
        results.append((grid.run(lambda a, b: a * 10 + b),
                        mc.run(lambda a, b: a + b)))
    for got, want in zip(*results):
        assert got.coords == want.coords and got.values == want.values
    grid, mc = results[0]
    assert len(grid.values) == 6 and len(mc.values) == 7
    for coords, val in zip(grid.coords, grid.values):
        assert val == pytest.approx(coords[0] * 10 + coords[1])
    for coords in mc.coords:
        assert 0.0 <= coords[0] <= 1.0 and 2.0 <= coords[1] <= 4.0


def test_design_run_batch_on_the_named_device():
    """``run_batch(..., device="cpu")`` runs the port's ``Batch`` on the
    CPU; its flux equals the reference batch's within 2e-5."""
    import tidy3d_tpu.plugins.design as ref_design
    import tidy3d_tpu_torch.plugins.design as port_design

    flux = td.FluxMonitor(center=(0, 0, 0), size=(0.3, 0.25, 0.4),
                          freqs=[FREQ0], name="flux")

    def pre(run_time):
        return SIMS["pml_all"](monitors=[flux], run_time=run_time)

    out = []
    for mod, kw, wrap in ((port_design, dict(device="cpu"), lambda s: s),
                          (ref_design, {}, to_reference)):
        space = mod.DesignSpace(
            parameters=(mod.ParameterFloat(name="run_time",
                                           span=(4e-15, 6e-15),
                                           num_points=2),),
            method=mod.MethodGrid(), task_name="sweep")
        out.append(space.run_batch(
            lambda run_time: wrap(pre(run_time)),
            lambda sim_data: complex(sim_data["flux"].flux.values[0]),
            **kw))
    got, want = (np.asarray(r.values) for r in out)
    assert out[0].coords == out[1].coords
    assert np.max(np.abs(got - want)) <= 2e-5 * np.max(np.abs(want))


def test_resonance_finder_synthetic():
    from tidy3d_tpu.plugins.resonance import ResonanceFinder as Ref
    from tidy3d_tpu_torch.plugins.resonance import ResonanceFinder

    dt = 1e-16
    t = np.arange(2000) * dt
    f1, d1, f2, d2 = 2.0e14, 2e11, 2.5e14, 8e11
    sig = (np.cos(2 * np.pi * f1 * t) * np.exp(-d1 * t)
           + 0.4 * np.cos(2 * np.pi * f2 * t + 0.7) * np.exp(-d2 * t))
    finder = ResonanceFinder(freq_window=(1.5e14, 3e14))
    got = finder.run_raw_signal(sig, dt)
    want = Ref.parse_raw(finder.json()).run_raw_signal(sig, dt)
    assert _rel(got.coords["freq"], want.coords["freq"]) <= TOL_EXACT
    assert _rel(got.values, want.values) <= TOL_EXACT
    freqs, decays = np.asarray(got.coords["freq"]), got.values[:, 0]
    for f_true, d_true in ((f1, d1), (f2, d2)):
        i = np.argmin(np.abs(freqs - f_true))
        assert abs(freqs[i] - f_true) / f_true < 1e-4
        assert abs(decays[i] - d_true) / d_true < 0.05


def test_polyslab_plugin_imports():
    from tidy3d_tpu_torch.components.geometry.polyslab import (
        ComplexPolySlabBase,
    )
    from tidy3d_tpu_torch.plugins.polyslab import ComplexPolySlab

    assert issubclass(ComplexPolySlab, ComplexPolySlabBase)
    assert ComplexPolySlab.__module__ == \
        "tidy3d_tpu_torch.plugins.polyslab.polyslab"
