"""The EME solver of the port against the JAX package's.

``solver/eme.py`` and ``components/eme/`` are copies of the JAX package's;
the cells' mode solves are the port's ``ModeSolver`` inside
``device_solver.solve_on(device)`` (here ``device="cpu"``: the planes are
small, so ``auto`` takes the host solver in both packages). Each of the six
cases of ``tests/test_solver/test_eme.py`` is built in the port, carried to
the JAX package through its JSON and solved by both ``run_eme``s: the
S-matrix, ``n_complex`` and every EME monitor's data equal within ``TOL``
of the largest magnitude of each array, and the case's physics check on
the port's data.
"""

import numpy as np
import pytest

# first: where h5py is missing it makes the JAX package importable
import tests.torch_cases  # noqa: F401
import tidy3d_tpu
from tidy3d_tpu.solver.eme import run_eme as ref_run_eme

import tidy3d_tpu_torch as td
from tidy3d_tpu_torch.constants import C_0
from tidy3d_tpu_torch.plugins.mode import device_solver
from tidy3d_tpu_torch.solver import eme as port_eme

TOL = 1e-6      # of the largest magnitude of each array
FREQ0 = C_0 / 1.55
SI = td.Medium(permittivity=12.25)
OX = td.Medium(permittivity=2.25)


def _guide(width=0.4, center=(0, 0, 0), length=td.inf):
    return td.Structure(geometry=td.Box(center=center,
                                        size=(length, width, td.inf)),
                        medium=SI)


def _eme_sim(structures, length=6.0, num_cells=3, num_modes=2, **kw):
    return td.EMESimulation(
        center=(0, 0, 0), size=(length, 4, 0), axis=0, freqs=[FREQ0],
        medium=OX, structures=structures,
        eme_grid_spec=td.EMEUniformGrid(
            num_cells=num_cells,
            mode_spec=td.EMEModeSpec(num_modes=num_modes, target_neff=3.0)),
        grid_spec=td.GridSpec.uniform(dl=0.04), **kw)


def uniform_guide():
    return _eme_sim([_guide()])


def step_junction():
    return _eme_sim([_guide(0.4, (-1.5, 0, 0), 3), _guide(0.8, (1.5, 0, 0), 3)],
                    num_cells=2, num_modes=3)


def length_sweep():
    return _eme_sim([_guide()], length=2.0, num_cells=1, num_modes=1,
                    sweep_spec=td.EMELengthSweep(scale_factors=[1.0, 2.0]))


def mode_sweep():
    return _eme_sim([_guide()], length=2.0, num_cells=1, num_modes=2,
                    sweep_spec=td.EMEModeSweep(num_modes=[1, 2]))


def freq_sweep():
    return _eme_sim([_guide()], length=2.0, num_cells=1, num_modes=1,
                    sweep_spec=td.EMEFreqSweep(freq_scale_factors=[1.0, 1.02]))


def monitors():
    return _eme_sim([_guide()], monitors=[
        td.EMEFieldMonitor(center=(0.7, 0, 0), size=(0, td.inf, td.inf),
                           name="field"),
        td.EMECoefficientMonitor(center=(0, 0, 0),
                                 size=(td.inf, td.inf, td.inf),
                                 name="coeffs"),
        td.EMEModeSolverMonitor(center=(0, 0, 0),
                                size=(td.inf, td.inf, td.inf),
                                name="modes")])


CASES = {f.__name__: f for f in (uniform_guide, step_junction, length_sweep,
                                 mode_sweep, freq_sweep, monitors)}


def _assert_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want))) / scale if scale else \
        float(np.max(np.abs(got)))
    assert err <= TOL, (what, err)
    return err


def _dataset_arrays(obj) -> dict:
    """The data arrays of an EME dataset or monitor data, by field name."""
    out = {}
    for name in type(obj).model_fields:
        value = getattr(obj, name)
        if hasattr(value, "values") and hasattr(value, "coords"):
            out[name] = value
    return out


def to_reference(sim):
    """The JAX package's ``EMESimulation`` equal to the port's ``sim``.
    ``EMESimulation.monitors`` is an untyped tuple in both packages, so a
    parsed one holds dicts (the same gap as ``Medium.modulation_spec``,
    ``tests/torch_cases.to_reference``): each is rebuilt as the
    reference's monitor of its ``type``."""
    ref = tidy3d_tpu.EMESimulation.parse_raw(sim.json())
    return ref.copy(update=dict(monitors=tuple(
        getattr(tidy3d_tpu, m["type"]).parse_obj(m) if isinstance(m, dict)
        else m for m in ref.monitors)))


def test_parsed_eme_monitors_are_dicts_in_both_packages():
    """The gap ``to_reference`` mends is the reference's own."""
    sim = CASES["monitors"]()
    for pkg in (td, tidy3d_tpu):
        parsed = pkg.EMESimulation.parse_raw(sim.json())
        assert all(isinstance(m, dict) for m in parsed.monitors)
    assert isinstance(to_reference(sim).monitors[0],
                      tidy3d_tpu.EMEFieldMonitor)


def _solve(case):
    sim = CASES[case]()
    ref_sim = to_reference(sim)
    assert type(ref_sim).__module__.startswith("tidy3d_tpu.")
    return sim, port_eme.run_eme(sim, device="cpu"), ref_run_eme(ref_sim)


@pytest.mark.parametrize("case", sorted(CASES))
def test_eme_matches_the_reference(case):
    sim, got, want = _solve(case)
    assert type(got).__module__.startswith("tidy3d_tpu_torch.")
    assert len(port_eme.CELL_SECONDS) == len(sim.cell_centers)
    for name in ("S11", "S12", "S21", "S22"):
        _assert_close(getattr(got.smatrix, name).values,
                      getattr(want.smatrix, name).values, name)
    _assert_close(got.n_complex.values, want.n_complex.values, "n_complex")
    assert [d.monitor.name for d in got.data] == \
        [d.monitor.name for d in want.data]
    for g, w in zip(got.data, want.data):
        arrays = _dataset_arrays(w)
        assert arrays and arrays.keys() == _dataset_arrays(g).keys()
        for name, arr in arrays.items():
            _assert_close(getattr(g, name).values, arr.values,
                          f"{w.monitor.name}.{name}")
    for g, w in zip(got.port_modes_tuple, want.port_modes_tuple):
        _assert_close(g.n_complex.values, w.n_complex.values, "port n")
    s21 = np.asarray(got.smatrix.S21.values)[0, 0]
    if case == "uniform_guide":
        assert np.allclose(np.abs(np.diag(s21)), 1.0, atol=1e-3)
    if case == "step_junction":
        s11 = np.asarray(got.smatrix.S11.values)[0, 0]
        p = np.abs(s21[:, 0]) ** 2 + np.abs(s11[:, 0]) ** 2
        assert np.abs(s21[:, 0]).sum() > 0 and p.sum() < 1.0 + 1e-6


def test_eme_basis_tools_match_the_reference():
    """``smatrix_in_basis`` and ``field_in_basis`` with the port modes as
    the new basis, in both packages."""
    _, got, want = _solve("monitors")
    results = []
    for data in (got, want):
        pm1, pm2 = data.port_modes_tuple
        s_new = data.smatrix_in_basis(modes1=pm1, modes2=pm2)
        f_new = data.field_in_basis(data["field"], modes=pm1, port_index=0)
        results.append((s_new.S21.values, f_new.Ez.values))
    _assert_close(results[0][0], results[1][0], "S21 in basis")
    _assert_close(results[0][1], results[1][1], "Ez in basis")


def test_run_eme_solves_on_the_named_device(monkeypatch):
    """The cells' solves run inside ``solve_on(device)``: a forced filter
    with the CPU named runs the device filter on the CPU, one solve a
    cell, on a 3D strip of 20 x 16 cell planes; with no device named the
    scope's device is taken."""
    monkeypatch.setenv("TIDY3D_TPU_MODE_SOLVER", "filter")
    sim = td.EMESimulation(
        center=(0, 0, 0), size=(2.0, 2.0, 1.6), axis=0, freqs=[FREQ0],
        medium=OX, structures=[td.Structure(geometry=td.Box(
            center=(0, 0, 0), size=(td.inf, 0.5, 0.3)), medium=SI)],
        eme_grid_spec=td.EMEUniformGrid(
            num_cells=2, mode_spec=td.EMEModeSpec(num_modes=1)),
        grid_spec=td.GridSpec.uniform(dl=0.1))
    solves = device_solver.SOLVES
    port_eme.run_eme(sim, device="cpu")
    assert device_solver.SOLVES == solves + len(sim.cell_centers)
    assert device_solver.RECORDS[-1]["device"] == "cpu"
    with device_solver.solve_on("cpu"):
        port_eme.run_eme(sim)
    assert device_solver.RECORDS[-1]["device"] == "cpu"
