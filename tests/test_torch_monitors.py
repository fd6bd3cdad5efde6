"""The monitor data of ``tidy3d_tpu_torch.web.run`` against
``tidy3d_tpu.web.run``, and the port's memory gate and profiler.

Mode amplitudes and ``n_complex``, the ``ModeSolverData`` fields, the
permittivity plane, the diffraction amplitudes, the projected ``Etheta``,
``Ephi`` and ``Er`` of the three projection monitors, and the flux: the JAX
package runs its CPU XLA path, the port its plain path with
``device="cpu"`` (the ``fused`` tier, every-step DFT, like the reference):
each array within ``TOL`` = 2e-5 of its largest magnitude (the bar of
``tests/test_torch_web.py``). A Bloch run takes the kstep tier, whose DFT
is Nyquist-strided: its data are held to the JAX package's builders on the
raw monitors of its XLA runner fed the same strided tables, to ``TOL``. The
kstep tier's data on the real cases are held to the port's own ``fused``
run at ``TOL_STRIDED`` = 2e-2 (a strided DFT against an every-step one,
the bar of ``tests/test_torch_kstep.py``), on runs long enough for the
pulse to pass. Sharded runs (``TIDY3D_TPU_SHARD=4,1,1``, virtual shards)
equal the unsharded kstep run bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch.exceptions import SetupError
from tidy3d_tpu_torch.plugins.mode import device_solver
from tidy3d_tpu_torch.solver import fdtd as port_fdtd
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.lowering import lower
from tidy3d_tpu_torch.solver.sharding import ShardingPlan, make_mesh

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    DISPERSIVE, DL, MONITOR_CASES, SIMS, lower_reference, monitors,
    to_reference,
)
from tests.test_torch_bloch import _jax_strided
from tidy3d_tpu import web as ref_web
from tidy3d_tpu.web.run import assemble_sim_data as ref_assemble

TOL = 2e-5            # every-step DFT on both sides, the reference's bar
TOL_STRIDED = 2e-2    # the kstep tier's strided DFT against every-step
NAMES = ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz", "flux", "amps", "n_complex",
         "Etheta", "Ephi", "Er", "eps_xx", "eps_yy", "eps_zz")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    for key in ("TIDY3D_TPU_KSTEP", "TIDY3D_TPU_SHARD", "TIDY3D_TPU_PROFILE",
                "TIDY3D_TPU_HBM_BYTES", "TIDY3D_TPU_MEM_CHECK"):
        monkeypatch.delenv(key, raising=False)
    # the mode solves of a bare lower() (mode sources) on the CPU too, as
    # web.run(device="cpu") runs its own
    with device_solver.solve_on("cpu"):
        yield


def _values(data) -> dict:
    """Every array of every monitor's data, with its coordinates."""
    out = {}
    for mon in data.simulation.monitors:
        md = data[mon.name]
        for name in NAMES:
            arr = getattr(md, name, None)
            if arr is not None:
                out[f"{mon.name}.{name}"] = (
                    np.asarray(arr.values),
                    {d: np.asarray(arr.coords[d]) for d in arr.dims})
    return out


def _compare(ref: dict, got: dict, tol: float, coords: bool = True):
    assert set(got) == set(ref), (sorted(ref), sorted(got))
    for key, (r, rc) in ref.items():
        g, gc = got[key]
        assert g.shape == r.shape, (key, g.shape, r.shape)
        assert np.all(np.isfinite(g)), key
        if coords:
            for d in rc:
                if rc[d].dtype.kind in "fc":
                    assert np.allclose(gc[d], rc[d], rtol=1e-12, atol=0), \
                        (key, d)
                else:
                    assert np.array_equal(gc[d], rc[d]), (key, d)
        scale = float(np.max(np.abs(r)))
        if scale == 0:
            assert np.all(g == 0), key
            continue
        err = float(np.max(np.abs(g - r))) / scale
        assert err <= tol, f"{key}: rel err {err:.2e} (tol {tol:g})"


def _dft_monitors():
    """``monitors()`` but the time monitor, whose samples do not land on
    the ends of 2-step groups."""
    return [m for m in monitors() if m.name != "time"]


def _port(sim, **kw):
    return tt.web.run(sim, device="cpu", verbose=False, **kw)


@pytest.mark.parametrize("case", ["waveguide", "projection", "diffraction"])
def test_builders_match_reference(case):
    """Every builder's data against the JAX package's ``web.run``."""
    sim = MONITOR_CASES[case]()
    ref = _values(ref_web.run(to_reference(sim), verbose=False))
    got_data = _port(sim)
    assert "kernel tier: fused" in got_data.log
    got = _values(got_data)
    want = {"waveguide": {"mode.amps", "mode.n_complex", "modes.Ey",
                          "modes.n_complex", "flux.flux", "eps.eps_xx"},
            "projection": {"angle.Etheta", "cartesian.Ephi", "kspace.Etheta"},
            "diffraction": {"diff.amps", "diff_r.amps"}}[case]
    assert want <= set(got)
    # the data are not trivially zero
    for key in want:
        assert np.any(got[key][0] != 0), key
    _compare(ref, got, TOL)


def test_mode_amplitudes_both_directions():
    """The mode source launches mode 0 forward: its '+' amplitude dominates
    its '-' amplitude and mode 1's, and carries no more power than the flux
    through the plane (modes of unit power). The strip is 3 x 5 cells, so
    a tenth of the amplitude leaks back and part of the flux is not in the
    mode; the card holds the full-width case to 5 % and 1e-2."""
    data = _port(MONITOR_CASES["waveguide"](run_time=4e-14))
    amps = data["mode"].amps

    def amp(direction, mode):
        return np.abs(amps.sel(direction=direction, mode_index=mode).values)

    fwd = amp("+", 0)
    assert np.all(amp("-", 0) < 0.2 * fwd) and np.all(amp("+", 1) < 0.05 * fwd)
    flux = np.asarray(data["flux"].flux.values)
    assert np.all(fwd ** 2 <= 1.05 * flux) and np.all(fwd ** 2 > 0.5 * flux)


def test_permittivity_is_the_plans():
    """The permittivity plane is ``plan.eps_yee`` on the monitor's cells,
    and no tier or shard allocates an accumulator for its plan."""
    sim = MONITOR_CASES["waveguide"]()
    plan = lower(sim)
    data = _port(sim)
    idx = next(i for i, mp in enumerate(plan.monitors)
               if mp.kind == "permittivity")
    mp = plan.monitors[idx]
    for comp in ("Ex", "Ey", "Ez"):
        arr = getattr(data["eps"], f"eps_{comp[1]}{comp[1]}")
        eps = np.broadcast_to(plan.eps_yee[comp], plan.shape)[mp.slices[comp]]
        assert np.array_equal(arr.values[..., 0], eps.astype(np.complex64))
    eps_xx = data["eps"].eps_xx.values
    assert np.any(eps_xx != eps_xx.flat[0])
    for kernel in ("kstep", "fused", "pallas2"):
        runner = FDTDRunner(plan, device="cpu", kernel=kernel)
        assert runner.init_state()["mon"][idx] == {}
        assert runner.run()[idx] == {}
    sharded = FDTDRunner(lower(_sized(sim, 24)), device="cpu",
                         sharding_plan=_shards(24, 4))
    assert all(st["mon"][idx] == {} for st in sharded.init_state()["shards"])


def test_bloch_diffraction_matches_reference_builders():
    """A diffraction plane in a Bloch run (the two-copy kstep tier, the raw
    DFT complex): the JAX package's builders on the raw data of its XLA
    runner fed the same strided tables give the same amplitudes."""
    sim = MONITOR_CASES["diffraction_bloch"]()
    plan = lower_reference(sim)
    jr = _jax_strided(plan)
    ref = _values(ref_assemble(to_reference(sim), plan, jr.run(), jr))
    got_data = _port(sim)
    assert "kernel tier: kstep (k=2)" in got_data.log
    got = _values(got_data)
    assert np.any(got["diff.amps"][0] != 0)
    _compare(ref, got, TOL)


@pytest.mark.parametrize("case", ["waveguide", "projection", "diffraction"])
def test_kstep_matches_fused(case, monkeypatch):
    """The kstep tier's data against the port's every-step ``fused`` run,
    the pulse gone from the monitors by the end."""
    sim = MONITOR_CASES[case](run_time=6e-14)
    ref = _values(_port(sim))
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "kstep")
    got_data = _port(sim)
    assert "kernel tier: kstep (k=2)" in got_data.log
    got = _values(got_data)
    # the mode solver's own data do not depend on the run
    _compare({k: v for k, v in ref.items() if not k.startswith("modes.")},
             {k: v for k, v in got.items() if not k.startswith("modes.")},
             TOL_STRIDED)


def _sized(sim, nx: int):
    """``sim`` with its x size grown so that the grid has ``nx`` x planes
    (the PML included)."""
    for n in range(int(round(sim.size[0] / DL)), 4 * nx):
        new = sim.copy(update=dict(
            size=(round(n * DL, 9),) + tuple(sim.size[1:])))
        if lower(new).shape[0] == nx:
            return new
    raise ValueError(f"no x size gives {nx} planes")


def _shards(nx: int, n: int) -> ShardingPlan:
    mesh, _ = make_mesh(devices=["cpu"] * n)
    return ShardingPlan(mesh, (nx, 1, 1))


@pytest.mark.parametrize("case", ["waveguide", "projection"])
def test_sharded_equals_unsharded(case, monkeypatch):
    """``web.run`` over 4 virtual x-shards (24 planes, 6 a shard) equals the
    unsharded kstep run bit for bit."""
    sim = _sized(MONITOR_CASES[case](), 24)
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "kstep")
    ref = _values(_port(sim))
    monkeypatch.setenv("TIDY3D_TPU_SHARD", "4,1,1")
    got_data = _port(sim)
    assert "kernel tier: kstep (k=2, 4 x-shards)" in got_data.log
    got = _values(got_data)
    assert set(got) == set(ref)
    for key, (r, _) in ref.items():
        assert np.array_equal(got[key][0], r), key


# --------------------------------------------------------------------------- #
# the memory gate
# --------------------------------------------------------------------------- #


def _tensor_bytes(obj) -> int:
    return port_fdtd._nbytes(obj)


@pytest.mark.parametrize("kernel", ["kstep", "fused", "pallas2"])
def test_memory_estimate_counts_the_state(kernel):
    """The components add up; the state is every array ``init_state``
    allocates, the kstep tier's ping-pong set included, and on the one-step
    tiers the E, H and psi of the next step beside it; the constants are
    the tensors the runner holds."""
    plan = lower(DISPERSIVE["lorentz_mixed"](monitors=_dft_monitors()))
    runner = FDTDRunner(plan, device="cpu", kernel=kernel)
    est = runner.estimate_device_memory()
    keys = ("consts", "state", "halo", "work", "margin")
    assert est["total"] == sum(est[k] for k in keys)
    assert est["device"] == "cpu" and set(est["devices"]) == {"cpu"}
    state = runner.init_state()
    want = _tensor_bytes(state)
    if kernel == "kstep":
        assert "alt" in state and _tensor_bytes(state["alt"]) > 0
    else:
        want += _tensor_bytes([state["E"], state["H"], state["psi"]])
    assert est["state"] == want and est["halo"] == 0
    cells = int(np.prod(plan.shape))
    assert est["work"] >= 4 * cells
    assert est["consts"] == _tensor_bytes(
        [runner.consts, runner._sources]
        + ([runner.tables.boxes, runner.tables.terms, runner.tables.wf]
           if runner.tables is not None else []))
    assert est["margin"] == est["state"] // 2 + port_fdtd.MARGIN_BYTES


def test_memory_estimate_per_device_on_virtual_shards():
    """Four virtual shards of one device all count on it: the state and
    halo are every array of every shard, the halo the 2k padded planes of
    the x-spanning ones, and the total exceeds the unsharded run's."""
    sim = _sized(DISPERSIVE["lorentz_mixed"](monitors=_dft_monitors()), 24)
    plan = lower(sim)
    sharded = FDTDRunner(plan, device="cpu", sharding_plan=_shards(24, 4))
    unsharded = FDTDRunner(plan, device="cpu", kernel="kstep")
    est = sharded.estimate_device_memory()
    assert set(est["devices"]) == {"cpu"}
    shards = sharded.init_state()["shards"]
    assert est["state"] + est["halo"] == _tensor_bytes(shards)
    padded, k = sharded.layout.padded, sharded.k
    halo = sum(t.numel() * 4 * 2 * k // padded
               for _, t in port_fdtd._named(shards, skip=())
               if t.ndim == 3 and t.shape[0] == padded)
    assert est["halo"] == halo > 0
    assert est["consts"] == _tensor_bytes(
        [sharded._sources] + [[sh.consts, sh.tables.boxes, sh.tables.terms,
                               sh.tables.wf] for sh in sharded.shards])
    base = unsharded.estimate_device_memory()
    assert est["state"] + est["halo"] > base["state"]
    assert est["total"] > base["total"]


def test_check_memory_budget(monkeypatch):
    """A limit below the estimate raises ``SetupError`` with the
    breakdown; ``TIDY3D_TPU_MEM_CHECK=0`` turns the check off; without a
    limit the CPU is not checked."""
    plan = lower(SIMS["pml_all"](monitors=monitors()))
    runner = FDTDRunner(plan, device="cpu")
    est = runner.check_memory_budget()
    assert est["total"] > 0
    monkeypatch.setenv("TIDY3D_TPU_HBM_BYTES", str(est["total"] - 1))
    with pytest.raises(SetupError, match="constants .* state .* margin"):
        runner.check_memory_budget()
    monkeypatch.setenv("TIDY3D_TPU_HBM_BYTES", str(est["total"]))
    assert runner.check_memory_budget()["total"] == est["total"]
    monkeypatch.setenv("TIDY3D_TPU_HBM_BYTES", "1e6")
    monkeypatch.setenv("TIDY3D_TPU_MEM_CHECK", "0")
    assert runner.check_memory_budget() is None


def test_web_run_gate_refuses_before_the_loop(monkeypatch):
    """``web.run`` raises ``SetupError`` under a tiny limit before any
    step is taken."""
    def no_step(*args, **kwargs):
        raise AssertionError("a step ran past the memory gate")

    monkeypatch.setattr(FDTDRunner, "run_steps", no_step)
    monkeypatch.setenv("TIDY3D_TPU_HBM_BYTES", "1e6")
    with pytest.raises(SetupError, match="device limit is"):
        _port(SIMS["pml_all"](monitors=monitors()))


def test_web_run_logs_memory_and_host_seconds():
    data = _port(MONITOR_CASES["waveguide"]())
    lines = data.log.splitlines()
    assert lines[-1] == (
        "kernel tier: fused"
        " [storage: fields float32, psi float32, Q float32]")
    mem = next(line for line in lines if line.startswith("device memory:"))
    assert "peak 0 B" in mem and "on cpu" in mem
    host = next(line for line in lines
                if line.startswith("monitor data host seconds:"))
    for name in ("mode", "modes", "flux", "eps"):
        assert f"{name} " in host


# --------------------------------------------------------------------------- #
# the profiler
# --------------------------------------------------------------------------- #


def test_maybe_profile_writes_a_trace(tmp_path, monkeypatch):
    """``TIDY3D_TPU_PROFILE`` writes a Chrome trace of the run that holds
    the runner's ``fdtd.monitors`` range."""
    monkeypatch.setenv("TIDY3D_TPU_PROFILE", str(tmp_path))
    _port(SIMS["pml_all"](monitors=monitors()[:2], run_time=5e-15))
    traces = list(tmp_path.glob("tidy3d_tpu_torch_*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "fdtd.monitors" in names


def test_no_trace_without_the_variable(tmp_path, monkeypatch):
    from tidy3d_tpu_torch.solver.profiling import maybe_profile

    monkeypatch.chdir(tmp_path)
    with maybe_profile(torch.device("cpu")) as path:
        assert path is None
    assert not os.listdir(tmp_path)
