"""Bloch (complex) runs of the port against the JAX package.

A complex run steps two real copies of the fields, re and im, on the kstep
tier only. Checked here on the CPU: one group of ``kstep_group_reference``
from a random two-copy state against two calls of the JAX runner's XLA
``_step`` (to 2e-5 of the largest magnitude over both copies, the
reference's own bar); the source terms of both copies against the JAX
runner's per-plan injection; whole runs against the JAX XLA runner fed the
same strided DFT tables (raw monitors to 2e-5 in both quadratures); the
``SimulationData`` of ``web.run`` against the JAX package's builders on the
same raw data; the tier choice and the refusals.

The kernel-against-plain tests at the end need a CUDA card and skip without
one.
"""

import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch import convert
from tidy3d_tpu_torch.solver import fdtd as port_fdtd
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.kernels import kstep as kstep_kernels

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    BLOCH, DRUDE, FREQ0, lower_reference as lower, max_rel_err, random_state,
    to_reference,
)
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner
from tidy3d_tpu.web.run import assemble_sim_data as ref_assemble

TOL = 2e-5          # the reference's own bar (tests/test_solver/test_kstep.py)
TOL_KERNEL = 1e-6   # kernel against plain version, float32 rounding
T0 = 36             # a group inside the source pulse
K = 2


@pytest.fixture(autouse=True)
def _auto(monkeypatch):
    # ``auto``: the JAX package takes its XLA path on the CPU, the port its
    # kstep tier (``xla`` names the port's two-phase tier, which refuses a
    # complex run)
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    monkeypatch.delenv("TIDY3D_TPU_KSTEP", raising=False)


def _monitors(dt):
    """A field plane, a flux box and field- and flux-time monitors whose
    samples land on the ends of 2-step groups."""
    freqs = list(np.linspace(0.9 * FREQ0, 1.1 * FREQ0, 3))
    start = 2.5 * dt            # first sample: step 3
    return [
        tt.FieldMonitor(center=(0, 0, 0.05), size=(0.4, 0.3, 0),
                        freqs=freqs, name="field"),
        tt.FluxMonitor(center=(0, 0, 0), size=(0.3, 0.25, 0.4),
                       freqs=freqs, name="flux"),
        tt.FieldTimeMonitor(center=(0, 0, 0), size=(0.2, 0.2, 0.2),
                            start=start, interval=4, name="time"),
        tt.FluxTimeMonitor(center=(0, 0, 0), size=(0.3, 0.25, 0.4),
                           start=start, interval=4, name="flux_t"),
    ]


def _sim(case, run_time=2e-14):
    dt = lower(BLOCH[case]()).dt
    return BLOCH[case](monitors=_monitors(dt), run_time=run_time)


def _complex_state(port, seed):
    """A random two-copy state in the reference's layout (copy 1 under
    ``E1``, ``H1``, ``psi1``; no pole currents)."""
    rng = np.random.default_rng(seed)
    st = random_state(rng, port.shape, port.psi_shapes())
    im = random_state(rng, port.shape, port.psi_shapes())
    return dict(st, E1=im["E"], H1=im["H"], psi1=im["psi"], Q1=[])


def _by_family(state: dict) -> dict:
    """Both copies of each of E, H and psi in one dict per family, so that
    an error is relative to the largest magnitude over both copies."""
    out = {}
    for fam in ("E", "H", "psi"):
        out[fam] = {f"{c}:{key}": np.asarray(v)
                    for c, name in enumerate((fam, fam + "1"))
                    for key, v in state[name].items()}
    return out


def _check(ref: dict, got: dict, tol: float, what: str):
    ref, got = _by_family(ref), _by_family(got)
    for fam in ref:
        if not ref[fam]:
            continue
        assert set(ref[fam]) == set(got[fam]), f"{what} {fam}: keys differ"
        err = max_rel_err(ref[fam], got[fam])
        assert err <= tol, f"{what} {fam}: rel err {err:.2e}"


@functools.lru_cache(maxsize=None)
def _jax_step_fn(case):
    plan = lower(BLOCH[case]())
    jr = JaxRunner(plan)
    assert jr.kstep is None and jr.is_complex    # the XLA path
    return plan, jr, jax.jit(lambda s, c, t: jr._step(t, s, c))


def test_cases_are_complex_and_cover_the_wraps():
    """Every case steps two copies; between them they wrap across x, y and
    z Bloch walls and carry complex (re, im) source plan pairs."""
    axes, pairs = set(), 0
    for case in BLOCH:
        plan = lower(BLOCH[case]())
        assert plan.is_complex and not plan.poles, case
        phases = port_fdtd.bloch_phases(plan)
        axes.update(a for a, cs in enumerate(phases) if cs is not None)
        pairs += sum(i_im is not None for _, i_im in
                     kstep_kernels.group_source_plans(plan.sources, True))
    assert axes == {0, 1} and pairs > 0


@pytest.mark.parametrize("case", sorted(BLOCH))
def test_kstep_group_matches_xla_steps(case):
    plan, jr, fn = _jax_step_fn(case)
    port = FDTDRunner(plan, device="cpu")
    assert port.tier == "kstep" and port.k == K and port.is_complex
    assert port._waveforms[:, T0:T0 + K].any(), "source off in the group"
    st = _complex_state(port, 29)
    consts = jax.device_put(jr.consts)
    s = jax.device_put(dict(st, mon=[]))
    for t in range(T0, T0 + K):
        s = fn(s, consts, t)
    ref = jax.device_get(s)
    state = convert.state_from_reference(st, port)
    before = kstep_kernels.LAUNCHES
    got = kstep_kernels.kstep_group(state, port.consts, port.meta,
                                    port.tables, T0, K)
    assert kstep_kernels.LAUNCHES == before
    assert set(got) == {"E", "H", "psi", "E1", "H1", "psi1", "Q"}
    _check(ref, convert.state_to_reference(got), TOL, f"{case} group")


@pytest.mark.parametrize("case", sorted(BLOCH))
def test_source_terms_match_xla_injection(case):
    """Each (re, im) plan pair of lowering becomes one complex term (the
    grouping of ``pallas_kstep.py:1050-1066``), and what the two copies add
    at a step equals the JAX runner's per-plan injection of each copy."""
    plan, jr, _ = _jax_step_fn(case)
    port = FDTDRunner(plan, device="cpu")
    groups = kstep_kernels.group_source_plans(plan.sources, True)
    assert sorted(i for g in groups for i in g if i is not None) == \
        list(range(len(plan.sources)))
    for i_re, i_im in groups:
        if i_im is not None:
            re, im = plan.sources[i_re], plan.sources[i_im]
            assert (re.comp, re.slices) == (im.comp, im.slices)
            assert im.waveform_key_im == re.waveform_key
    # a real run keeps one term per plan
    assert all(i_im is None for _, i_im in
               kstep_kernels.group_source_plans(plan.sources, False))
    for fam in ("E", "H"):
        for t in (T0, T0 + 7):
            want = [{}, {}]
            for part in range(2):
                for sp, delta in jr._source_deltas(fam, jr.consts, t, part):
                    arr = want[part].setdefault(
                        sp.comp, np.zeros(plan.shape, np.float32))
                    arr[sp.slices] += np.asarray(delta)
            got = [{}, {}]
            for comp, sl, *adds in port.tables.copy_adds(fam, t):
                for part in range(2):
                    arr = got[part].setdefault(
                        comp, np.zeros(plan.shape, np.float32))
                    arr[sl] += adds[part].numpy()
            for part in range(2):
                assert set(got[part]) == set(want[part])
                if want[part]:
                    err = max_rel_err(want[part], got[part])
                    assert err <= 1e-6, f"{fam} copy {part}: {err:.2e}"


def _jax_strided(plan):
    """A JAX XLA runner whose DFT tables and group stride are those of the
    k-step tier (its ``kstep`` is a stand-in holding k while they are
    built, and None again afterwards, so it steps on the XLA path)."""
    jr = JaxRunner(plan)
    assert jr.kstep is None                      # the XLA path
    jr.kstep = SimpleNamespace(k=K)
    jr._build_dft_tables()
    jr.kstep = None
    return jr


def _check_raw(ref: dict, got: dict):
    assert set(got) == set(ref)
    for idx in ref:
        assert set(got[idx]) == set(ref[idx])
        for part in (np.real, np.imag):
            scale = max(float(np.max(np.abs(v))) for v in ref[idx].values())
            err = max(float(np.max(np.abs(part(ref[idx][c]) -
                                          part(got[idx][c]))))
                      for c in ref[idx]) / (scale + 1e-30)
            assert err <= TOL, f"monitor {idx} {part.__name__}: {err:.2e}"


@pytest.mark.parametrize("case", sorted(BLOCH))
def test_runner_matches_xla_with_strided_tables(case):
    plan = lower(_sim(case))
    port = FDTDRunner(plan, device="cpu")
    assert port.tier == "kstep"
    ref = _jax_strided(plan).run()
    got = port.run()
    assert any(np.iscomplexobj(v) and np.any(np.imag(v))
               for mon in got.values() for v in mon.values())
    _check_raw(ref, got)


def _values(data) -> dict:
    """Every array of a SimulationData, keyed by monitor and field."""
    out = {}
    for mon in data.simulation.monitors:
        md = data[mon.name]
        for name in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz", "flux"):
            arr = getattr(md, name, None)
            if arr is not None:
                out[f"{mon.name}.{name}"] = (np.asarray(arr.values),
                                             {d: np.asarray(arr.coords[d])
                                              for d in arr.dims})
    return out


def test_web_run_matches_reference_builders():
    """``web.run`` of the angled plane wave: the field, flux and time
    builders give the same complex ``SimulationData`` as the JAX package's
    builders on the raw data of its XLA runner fed the same strided
    tables."""
    sim = _sim("bloch_planewave")
    ref_sim = to_reference(sim)
    plan = lower(sim)
    jr = _jax_strided(plan)
    ref = _values(ref_assemble(ref_sim, plan, jr.run(), jr))
    got = _values(tt.web.run(sim, device="cpu", verbose=False))
    assert set(got) == set(ref)
    assert {"field.Ez", "flux.flux", "time.Ez", "flux_t.flux"} <= \
        set(ref)
    # the bar of the raw monitors: each E or H array relative to the largest
    # magnitude over that family's components of its monitor
    scale = {}
    for key, (vals, _) in ref.items():
        group = key.split(".")[0] + key.split(".")[1][0]
        scale[group] = max(scale.get(group, 0.0), float(np.max(np.abs(vals))))
    for key, (vals, coords) in ref.items():
        gv, gc = got[key]
        assert gv.shape == vals.shape and set(gc) == set(coords), key
        for d in coords:
            assert np.allclose(gc[d], coords[d], rtol=1e-12, atol=0), key
        group = key.split(".")[0] + key.split(".")[1][0]
        err = float(np.max(np.abs(gv - vals))) / (scale[group] + 1e-30)
        assert err <= TOL, f"{key}: rel err {err:.2e}"
    assert np.iscomplexobj(got["field.Ez"][0])


def test_convert_carries_both_copies():
    plan = lower(BLOCH["bloch_dipole"]())
    port = FDTDRunner(plan, device="cpu")
    st = _complex_state(port, 3)
    state = convert.state_from_reference(st, port)
    assert {"E1", "H1", "psi1"} <= set(state) and state["psi1"]
    back = convert.state_to_reference(state)
    assert back["Q1"] == [] and back["Q"] == []
    for key in ("E", "H", "psi", "E1", "H1", "psi1"):
        for c, v in st[key].items():
            assert np.array_equal(back[key][c], v), (key, c)
    real = FDTDRunner(lower(BLOCH["bloch_dipole"]().copy(update=dict(
        boundary_spec=tt.BoundarySpec(
            x=tt.Boundary.periodic(), y=tt.Boundary.periodic(),
            z=tt.Boundary.pml(num_layers=3))))), device="cpu")
    with pytest.raises(ValueError, match="copies"):
        convert.state_from_reference(st, real)


def test_tier_choice_and_refusals(monkeypatch):
    plan = lower(_sim("bloch_dipole"))
    one = {"E": 1, "H": 0}
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    # the kstep tier on every device: the one-step tiers have no copies
    for device in ("cpu", "cuda"):
        assert port_fdtd.select_tier(plan, one, device) == ("kstep", K)
    for tier in ("fused", "pallas2", "xla"):
        with pytest.raises(ValueError, match="no Bloch copies"):
            port_fdtd.select_tier(plan, one, "cpu", tier)
        monkeypatch.setenv("TIDY3D_TPU_KERNEL", tier)
        with pytest.raises(ValueError, match="no Bloch copies"):
            FDTDRunner(plan, device="cpu")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    # a time monitor off the group ends: kstep refuses, so the run does
    off = lower(BLOCH["bloch_dipole"](monitors=[tt.FieldTimeMonitor(
        center=(0, 0, 0), size=(0.2, 0.2, 0.2), interval=3, name="t")]))
    with pytest.raises(ValueError, match="does not sample at the ends"):
        FDTDRunner(off, device="cpu")
    with pytest.raises(ValueError, match="table takes 64"):
        port_fdtd.select_tier(plan, {"E": 65, "H": 0}, "cpu")
    monkeypatch.setenv("TIDY3D_TPU_KSTEP", "0")
    with pytest.raises(ValueError, match="disables it"):
        FDTDRunner(plan, device="cpu")
    monkeypatch.delenv("TIDY3D_TPU_KSTEP")
    # Bloch with dispersive poles: the JAX package runs it on XLA only
    disp = BLOCH["bloch_dipole"]().copy(update=dict(structures=[
        tt.Structure(geometry=tt.Box(center=(0, 0, 0), size=(0.2,) * 3),
                     medium=DRUDE)]))
    with pytest.raises(NotImplementedError, match="dispersive poles"):
        FDTDRunner(lower(disp), device="cpu")
    with pytest.raises(NotImplementedError, match="dispersive poles"):
        tt.web.run(disp, device="cpu", verbose=False)


def test_a_trivial_phase_stays_periodic():
    """A Bloch axis whose phase is 1 within 1e-12 wraps as a periodic one
    (a full period, bloch_vec = 1); a run with no other phase is real."""
    sim = BLOCH["bloch_dipole"]()
    full = sim.copy(update=dict(boundary_spec=tt.BoundarySpec(
        x=tt.Boundary.bloch(bloch_vec=1.0),
        y=tt.Boundary.bloch(bloch_vec=-0.13),
        z=tt.Boundary.pml(num_layers=3))))
    port = FDTDRunner(lower(full), device="cpu")
    assert port.is_complex and port.meta.bloch[0] is None
    assert port.meta.bloch[1] is not None and port.meta.bloch[2] is None
    real = FDTDRunner(lower(sim.copy(update=dict(
        boundary_spec=tt.BoundarySpec(
            x=tt.Boundary.bloch(bloch_vec=0.0),
            y=tt.Boundary.bloch(bloch_vec=1.0),
            z=tt.Boundary.pml(num_layers=3))))), device="cpu")
    assert not real.is_complex and real.tier == "fused"
    assert real.meta.bloch == (None, None, None)


def test_angled_plane_wave_physics():
    """The JAX package's ``test_angled_plane_wave_bloch`` on the port (2D,
    on the CPU): the angled plane wave injects at unit amplitude, nothing
    goes backward, and its flux is cos(theta) of normal incidence."""
    theta = np.deg2rad(25)
    ly = 4.0
    pw = tt.PlaneWave(
        center=(-1, 0, 0), size=(0, tt.inf, tt.inf), direction="+",
        source_time=tt.GaussianPulse(freq0=FREQ0, fwidth=FREQ0 / 5),
        pol_angle=np.pi / 2, angle_theta=theta)
    bloch = tt.BlochBoundary.from_source(source=pw, domain_size=ly, axis=1)
    mons = [tt.FieldMonitor(center=(1, 0.3, 0), size=(0, 0, 0),
                            freqs=[FREQ0], name="fwd"),
            tt.FieldMonitor(center=(-2, 0.3, 0), size=(0, 0, 0),
                            freqs=[FREQ0], name="bwd"),
            tt.FluxMonitor(center=(1.2, 0, 0), size=(0, tt.inf, tt.inf),
                           freqs=[FREQ0], name="flux")]
    sim = tt.Simulation(
        center=(0, 0, 0), size=(5, ly, 0), run_time=1.5e-13,
        sources=[pw], monitors=mons, shutoff=0.0,
        boundary_spec=tt.BoundarySpec(x=tt.Boundary.pml(),
                                      y=tt.Boundary(minus=bloch, plus=bloch),
                                      z=tt.Boundary.periodic()),
        grid_spec=tt.GridSpec.uniform(dl=0.05))
    assert sim.complex_fields
    data = tt.web.run(sim, device="cpu", verbose=False)
    assert data.log.splitlines()[-1] == (
        "kernel tier: kstep (k=2)"
        " [storage: fields float32, psi float32, Q float32]")
    fwd = np.abs(data["fwd"].Ez.values).max()
    bwd = np.abs(data["bwd"].Ez.values).max()
    assert abs(fwd - 1.0) < 0.01
    assert bwd / fwd < 1e-2
    sim0 = sim.updated_copy(
        sources=[pw.updated_copy(angle_theta=0.0)],
        boundary_spec=tt.BoundarySpec(x=tt.Boundary.pml(),
                                      y=tt.Boundary.periodic(),
                                      z=tt.Boundary.periodic()))
    data0 = tt.web.run(sim0, device="cpu", verbose=False)
    flux = float(np.asarray(data["flux"].flux).ravel()[0])
    flux0 = float(np.asarray(data0["flux"].flux).ravel()[0])
    assert abs(flux / flux0 - np.cos(theta)) < 0.01


def test_decay_reads_both_copies():
    plan = lower(BLOCH["bloch_dipole"]())
    port = FDTDRunner(plan, device="cpu")
    state = port.init_state()
    state["E1"]["Ey"][1, 2, 3] = -5.0
    state["E"]["Ez"][0, 0, 0] = 2.0
    assert float(port._max_field(state)) == 5.0


# --------------------------------------------------------------------------- #
# kernel against plain version, on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(BLOCH))
def test_kernel_matches_plain(case, cuda):
    plan = lower(BLOCH[case]())
    port = FDTDRunner(plan, device=cuda)
    assert port.tier == "kstep" and port.is_complex
    st = _complex_state(port, 5)
    outs = []
    for fn in (kstep_kernels.kstep_group,
               kstep_kernels.kstep_group_reference):
        state = convert.state_from_reference(st, port)
        before = kstep_kernels.LAUNCHES
        new = fn(state, port.consts, port.meta, port.tables, T0, K)
        torch.cuda.synchronize()
        assert kstep_kernels.LAUNCHES == before + (
            fn is kstep_kernels.kstep_group)
        outs.append(convert.state_to_reference(new))
    _check(outs[1], outs[0], TOL_KERNEL, f"{case} kstep kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(BLOCH))
def test_kernel_runner_matches_plain_runner(case, cuda):
    """40 whole steps, kernel against plain: 2e-5 over both copies."""
    plan = lower(BLOCH[case]())
    finals = []
    for use_kernel in (True, False):
        runner = FDTDRunner(plan, device=cuda, use_kernel=use_kernel)
        runner._pad_time_tables(40)
        before = kstep_kernels.LAUNCHES
        state = runner.run_steps(0, 40, runner.init_state())
        assert kstep_kernels.LAUNCHES - before == \
            (40 // runner.k if use_kernel else 0)
        finals.append({f"{fam}:{c}": v.cpu().numpy()
                       for fam in ("E", "H", "E1", "H1")
                       for c, v in state[fam].items()})
    assert max(np.max(np.abs(v)) for v in finals[1].values()) > 0
    assert max_rel_err(finals[1], finals[0]) <= TOL
