"""The differentiable run and ``TopologyObjective`` against the JAX package.

``FDTDRunner.make_differentiable_run`` (autograd through the plain
out-of-place step sequence, checkpointed per chunk) on the small Lorentz
case of ``tests/torch_cases.py`` with a field, a flux and a field-time
monitor: the gradient with respect to an E component's ``cb`` of an
objective of the DFT accumulators and the time samples, against ``jax.grad``
through the JAX package's ``make_differentiable_run``, to ``TOL_GRAD`` of
its largest magnitude (measured 2.0e-7; the value 2.1e-7). A Bloch run
and a bfloat16 run against ``jax.grad`` the same way; sharded runs stay
refused. ``TopologyObjective`` on the
coupling case of ``tests/test_plugins/test_adjoint_invdes.py``, port
against JAX: the value to ``TOL_VALUE`` relative (measured 7.8e-8) and the
gradient to ``TOL_GRAD`` of its largest magnitude (7.0e-7). Last, the
adjoint simulation of that case's mode-amplitude objective: its
``CustomCurrentSource`` data are complex, lowering splits each into real
plans on real waveforms, and the port runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch.plugins.adjoint import TopologyObjective
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.lowering import lower
from tidy3d_tpu_torch.solver.sharding import ShardingPlan, make_mesh

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    BLOCH, COUPLING_REGION, DISPERSIVE, SIMS, coupling, lower_reference,
    max_rel_err, monitors, random_state, to_reference,
)
import tidy3d_tpu
from tidy3d_tpu.plugins.adjoint import TopologyObjective as JaxTopology
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

TOL_GRAD = 1e-3     # of the largest |gradient|
TOL_GRAD_F32 = 1e-6  # of the largest |gradient|, the Bloch run
TOL_VALUE = 1e-4    # relative


@pytest.fixture(scope="module", autouse=True)
def _xla():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
        mp.setenv("TIDY3D_TPU_KERNEL", "xla")
        yield


def _with_cb(consts, comp, cb):
    out = dict(consts)
    out["coeffs_E"] = dict(consts["coeffs_E"])
    out["coeffs_E"][comp] = (consts["coeffs_E"][comp][0], cb)
    return out


def _objective(mon_out, scale, lib):
    """sum of squares of the field monitor's DFT accumulators and of the
    time monitor's samples, each over a fixed scale of its magnitude (the
    accumulators of the dipole's fields carry a factor dt, ~1e-16)."""
    field, time_mon = mon_out[0], mon_out[-1]
    return sum(lib.sum((a / scale[0]) ** 2) for a in field.values()) \
        + sum(lib.sum((a / scale[1]) ** 2) for a in time_mon.values())


def test_differentiable_run_matches_jax():
    sim = DISPERSIVE["lorentz_mixed"](monitors=monitors())
    plan = lower_reference(sim)
    assert len(plan.poles) == 1
    assert [mp.kind for mp in plan.monitors][0] == "field"
    assert plan.monitors[-1].kind == "field_time"
    comp = "Ez"
    jr = JaxRunner(plan)
    jfn = jr.make_differentiable_run()
    jconsts = jax.device_put(jr.consts)
    cb0 = jconsts["coeffs_E"][comp][1]
    assert jnp.ndim(cb0) == 3
    scale = (2e-16, 0.1)

    def j_loss(cb):
        mon, _ = jfn(_with_cb(jconsts, comp, cb))
        return _objective(mon, scale, jnp)

    val_ref, g_ref = jax.jit(jax.value_and_grad(j_loss))(cb0)

    port = FDTDRunner(plan, device="cpu", kernel="pallas2")
    fn = port.make_differentiable_run()
    cb = port.consts["coeffs_E"][comp][1].clone().requires_grad_(True)
    mon, state = fn(_with_cb(port.consts, comp, cb))
    val = _objective(mon, scale, torch)
    (g,) = torch.autograd.grad(val, cb)
    assert set(state) == {"E", "H", "psi", "Q", "mon"}
    assert mon[0]["Ex"].shape[0] == 2       # (re, im) stacked
    e_val = abs(float(val.detach()) - float(val_ref)) / float(val_ref)
    g_ref = np.asarray(g_ref)
    e_grad = float(np.max(np.abs(g.numpy() - g_ref)) / np.max(np.abs(g_ref)))
    print(f"differentiable run: value {e_val:.1e}, gradient {e_grad:.1e}")
    assert e_val <= TOL_VALUE and e_grad <= TOL_GRAD
    assert np.max(np.abs(g_ref)) > 0


def test_differentiable_run_leaves_the_run_alone():
    """``make_differentiable_run`` adds the source leaves to the constant
    tree and pads the time tables to its chunks; a ``run()`` after it gives
    the raw monitors of a fresh runner's, and the differentiable run's
    accumulators (no grad asked for) are the run's to float32 rounding."""
    plan = lower(SIMS["pml_all"](monitors=monitors()[:1], run_time=5e-15))
    want = FDTDRunner(plan, device="cpu", kernel="pallas2").run()
    runner = FDTDRunner(plan, device="cpu", kernel="pallas2")
    mon, _ = runner.make_differentiable_run(checkpoint_chunks=3)(
        runner.consts)
    assert runner.checkpoint_chunks == (-(-plan.num_steps // 3), 3)
    assert set(runner.consts) >= {"waveforms", "src_profiles"}
    got = runner.run()
    for comp, arr in want[0].items():
        np.testing.assert_array_equal(got[0][comp], arr)
        scale = np.max(np.abs(arr))
        assert scale > 0
        for part, ref in zip(mon[0][comp].numpy(), (arr.real, arr.imag)):
            assert np.max(np.abs(part - ref)) <= 1e-6 * scale, comp


@pytest.mark.parametrize("case", sorted(dict(SIMS, **DISPERSIVE)))
def test_differentiable_step_is_the_pallas2_step(case):
    """One step of the differentiable run (out of place) gives what one
    step of the ``pallas2`` tier's main path gives (in place), on a random
    state of every real case (PML, PEC, PMC and periodic walls, per-cell
    coefficients, 1 to 7 poles; a field, a flux and a field-time monitor)
    at the step where the sources are largest: fields, psi, pole currents,
    DFT accumulators and time samples to float32 rounding (measured 0.0
    without poles, at most 1.2e-7 of a tensor's largest value with
    them)."""
    import copy

    from tidy3d_tpu_torch import convert
    from tidy3d_tpu_torch.solver.fdtd import _named

    runner = FDTDRunner(lower(dict(SIMS, **DISPERSIVE)[case](
        monitors=monitors())), device="cpu", kernel="pallas2")
    runner.make_differentiable_run()
    st = convert.state_from_reference(random_state(
        np.random.default_rng(3), runner.shape, runner.psi_shapes(),
        runner.consts["pole_scalars"]), runner)
    st["mon"] = runner.init_state()["mon"]
    n = int(np.argmax(np.abs(runner._waveforms).sum(axis=0)))
    got = runner._diff_step(n, st, runner.consts)
    want = runner.step(n, copy.deepcopy(st))
    got, want = dict(_named(got)), dict(_named(want))
    assert got.keys() == want.keys()
    for key, ref in want.items():
        scale = float(ref.abs().max()) or 1.0
        assert float((got[key] - ref).abs().max()) <= 1e-6 * scale, key


# of the largest |gradient|, bf16 against bf16 (measured 1.9e-3; the
# reference's own float32 gradient lies 5.4e-3 from its bf16 one). A float32
# carry under the reference's objective scale also reads 1.9e-3 here, so
# the carry's rounding is pinned by its bits (test_bf16_carry_rounds_...)
TOL_GRAD_BF16 = 3e-3
# after 4 steps of the Lorentz case, the share of nonzero field values of
# the port's bf16 carry equal bit for bit to the reference's (measured
# 0.76; a float32 carry rounded at the end 0.43)
MIN_EQUAL_SHARE_BF16 = 0.7
TOL_MON_BF16 = 1e-2    # the forward accumulators, bf16 (test_torch_bf16's bar)


def _grads(sim, precision, comp="Ez"):
    """The objective's gradient with respect to ``cb`` of ``comp`` through
    both packages' differentiable runs, at ``precision``, and both runs'
    field-monitor accumulators: ``(g, g_ref, mon, mon_ref)``."""
    plan = lower_reference(sim)
    jr = JaxRunner(plan, precision=precision)
    jfn = jr.make_differentiable_run()
    jconsts = jax.device_put(jr.consts)
    cb0 = jconsts["coeffs_E"][comp][1]
    mon_ref = jfn(jconsts)[0]
    scale = tuple(max(float(jnp.max(jnp.abs(a))) for a in mon_ref[i].values())
                  for i in (0, -1))

    def j_loss(cb):
        mon, _ = jfn(_with_cb(jconsts, comp, cb))
        return _objective(mon, scale, jnp)

    g_ref = np.asarray(jax.jit(jax.grad(j_loss))(cb0))
    port = FDTDRunner(plan, device="cpu", kernel="pallas2",
                      precision=precision)
    fn = port.make_differentiable_run()
    cb = port.consts["coeffs_E"][comp][1].clone().requires_grad_(True)
    mon, state = fn(_with_cb(port.consts, comp, cb))
    (g,) = torch.autograd.grad(_objective(mon, scale, torch), cb)
    return g.numpy(), g_ref, mon, mon_ref, state


@pytest.mark.parametrize("what", ["bloch", "bfloat16"])
def test_differentiable_bloch_and_bf16_match_jax(what):
    """The differentiable run of a Bloch run (both real copies stepped, copy
    1 rotated into the DFT; f32, to ``TOL_GRAD_F32`` of the largest
    gradient, measured 2.1e-7) and of a bfloat16 run (the carry rounded
    where the reference's ``_cast_state`` rounds it; gradient to
    ``TOL_GRAD_BF16``, measured 1.9e-3; the forward accumulators to
    ``TOL_MON_BF16`` of their largest magnitude, measured 2.5e-3) against
    ``jax.grad`` through the JAX package's ``make_differentiable_run``."""
    if what == "bloch":
        sim = BLOCH["bloch_dipole"](monitors=monitors(), run_time=5e-15)
        g, g_ref, mon, mon_ref, state = _grads(sim, None)
        assert {"E1", "H1", "psi1", "Q1"} <= set(state)
        tol = TOL_GRAD_F32
    else:
        g, g_ref, mon, mon_ref, state = _grads(
            DISPERSIVE["lorentz_mixed"](monitors=monitors()), "bfloat16")
        assert state["E"]["Ex"].dtype == torch.bfloat16
        assert state["Q"][0]["Ex"][0].dtype == torch.bfloat16
        assert mon[0]["Ex"].dtype == torch.float32
        tol = TOL_GRAD_BF16
        ref = {c: np.asarray(a) for c, a in mon_ref[0].items()}
        got = {c: a.detach().numpy() for c, a in mon[0].items()}
        e_mon = max_rel_err(ref, got)
        print(f"bfloat16 forward accumulators: {e_mon:.1e}")
        assert e_mon <= TOL_MON_BF16
    e_grad = float(np.max(np.abs(g - g_ref)) / np.max(np.abs(g_ref)))
    print(f"differentiable {what} run: gradient {e_grad:.1e}")
    assert np.max(np.abs(g_ref)) > 0 and e_grad <= tol


def test_bf16_carry_rounds_as_the_reference():
    """Four steps of the differentiable bf16 run of the Lorentz case: the
    share of nonzero field values equal bit for bit to the reference's
    differentiable run is at least ``MIN_EQUAL_SHARE_BF16``, which a
    float32 carry rounded only at the end does not reach."""
    plan = lower_reference(DISPERSIVE["lorentz_mixed"](monitors=monitors()))
    jr = JaxRunner(plan, precision="bfloat16")
    ref = jr.make_differentiable_run(num_steps=4)(
        jax.device_put(jr.consts))[1]

    def share(precision):
        port = FDTDRunner(plan, device="cpu", kernel="pallas2",
                          precision=precision)
        got = port.make_differentiable_run(num_steps=4)(port.consts)[1]
        equal = total = 0
        for grp in ("E", "H"):
            for comp, arr in ref[grp].items():
                want = np.asarray(arr.astype(jnp.float32))
                have = got[grp][comp].to(torch.bfloat16).float().numpy()
                nonzero = want != 0
                equal += int(np.sum((want == have) & nonzero))
                total += int(np.sum(nonzero))
        return equal / total

    bf16, f32 = share("bfloat16"), share("float32")
    print(f"bf16 carry equal share {bf16:.3f}, float32 carry {f32:.3f}")
    assert bf16 >= MIN_EQUAL_SHARE_BF16 > f32


@pytest.mark.parametrize("what", ["sharded"])
def test_differentiable_run_refusals(what):
    """A sharded run stays refused: the JAX package differentiates
    unsharded runs only."""
    sim = SIMS["pml_all"]()
    plan = lower(sim.copy(update=dict(size=(0.6,) + sim.size[1:])))
    mesh, _ = make_mesh(devices=["cpu"] * 2)
    runner = FDTDRunner(plan, device="cpu", kernel="kstep",
                        sharding_plan=ShardingPlan(mesh, plan.shape))
    with pytest.raises(NotImplementedError):
        runner.make_differentiable_run()


def bloch_grating(pkg):
    """A 2D grating cell: Bloch y (0.2), PML x, an eps 4 bar, an Ez dipole
    below the design region and a field plane above it (50 x 20 cells at
    dl = 0.06)."""
    f0 = pkg.C_0 / 1.5
    return pkg.Simulation(
        center=(0, 0, 0), size=(3.0, 1.2, 0), run_time=4e-14,
        sources=[pkg.PointDipole(
            center=(-1.0, 0.1, 0), polarization="Ez",
            source_time=pkg.GaussianPulse(freq0=f0, fwidth=f0 / 6))],
        monitors=[pkg.FieldMonitor(center=(1.0, 0, 0),
                                   size=(0, pkg.inf, pkg.inf), freqs=[f0],
                                   name="out")],
        structures=[pkg.Structure(
            geometry=pkg.Box(center=(0.6, 0, 0), size=(0.3, 0.5, pkg.inf)),
            medium=pkg.Medium(permittivity=4.0))],
        shutoff=0.0,
        boundary_spec=pkg.BoundarySpec(
            x=pkg.Boundary.pml(), y=pkg.Boundary.bloch(bloch_vec=0.2),
            z=pkg.Boundary.periodic()),
        grid_spec=pkg.GridSpec.uniform(dl=0.06))


GRATING_REGION = dict(center=(-0.2, 0, 0), size=(0.6, 0.6, tt.inf))


def test_topology_objective_on_a_bloch_grating():
    """``TopologyObjective`` takes a Bloch simulation, as the JAX package's
    does: value to ``TOL_VALUE`` and gradient to ``TOL_GRAD`` (measured
    6.5e-8 and 8.3e-7) on a random density."""
    def objective(lib):
        return lambda mon: sum(lib.sum(a ** 2)
                               for a in mon[0].values()) * 1e30

    ref = JaxTopology(bloch_grating(tidy3d_tpu),
                      tidy3d_tpu.Box(**GRATING_REGION), eps_min=1.0,
                      eps_max=4.0, objective=objective(jnp))
    rho = 0.5 + 0.1 * np.random.default_rng(0).standard_normal(
        ref.density_shape)
    v_ref, g_ref = ref.value_and_grad(rho)
    topo = TopologyObjective(bloch_grating(tt), tt.Box(**GRATING_REGION),
                             eps_min=1.0, eps_max=4.0,
                             objective=objective(torch), device="cpu")
    assert topo.runner.is_complex and ref.runner.is_complex
    v, g = topo.value_and_grad(rho)
    e_val = abs(v - v_ref) / abs(v_ref)
    e_grad = float(np.max(np.abs(g - g_ref)) / np.max(np.abs(g_ref)))
    print(f"Bloch TopologyObjective: value {e_val:.1e}, gradient "
          f"{e_grad:.1e}")
    assert e_val <= TOL_VALUE and e_grad <= TOL_GRAD


def test_topology_objective_matches_jax():
    rho = 0.5 * np.ones((21, 31, 1))
    ref = JaxTopology(to_reference(coupling()),
                      tidy3d_tpu.Box(**COUPLING_REGION), eps_min=1.0,
                      eps_max=6.0, mode_monitor_name="out")
    v_ref, g_ref = ref.value_and_grad(rho)
    topo = TopologyObjective(coupling(), tt.Box(**COUPLING_REGION),
                             eps_min=1.0, eps_max=6.0,
                             mode_monitor_name="out", device="cpu")
    assert topo.runner.tier == "pallas2" and topo.density_shape == rho.shape
    v, g = topo.value_and_grad(rho)
    e_val = abs(v - v_ref) / abs(v_ref)
    e_grad = float(np.max(np.abs(g - g_ref)) / np.max(np.abs(g_ref)))
    print(f"TopologyObjective: value {e_val:.1e}, gradient {e_grad:.1e}")
    assert v > 0 and np.max(np.abs(g)) > 0
    assert e_val <= TOL_VALUE and e_grad <= TOL_GRAD
    assert topo.value(rho) == v


def test_complex_adjoint_sources_lower_to_real_plans_and_run():
    """The adjoint simulation of a mode-amplitude objective carries
    ``CustomCurrentSource``s with complex current data; lowering splits
    each component into real plans on the real waveforms Re a(t) and
    -Im a(t), so the port runs it without the refusal of complex
    profiles."""
    from tidy3d_tpu_torch.web.autograd import (_monitor_fields,
                                               _objective_vjp, _vjp_data)

    sim = coupling(run_time=3e-14)
    data = tt.web.run(sim, device="cpu", verbose=False)
    _, vjps = _objective_vjp(
        lambda f: torch.sum(torch.abs(f["out"]["amps"]) ** 2),
        _monitor_fields(data, ["out"]))
    sim_adj = _vjp_data(data, vjps).make_adjoint_sim(
        fwidth=sim.sources[0].source_time.fwidth)
    datasets = [np.asarray(arr.values) for src in sim_adj.sources
                for arr in src.current_dataset.values()]
    assert sim_adj.sources and all(isinstance(src, tt.CustomCurrentSource)
                                   for src in sim_adj.sources)
    assert any(np.any(np.imag(v) != 0) for v in datasets)
    plan = lower(sim_adj)
    assert all(not np.iscomplexobj(sp.profile) for sp in plan.sources)
    assert not np.iscomplexobj(plan.waveforms)
    assert len(plan.sources) > len(datasets)    # re and im plans
    probe = tt.FieldMonitor(center=COUPLING_REGION["center"],
                            size=(0.6, 0.6, 0), name="probe",
                            freqs=[sim.monitors[0].freqs[0]])
    out = tt.web.run(sim_adj.copy(update=dict(monitors=(probe,))),
                     device="cpu", verbose=False)
    ez = out["probe"].Ez.values
    assert np.all(np.isfinite(ez)) and np.any(ez != 0)
