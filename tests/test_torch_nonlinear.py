"""Nonlinear (chi3, Kerr, two-photon absorption) and time-modulated media in
the port against the JAX package.

The passes run on the port's ``pallas2`` tier between the E update and the
pole update (``solver/nonlinear.py``; on a card one launch of
``csrc/post_e.cu``), where the JAX package runs them inside its XLA
``_step`` (``tidy3d_tpu/solver/fdtd.py:1632-1688``). Checked on the CPU:
the constants; one step from a seeded random state against the JAX
runner's XLA ``_step`` (1e-6 of the largest magnitude); whole runs, raw
monitors against the JAX XLA runner (2e-5); bf16 storage against the JAX
``pallas2`` tier in interpret mode (1e-2); the differentiable run's
gradient against ``jax.grad``; the tier choice. Each case's source is
strong enough that its nonlinear or modulation term moves the raw
monitors by more than ``MIN_EFFECT`` of their largest magnitude against
the same run without it, so that no check is vacuous.

The kernel-against-plain tests at the end need a CUDA card and skip
without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch import convert
from tidy3d_tpu_torch.solver import fdtd as port_fdtd
from tidy3d_tpu_torch.solver import nonlinear
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.kernels import post_e as post_e_kernels

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    DL, FREQ0, SIZE, lower_reference as lower, max_rel_err, random_state,
)
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

TOL = 2e-5          # raw monitors, the reference's bar
TOL_STEP = 1e-6     # one step from the same state
TOL_BF16 = 1e-2
TOL_GRAD = 1e-3     # of the largest |gradient| (tests/test_torch_adjoint.py)
MIN_EFFECT = 1e-3   # the passes' effect on the raw monitors, at least
STEP = 20           # a step inside the source pulse
AMPLITUDE = 1e3     # the dipole's: fields of about 1 V/um at the source
CHI3 = 0.02         # um^2/V^2
N0 = float(np.sqrt(2.0))
# the Kerr n2 [um^2/W] and TPA beta [um/W] of about the chi3 above
N2 = CHI3 / ((4.0 / 3.0) * N0 ** 2 * tt.constants.EPSILON_0 * tt.C_0)
BETA = 4e-3 / (tt.C_0 ** 2 * tt.constants.EPSILON_0 ** 2 * N0 ** 2)

WHOLE = tt.Box(center=(0, 0, 0), size=(tt.inf, tt.inf, tt.inf))
BOX = tt.Box(center=(0.02, -0.01, 0.03), size=(0.25, 0.2, 0.3))


@pytest.fixture(autouse=True)
def _xla(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "xla")


def _nl(models, num_iters=5):
    return tt.Medium(permittivity=2.0, nonlinear_spec=tt.NonlinearSpec(
        models=models, num_iters=num_iters))


def _mod(eps=False, sigma=False):
    cw = tt.ContinuousWaveTimeModulation(freq0=FREQ0 / 3, amplitude=0.3,
                                         phase=0.4)
    stm = tt.SpaceTimeModulation(
        time_modulation=cw,
        space_modulation=tt.SpatialModulationUniform(amplitude=1.0,
                                                    phase=0.2))
    return tt.Medium(permittivity=2.0, conductivity=0.5,
                     modulation_spec=tt.ModulationSpec(
                         permittivity=stm if eps else None,
                         conductivity=stm if sigma else None))


KERR = tt.KerrNonlinearity(n2=N2)
TPA = tt.TwoPhotonAbsorption(beta=BETA)
MEDIA = {
    "chi3": (_nl([tt.NonlinearSusceptibility(chi3=CHI3)]), BOX),
    "chi3_uniform": (_nl([tt.NonlinearSusceptibility(chi3=CHI3)]), WHOLE),
    "kerr": (_nl([KERR]), BOX),
    "tpa": (_nl([TPA]), BOX),
    "kerr_tpa_1": (_nl([KERR, TPA], num_iters=1), BOX),
    "kerr_tpa_10": (_nl([KERR, TPA], num_iters=10), BOX),
    "eps_uniform": (_mod(eps=True), WHOLE),
    "eps_box": (_mod(eps=True), BOX),
    "sigma_box": (_mod(sigma=True), BOX),
    "both_uniform": (_mod(eps=True, sigma=True), WHOLE),
    "both_box": (_mod(eps=True, sigma=True), BOX),
}


def _monitors():
    freqs = [0.9 * FREQ0, FREQ0, 1.1 * FREQ0]
    return [
        tt.FieldMonitor(center=(0, 0, 0.05), size=(0.4, 0.3, 0),
                        freqs=freqs, name="field"),
        tt.FluxMonitor(center=(0, 0, 0), size=(0.35, 0.3, 0.45),
                       freqs=freqs, name="flux"),
        tt.FieldTimeMonitor(center=(0.02, -0.01, 0.03), size=(0.2, 0.2, 0),
                            interval=1, name="time"),
    ]


def nl_sim(case: str, medium=None, run_time=3.5e-15, monitors=True):
    """The case's medium (or ``medium``) in its box around a strong Ez
    dipole, PML on every side, under 40 steps."""
    default, geometry = MEDIA[case]
    return tt.Simulation(
        center=(0, 0, 0), size=SIZE, run_time=run_time,
        sources=[tt.PointDipole(
            center=(0.02, -0.01, 0.03), polarization="Ez",
            source_time=tt.GaussianPulse(freq0=FREQ0, fwidth=FREQ0 / 5,
                                         amplitude=AMPLITUDE))],
        structures=[tt.Structure(geometry=geometry,
                                 medium=medium or default)],
        monitors=_monitors() if monitors else [],
        boundary_spec=tt.BoundarySpec.all_sides(tt.PML(num_layers=3)),
        grid_spec=tt.GridSpec.uniform(dl=DL), shutoff=0.0)


def _linear(case: str):
    """The case's medium without its nonlinearity or modulation."""
    medium = MEDIA[case][0]
    return medium.copy(update=dict(nonlinear_spec=None,
                                   modulation_spec=None))


def _raw_err(ref: dict, got: dict) -> float:
    """The largest error of any raw monitor array (both quadratures),
    relative to the largest magnitude of its monitor."""
    assert set(got) == set(ref)
    worst = 0.0
    for idx in ref:
        assert set(got[idx]) == set(ref[idx])
        scale = max(float(np.max(np.abs(v))) for v in ref[idx].values())
        for c in ref[idx]:
            worst = max(worst, float(np.max(np.abs(
                np.asarray(ref[idx][c]) - np.asarray(got[idx][c]))))
                / (scale + 1e-30))
    return worst


def test_constants_match_jax():
    """``build_post_e_constants`` against the JAX runner's ``nl`` and
    ``mod`` constants: scalars where a map is uniform, equal arrays
    elsewhere, the time tables padded one step."""
    for case in MEDIA:
        plan = lower(nl_sim(case))
        jr = JaxRunner(plan)
        port = FDTDRunner(plan, device="cpu")
        host = port.host_consts
        for key in ("nl", "mod"):
            assert (key in host) == (key in jr.consts), (case, key)
        if "nl" in host:
            assert port.consts["nl_num_iters"] == jr.nl_num_iters
            for kind in ("B", "K"):
                assert set(host["nl"][kind]) == set(jr.consts["nl"][kind])
                for comp, v in host["nl"][kind].items():
                    ref = jr.consts["nl"][kind][comp]
                    assert np.ndim(v) == np.ndim(ref)
                    np.testing.assert_array_equal(v, ref)
        for ce, ref in zip(host.get("mod", ()), jr.consts.get("mod", ())):
            assert set(ce) == set(ref)
            for key in ce:
                if key in ("Beps", "Bsig"):
                    for comp, pair in ce[key].items():
                        for v, r in zip(pair, ref[key][comp]):
                            assert np.ndim(v) == np.ndim(r), (case, key)
                            np.testing.assert_array_equal(v, r)
                else:
                    np.testing.assert_array_equal(ce[key], ref[key])
        uniform = case.endswith("uniform")
        maps = [v for kind in host.get("nl", {}).values()
                for v in kind.values()] + [
            v for ce in host.get("mod", ()) for key in ("Beps", "Bsig")
            for pair in ce.get(key, {}).values() for v in pair]
        assert maps and all((np.ndim(v) == 0) == uniform for v in maps), case


@pytest.mark.parametrize("case", sorted(MEDIA))
def test_step_matches_xla(case):
    """One ``pallas2`` step of the port from a random state (fields of
    about 1 V/um, where the passes matter) against the JAX runner's
    ``_step``."""
    plan = lower(nl_sim(case, monitors=False))
    jr = JaxRunner(plan)
    assert jr.fused is None and jr.kstep is None
    port = FDTDRunner(plan, device="cpu")
    assert port.tier == "pallas2"
    st = random_state(np.random.default_rng(7), port.shape,
                      port.psi_shapes())
    # H of 1e-2 A/um: its curl moves E by about as much as E is
    st["H"] = {c: np.float32(1e-2) * v for c, v in st["H"].items()}
    consts = jax.device_put(jr.consts)
    ref = jax.device_get(jr._step(STEP, jax.device_put(dict(st, mon=[])),
                                  consts))
    lin_consts = dict(consts)
    lin_consts.pop("nl", None)
    lin_consts.pop("mod", None)
    lin = jax.device_get(jr._step(STEP, jax.device_put(dict(st, mon=[])),
                                  lin_consts))
    effect = max_rel_err(ref["E"], lin["E"])
    assert effect >= MIN_EFFECT, f"{case}: the passes moved E by {effect}"
    got = port.step(STEP, convert.state_from_reference(st, port))
    got = convert.state_to_reference(got)
    for fam in ("E", "H"):
        err = max_rel_err(ref[fam], got[fam])
        assert err <= TOL_STEP, f"{case} {fam}: rel err {err:.2e}"


@pytest.mark.parametrize("case", sorted(MEDIA))
def test_run_matches_xla(case):
    """Whole runs: the port's raw monitors against the JAX XLA runner's,
    and both away from the linear run's."""
    plan = lower(nl_sim(case))
    ref = JaxRunner(plan).run()
    port = FDTDRunner(plan, device="cpu")
    assert port.tier == "pallas2"
    got = port.run()
    err = _raw_err(ref, got)
    lin = FDTDRunner(lower(nl_sim(case, _linear(case))), device="cpu").run()
    effect = _raw_err(ref, lin)
    print(f"{case}: raw monitors {err:.2e}, effect {effect:.2e}")
    assert err <= TOL, f"{case}: rel err {err:.2e}"
    assert effect >= MIN_EFFECT, f"{case}: effect {effect:.2e}"


@pytest.mark.parametrize("case", ["kerr_tpa_10", "both_box"])
def test_bf16_run_matches_pallas2_interpret(case, monkeypatch):
    """bf16 storage: the port's ``pallas2`` run against the JAX package's
    ``pallas2`` tier in interpret mode at the same storage (its passes run
    on XLA between its kernels, from f32 values it rounds at the step's
    end; the port rounds E' once where the passes store it)."""
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "pallas2_interpret")
    plan = lower(nl_sim(case, run_time=2e-15))
    jr = JaxRunner(plan, precision="bfloat16")
    assert jr.pallas is not None
    ref = jr.run()
    port = FDTDRunner(plan, device="cpu", precision="bfloat16")
    assert port.tier == "pallas2" and port.dtype == torch.bfloat16
    err = _raw_err(ref, port.run())
    print(f"[bf16] {case} pallas2 vs pallas2_interpret: {err:.2e}")
    assert err <= TOL_BF16


def _with(consts, key, value):
    out = dict(consts)
    out[key] = value
    return out


@pytest.mark.parametrize("case", ["kerr", "eps_box"])
def test_differentiable_run_matches_jax(case):
    """The differentiable run through the passes: the gradient of a sum of
    squares of the field monitor's DFT and the time samples with respect to
    the case's coefficient map (the Kerr ``B`` of Ez, the modulation's
    ``Beps1`` of Ez) against ``jax.grad`` through the JAX package's
    ``make_differentiable_run``."""
    plan = lower(nl_sim(case))
    jr = JaxRunner(plan)
    jfn = jr.make_differentiable_run()
    jconsts = jax.device_put(jr.consts)

    def swap(consts, leaf, lib):
        if case == "kerr":
            nl = dict(consts["nl"])
            nl["B"] = dict(nl["B"], Ez=leaf)
            return _with(consts, "nl", nl)
        ce = dict(consts["mod"][0])
        ce["Beps"] = dict(ce["Beps"], Ez=(leaf, ce["Beps"]["Ez"][1]))
        return _with(consts, "mod", [ce] + list(consts["mod"][1:]))

    def leaf_of(consts):
        return consts["nl"]["B"]["Ez"] if case == "kerr" \
            else consts["mod"][0]["Beps"]["Ez"][0]

    def objective(mon, lib):
        field, time_mon = mon[0], mon[-1]
        return sum(lib.sum((a / 1e-13) ** 2) for a in field.values()) \
            + sum(lib.sum((a / 1e-2) ** 2) for a in time_mon.values())

    leaf0 = leaf_of(jconsts)
    assert jnp.ndim(leaf0) == 3
    val_ref, g_ref = jax.jit(jax.value_and_grad(
        lambda leaf: objective(jfn(swap(jconsts, leaf, jnp))[0], jnp)))(leaf0)
    port = FDTDRunner(plan, device="cpu", kernel="pallas2")
    fn = port.make_differentiable_run()
    leaf = leaf_of(port.consts).clone().requires_grad_(True)
    mon, _ = fn(swap(port.consts, leaf, torch))
    val = objective(mon, torch)
    (g,) = torch.autograd.grad(val, leaf)
    g_ref = np.asarray(g_ref)
    e_val = abs(float(val.detach()) - float(val_ref)) / float(val_ref)
    e_grad = float(np.max(np.abs(g.numpy() - g_ref)) / np.max(np.abs(g_ref)))
    print(f"{case}: value {e_val:.1e}, gradient {e_grad:.1e}")
    assert np.max(np.abs(g_ref)) > 0
    assert e_val <= 1e-4 and e_grad <= TOL_GRAD


def test_tier_choice():
    """A nonlinear or modulated plan takes ``pallas2`` under ``auto`` on
    every device; a forced ``fused`` or ``kstep`` raises with the reason
    (``PallasFusedStepper.supported``, ``PallasKStepper.supported``)."""
    one = {"E": 1, "H": 0}
    for case in ("kerr", "both_box"):
        plan = lower(nl_sim(case))
        for device in ("cpu", "cuda"):
            assert port_fdtd.select_tier(plan, one, device, "auto") == \
                ("pallas2", 1)
        for tier in ("fused", "kstep"):
            with pytest.raises(ValueError,
                               match="nonlinear or time-modulated"):
                port_fdtd.select_tier(plan, one, "cpu", tier)


def test_passes_are_out_of_place_and_clamp_the_time_index():
    """The plain passes build new tensors and leave their inputs alone; a
    step past the tables' end reads their last entry, as
    ``lax.dynamic_index_in_dim`` clamps."""
    plan = lower(nl_sim("both_box"))
    port = FDTDRunner(plan, device="cpu")
    st = convert.state_from_reference(random_state(
        np.random.default_rng(3), port.shape, port.psi_shapes()), port)
    new = {c: v.clone() for c, v in st["E"].items()}
    out = nonlinear.post_e_reference(new, st["E"], port.consts, 10 ** 6)
    assert all(torch.isfinite(v).all() for v in out.values())
    assert all(out[c] is not new[c] and torch.equal(new[c], st["E"][c])
               for c in new)
    ce = port.consts["mod"][0]
    last = nonlinear.mod_times(ce, len(ce["eps_c"]) + 5)
    assert last[2] == np.float32(ce["eps_c"][-1])
    assert last[4] == np.float32(ce["sig_c"][-1])


# --------------------------------------------------------------------------- #
# the kernel against its plain version, on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MEDIA))
def test_post_e_kernel_matches_plain(case, precision, cuda):
    """``csrc/post_e.cu`` against ``post_e_reference`` on the same state:
    within 1e-6 in float32 (the kernel rounds every operation as written;
    the plain version on a card divides by a scalar as a product with its
    reciprocal), within 1e-2 in bf16 (the plain version cubes a bf16 field
    in bf16 in the first sweep, as JAX promotes; the kernel in float32).
    E_lin is of the order of E, where the fixed point contracts (3 B E^2
    below 1): outside that regime the sweeps amplify any rounding
    difference, the reference's as well."""
    from tidy3d_tpu_torch.solver.lowering import lower as port_lower

    port = FDTDRunner(port_lower(nl_sim(case)), device=cuda,
                      precision=precision)
    st = convert.state_from_reference(random_state(
        np.random.default_rng(11), port.shape, port.psi_shapes()), port)
    new = dict(zip(("Ex", "Ey", "Ez"), st["H"].values()))
    ref = nonlinear.post_e_reference(new, st["E"], port.consts, STEP)
    before = post_e_kernels.LAUNCHES
    got = post_e_kernels.post_e({c: v.clone() for c, v in new.items()},
                                st["E"], port.consts, STEP)
    assert post_e_kernels.LAUNCHES == before + 1
    err = max_rel_err({c: v.float().cpu().numpy() for c, v in ref.items()},
                      {c: v.float().cpu().numpy() for c, v in got.items()})
    assert err <= (TOL_STEP if precision == "float32" else TOL_BF16), err


# --------------------------------------------------------------------------- #
# the reference's physics checks through the port (slow: thousands of steps)
# --------------------------------------------------------------------------- #


@pytest.mark.slow
def test_reference_physics_through_the_port(monkeypatch):
    """The four physics tests of the JAX package
    (``tests/test_solver/test_nonlinear.py``: Kerr phase shift, two-photon
    absorption, chi3 equals Kerr; ``test_modulation.py``: the sidebands of
    a phase-modulated slab) run through the port on the CPU with the
    reference's asserts (``chip_smoke.physics_checks``, phase 35 on the
    card)."""
    import chip_smoke

    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    out = chip_smoke.physics_checks(tt, device="cpu")
    print(out)
