"""More than 8 dispersive pole slots in the port against the JAX package.

Two library metals in one simulation pass 8 pole slots (the default Au, 6,
on a Cr adhesion layer, 7: 13). The JAX package's k-step kernel refuses
them (``pallas_kstep.py:295``); its fused and two-phase tiers and its XLA
path take every slot. The port's fused and family kernels hold up to 8
slots in their parameter blocks and read more from a device table
(``csrc/fused.cu``, ``csrc/step.cu``); their plain versions loop over every
slot. Checked on the CPU at 9 and 13 slots: one step of the ``fused`` and
``pallas2`` tiers from a seeded random state against the JAX runner's XLA
``_step`` (1e-6); whole runs against the JAX fused tier in interpret mode
and its XLA path (raw monitors, 2e-5); bf16 storage against the same JAX
tier in interpret mode (1e-2 at 9 slots; Au on Cr in bf16 is as far from
one JAX tier as the JAX package's two tiers are from each other); the tier
choice.

The kernel-against-plain tests at the end need a CUDA card and skip
without one.
"""

import jax
import numpy as np
import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch import convert
from tidy3d_tpu_torch.solver import fdtd as port_fdtd
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.kernels import fused as fused_kernels
from tidy3d_tpu_torch.solver.kernels import step as step_kernels

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    FREQ0, lower_reference as lower, max_rel_err, random_state,
)
from tests.test_torch_nonlinear import _raw_err
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

TOL = 2e-5
TOL_STEP = 1e-6
TOL_BF16 = 1e-2
STEP = 8            # a step inside the source pulse
AU = tt.material_library["Au"]["RakicLorentzDrude1998"]
CR = tt.material_library["Cr"]["RakicLorentzDrude1998"]
LORENTZ9 = tt.Lorentz(eps_inf=2.0, coeffs=[
    (0.3, FREQ0 * (1.2 + 0.2 * i), FREQ0 / 10) for i in range(9)])


def stack_sim(slots: int, run_time=3e-15, monitors=True):
    """A grid the JAX fused tier takes in interpret mode (nx even, 7-layer
    x and z PML, periodic y): a 9-pole Lorentz slab, or Au on a Cr layer
    (13 slots), under an Ez dipole, with a field plane and a time
    monitor."""
    if slots == 9:
        structures = [tt.Structure(
            geometry=tt.Box(center=(0, 0, 0.2), size=(tt.inf, tt.inf, 0.3)),
            medium=LORENTZ9)]
    else:
        structures = [
            tt.Structure(geometry=tt.Box(center=(0, 0, 0.25),
                                         size=(tt.inf, tt.inf, 0.3)),
                         medium=AU),
            tt.Structure(geometry=tt.Box(center=(0, 0, 0.05),
                                         size=(tt.inf, tt.inf, 0.1)),
                         medium=CR)]
    mons = [tt.FieldMonitor(center=(0, 0, -0.05), size=(tt.inf, tt.inf, 0),
                            freqs=[FREQ0], name="f"),
            tt.FieldTimeMonitor(center=(0.05, 0, 0.1), size=(0.3, 0.3, 0),
                                name="t")] if monitors else []
    return tt.Simulation(
        center=(0, 0, 0), size=(1.0, 0.8, 0.8), run_time=run_time,
        sources=[tt.PointDipole(
            center=(0.05, 0.0, -0.1), polarization="Ez",
            source_time=tt.GaussianPulse(freq0=FREQ0, fwidth=FREQ0 / 5))],
        structures=structures, monitors=mons,
        boundary_spec=tt.BoundarySpec(
            x=tt.Boundary.pml(num_layers=7), y=tt.Boundary.periodic(),
            z=tt.Boundary.pml(num_layers=7)),
        grid_spec=tt.GridSpec.uniform(dl=0.1), shutoff=0.0)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv("TIDY3D_TPU_TILE_QUANTA", raising=False)
    monkeypatch.setenv("TIDY3D_TPU_PAD_ALIGN", "0")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "xla")


def test_slot_counts():
    assert len(lower(stack_sim(9)).poles) == 9
    assert len(lower(stack_sim(13)).poles) == 13


@pytest.mark.parametrize("tier", ["fused", "pallas2"])
@pytest.mark.parametrize("slots", [9, 13])
def test_step_matches_xla(slots, tier):
    """One step of the tier's plain version from a random state with every
    slot's currents against the JAX runner's XLA ``_step``: fields, psi and
    the pole currents."""
    plan = lower(stack_sim(slots, monitors=False))
    jr = JaxRunner(plan)
    assert jr.fused is None and jr.kstep is None
    port = FDTDRunner(plan, device="cpu", kernel=tier)
    st = random_state(np.random.default_rng(slots), port.shape,
                      port.psi_shapes(), port.consts["pole_scalars"])
    ref = jax.device_get(jr._step(STEP, jax.device_put(dict(st, mon=[])),
                                  jax.device_put(jr.consts)))
    state = convert.state_from_reference(st, port)
    got = convert.state_to_reference(port.step(STEP, state))
    for fam in ("E", "H", "psi"):
        err = max_rel_err(ref[fam], got[fam])
        assert err <= TOL_STEP, f"{slots} {tier} {fam}: {err:.2e}"
    flat = [{f"{p}:{c}:{i}": v for p, Qp in enumerate(s["Q"])
             for c, pair in Qp.items() for i, v in enumerate(pair)}
            for s in (ref, got)]
    assert len(flat[0]) == 6 * slots
    err = max_rel_err(*flat)
    assert err <= TOL_STEP, f"{slots} {tier} Q: {err:.2e}"


@pytest.mark.parametrize("slots", [9, 13])
def test_fused_run_matches_fused_interpret(slots, monkeypatch):
    """Whole runs on the fused tier: raw monitors against the JAX fused
    tier in interpret mode (its x-CPML pass and pole update after its
    kernel, every slot)."""
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "fused_interpret")
    plan = lower(stack_sim(slots))
    jr = JaxRunner(plan)
    assert jr.fused is not None
    ref = jr.run()
    port = FDTDRunner(plan, device="cpu", kernel="fused")
    err = _raw_err(ref, port.run())
    assert err <= TOL, f"{slots}: {err:.2e}"


@pytest.mark.parametrize("slots", [9, 13])
def test_pallas2_run_matches_xla(slots):
    plan = lower(stack_sim(slots))
    ref = JaxRunner(plan).run()
    port = FDTDRunner(plan, device="cpu", kernel="pallas2")
    err = _raw_err(ref, port.run())
    assert err <= TOL, f"{slots}: {err:.2e}"


@pytest.mark.parametrize("tier", ["fused", "pallas2"])
def test_bf16_run_matches_interpret(tier, monkeypatch):
    """9 slots in bf16 (fields, psi and every pole current) against the
    same JAX tier in interpret mode at the same storage (1e-2)."""
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", f"{tier}_interpret")
    plan = lower(stack_sim(9))
    ref = JaxRunner(plan, precision="bfloat16").run()
    port = FDTDRunner(plan, device="cpu", kernel=tier, precision="bfloat16")
    assert port.storage == (torch.bfloat16,) * 3
    err = _raw_err(ref, port.run())
    print(f"[bf16] 9 slots {tier} vs {tier}_interpret: {err:.2e}")
    assert err <= TOL_BF16


def test_bf16_au_cr_within_the_jax_tiers_spread(monkeypatch):
    """Au on Cr in bf16: the JAX package's own fused and pallas2 tiers
    differ by about 0.1 of the raw monitors' largest magnitude after 17
    steps (the Cr slots' currents lose that much in bf16 storage; with Au
    alone they agree within 4e-3), so 1e-2 is out of reach of either
    package; the port's fused tier stays within that spread of the JAX
    fused tier."""
    plan = lower(stack_sim(13))
    runs = {}
    for tier in ("fused", "pallas2"):
        monkeypatch.setenv("TIDY3D_TPU_KERNEL", f"{tier}_interpret")
        runs[tier] = JaxRunner(plan, precision="bfloat16").run()
    spread = _raw_err(runs["fused"], runs["pallas2"])
    port = FDTDRunner(plan, device="cpu", kernel="fused",
                      precision="bfloat16")
    err = _raw_err(runs["fused"], port.run())
    print(f"[bf16] Au/Cr: JAX fused vs pallas2 {spread:.2e}, port fused vs "
          f"JAX fused {err:.2e}")
    assert spread > TOL_BF16 and err <= spread


def test_tier_choice():
    """The k-step kernel refuses more than 8 slots, as the JAX package's
    does; ``auto`` takes the fused tier on either device, a forced kstep
    raises, pallas2 and fused run."""
    one = {"E": 1, "H": 0}
    plan = lower(stack_sim(13))
    for device in ("cpu", "cuda"):
        assert port_fdtd.select_tier(plan, one, device, "auto") == \
            ("fused", 1)
    assert port_fdtd.kstep_unsupported_reason(plan, 2, one) == \
        "13 pole slots (at most 8)"
    with pytest.raises(ValueError, match="13 pole slots"):
        port_fdtd.select_tier(plan, one, "cuda", "kstep")
    for tier in ("fused", "pallas2"):
        assert port_fdtd.select_tier(plan, one, "cuda", tier) == (tier, 1)
    runner = FDTDRunner(plan, device="cpu", kernel="fused")
    est = runner.estimate_device_memory()
    cells = int(np.prod(plan.shape))
    # both pole-current sets of the fused tier: 13 slots x 6 arrays x 2
    assert est["state"] >= 2 * 13 * 6 * 4 * cells


# --------------------------------------------------------------------------- #
# the kernels against their plain versions, on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _flat(d: dict) -> dict:
    out = {}
    for key, v in d.items():
        if isinstance(v, torch.Tensor):
            out[key] = v.float().cpu().numpy()
        elif isinstance(v, dict):
            out.update({f"{key}.{k}": a for k, a in _flat(v).items()})
        elif isinstance(v, (list, tuple)):
            out.update({f"{key}.{i}.{k}": a for i, x in enumerate(v)
                        for k, a in _flat(x if isinstance(x, dict)
                                          else {"": x}).items()})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("slots", [9, 13])
def test_many_pole_kernels_match_plain(slots, precision, cuda):
    """The fused kernel's and the family kernel's table paths against their
    plain versions on the same state (1e-6 in float32, 1e-2 in bf16)."""
    from tidy3d_tpu_torch.solver.lowering import lower as port_lower

    port = FDTDRunner(port_lower(stack_sim(slots)), device=cuda,
                      kernel="fused", precision=precision)
    st = random_state(np.random.default_rng(3), port.shape,
                      port.psi_shapes(), port.consts["pole_scalars"])
    state = convert.state_from_reference(st, port)
    tol = TOL_STEP if precision == "float32" else TOL_BF16
    src = port.step_sources("E", STEP)
    before = fused_kernels.LAUNCHES
    got = fused_kernels.fused_step(state, port.consts, port.meta, src)
    assert fused_kernels.LAUNCHES == before + 1
    ref = fused_kernels.fused_step_reference(state, port.consts, port.meta,
                                             src)
    err = max_rel_err(*(_flat(dict(zip("EHPQ", out)))
                        for out in (ref, got)))
    assert err <= tol, f"fused {slots}: {err:.2e}"
    before = step_kernels.MANY_POLES_LAUNCHES
    got = step_kernels.family_update("E", state, port.consts, state["H"],
                                     port.meta)
    assert step_kernels.MANY_POLES_LAUNCHES == before + 1
    ref = step_kernels.family_update_reference("E", state, port.consts,
                                               state["H"], port.meta)
    err = max_rel_err(*(_flat(dict(zip("EP", out))) for out in (ref, got)))
    assert err <= tol, f"family {slots}: {err:.2e}"
