"""The fused one-step tier of the port against the JAX package.

One whole step of the port's ``fused`` tier (``fused_step_reference``, the
H-side sources and the pole update) from a random state, against the JAX
runner's XLA ``_step`` on the same numpy inputs: fields, psi and pole
currents to 1e-6 of the largest magnitude. The cases cover all-PML, mixed
PEC/PMC, periodic-x, 1- and 3-pole media and a plane-wave sheet through the
PML. One tiny case also runs through the JAX package's fused TPU kernels in
interpret mode, and its raw monitors agree with the port's to 1e-5.

The kernel-against-plain tests at the end need a CUDA card and skip without
one.
"""

import jax
import numpy as np
import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch import convert
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.kernels import fused as fused_kernels

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    DISPERSIVE, FREQ0, LORENTZ, lower_reference as lower, max_rel_err,
    random_state, SIMS,
)
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

TOL_XLA = 1e-6      # float32 rounding of the same expression tree
TOL_PALLAS = 1e-5   # the reference's own Pallas-vs-XLA bar
STEP = 40           # a step inside the source pulse

CASES = {**SIMS, **DISPERSIVE}
STEP_CASES = ["pml_all", "dielectric_mixed", "periodic", "lorentz_mixed",
              "drude_periodic", "lorentz3_pml", "sheet_lorentz"]


def _flat(state: dict) -> dict:
    """E, H, psi and Q of a numpy state as one flat dict."""
    out = {}
    for fam in ("E", "H", "psi"):
        out.update({f"{fam}:{k}": v for k, v in state[fam].items()})
    for pi, Qp in enumerate(state["Q"]):
        for c, (qr, qi) in Qp.items():
            out[f"Q{pi}:{c}:re"] = qr
            out[f"Q{pi}:{c}:im"] = qi
    return out


def _check_groups(ref: dict, got: dict, tol: float, what: str):
    """Each of E, H, psi and every pole's Q within ``tol`` of its own
    largest magnitude."""
    assert set(ref) == set(got), f"{what}: keys differ"
    for group in sorted({k.split(":")[0] for k in ref}):
        keys = [k for k in ref if k.split(":")[0] == group]
        err = max_rel_err({k: ref[k] for k in keys},
                          {k: got[k] for k in keys})
        assert err <= tol, f"{what} {group}: rel err {err:.2e}"


def _jax_step(jr, state_np, step):
    consts = jax.device_put(jr.consts)
    st = jax.device_put(dict(state_np, mon=[]))
    out = jax.jit(lambda s, c: jr._step(step, s, c))(st, consts)
    return convert.state_to_reference({
        "E": {c: torch.from_numpy(np.asarray(v)) for c, v in out["E"].items()},
        "H": {c: torch.from_numpy(np.asarray(v)) for c, v in out["H"].items()},
        "psi": {k: torch.from_numpy(np.asarray(v))
                for k, v in out["psi"].items()},
        "Q": [{c: (torch.from_numpy(np.asarray(qr)),
                   torch.from_numpy(np.asarray(qi)))
               for c, (qr, qi) in Qp.items()} for Qp in out["Q"]]})


@pytest.mark.parametrize("case", STEP_CASES)
def test_fused_step_matches_xla(case, monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "xla")
    plan = lower(CASES[case]())
    jr = JaxRunner(plan)
    port = FDTDRunner(plan, device="cpu", kernel="fused")
    assert port.tier == "fused"
    assert port._waveforms[:, STEP].any(), "source off at the test step"
    rng = np.random.default_rng(17)
    st = random_state(rng, port.shape, port.psi_shapes(),
                      port.consts["pole_scalars"])
    ref = _jax_step(jr, st, STEP)
    before = fused_kernels.LAUNCHES
    got = port.step(STEP, convert.state_from_reference(st, port))
    assert fused_kernels.LAUNCHES == before
    got = convert.state_to_reference(got)
    assert len(got["Q"]) == len(plan.poles)
    _check_groups(_flat(ref), _flat(got), TOL_XLA, case)


def test_step_cases_cover_poles_walls_and_sheets():
    """The step cases hold 0, 1 and 3 poles, every wall kind, a periodic x
    axis and a multi-component sheet source."""
    poles, kinds, x_periodic, sheet = set(), set(), False, False
    for case in STEP_CASES:
        plan = lower(CASES[case]())
        poles.add(len(plan.poles))
        kinds.update(k for pair in plan.boundaries for k in pair)
        x_periodic |= plan.boundaries[0][0] == "periodic"
        sheet |= len({sp.comp for sp in plan.sources}) > 2
    assert {0, 1, 3} <= poles
    assert kinds == {"pec", "pmc", "periodic"}
    assert x_periodic and sheet


def test_fused_step_sources_inside_the_step():
    """The J terms land on E' before the H half-step reads it: E' is the
    source-free E' plus the terms, and H' differs from the source-free
    H'."""
    port = FDTDRunner(lower(CASES["sheet_lorentz"]()), device="cpu")
    st = port.init_state()
    src = port.step_sources("E", STEP)
    with_src = fused_kernels.fused_step(st, port.consts, port.meta, src)
    without = fused_kernels.fused_step(st, port.consts, port.meta, [])
    for comp, sl, term, w in src:
        without[0][comp][sl].add_(term * w)
    for comp in ("Ex", "Ey", "Ez"):
        assert torch.equal(with_src[0][comp], without[0][comp])
    assert any(not torch.equal(with_src[1][c], without[1][c])
               for c in ("Hx", "Hy", "Hz"))


def _interp_sim():
    """Lorentz half-space, dipole and field plane on a grid the JAX fused
    tier and its x-CPML pass take (nx a multiple of 8, 8-wide x-PML
    slabs)."""
    return tt.Simulation(
        center=(0, 0, 0), size=(1.0, 0.8, 0.8), run_time=1e-14,
        sources=[tt.PointDipole(
            center=(0.05, 0.0, -0.1), polarization="Ez",
            source_time=tt.GaussianPulse(freq0=FREQ0, fwidth=FREQ0 / 5))],
        structures=[tt.Structure(
            geometry=tt.Box(center=(0, 0, 0.2), size=(tt.inf, tt.inf, 0.4)),
            medium=LORENTZ)],
        monitors=[tt.FieldMonitor(center=(0, 0, 0.05), size=(tt.inf, tt.inf, 0),
                                  freqs=[FREQ0], name="f")],
        boundary_spec=tt.BoundarySpec(
            x=tt.Boundary.pml(num_layers=7), y=tt.Boundary.periodic(),
            z=tt.Boundary.pml(num_layers=7)),
        grid_spec=tt.GridSpec.uniform(dl=0.1), shutoff=0.0)


def test_raw_monitors_match_fused_interpret(monkeypatch):
    monkeypatch.delenv("TIDY3D_TPU_TILE_QUANTA", raising=False)
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "fused_interpret")
    monkeypatch.setenv("TIDY3D_TPU_PAD_ALIGN", "0")
    plan = lower(_interp_sim())
    assert plan.poles
    jr = JaxRunner(plan)
    assert jr.fused is not None and jr.fused.fixup_ok, \
        "JAX fused tier with its x-CPML pass not selected"
    ref = jr.run()
    port = FDTDRunner(plan, device="cpu", kernel="fused")
    got = port.run()
    assert port.steps_run == jr.steps_run
    assert set(got) == set(ref)
    for idx in ref:
        err = max_rel_err(ref[idx], got[idx])
        assert err <= TOL_PALLAS, f"monitor {idx}: rel err {err:.2e}"


# --------------------------------------------------------------------------- #
# kernel against plain version, on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(case, cuda):
    port = FDTDRunner(lower(CASES[case]()), device=cuda, kernel="fused")
    rng = np.random.default_rng(5)
    st = random_state(rng, port.shape, port.psi_shapes(),
                      port.consts["pole_scalars"])
    src = port.step_sources("E", STEP)
    outs = []
    for fn in (fused_kernels.fused_step, fused_kernels.fused_step_reference):
        before = fused_kernels.LAUNCHES
        nE, nH, psi, Q = fn(convert.state_from_reference(st, port),
                            port.consts, port.meta, src)
        torch.cuda.synchronize()
        assert fused_kernels.LAUNCHES == before + (
            fn is fused_kernels.fused_step)
        outs.append(_flat(convert.state_to_reference(
            {"E": nE, "H": nH, "psi": psi, "Q": Q})))
    _check_groups(outs[1], outs[0], TOL_XLA, f"{case} fused kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lorentz_mixed", "gold_halfspace",
                                  "sheet_lorentz"])
def test_kernel_runner_matches_plain_runner(case, cuda):
    """40 whole steps on the kernel and on the plain versions: 2e-5."""
    plan = lower(CASES[case]())
    finals = []
    for use_kernel in (True, False):
        runner = FDTDRunner(plan, device=cuda, kernel="fused",
                            use_kernel=use_kernel)
        state = runner.run_steps(0, 40, runner.init_state())
        finals.append({c: v.cpu().numpy() for fam in ("E", "H")
                       for c, v in state[fam].items()})
    assert max(np.max(np.abs(v)) for v in finals[1].values()) > 0
    assert max_rel_err(finals[1], finals[0]) <= 2e-5
