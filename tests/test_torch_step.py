"""The family update of the port against the JAX package.

``family_update_reference`` (the plain PyTorch version) steps a random state
through one E and one H half-step; the JAX runner's XLA
``_update_field_family`` does the same on the same numpy inputs. One tiny
case also goes through the TPU kernel ``PallasStepper.family_update`` in
interpret mode, with its transposed z-psi layout mapped by ``convert``.

The kernel-against-plain tests at the end need a CUDA card and skip
without one.
"""

import jax
import numpy as np
import pytest
import torch

from tidy3d_tpu_torch import convert
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.kernels import step as step_kernels

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    lower_reference as lower, max_rel_err, random_state, SIMS,
)
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

TOL_XLA = 1e-6      # float32 rounding of the same expression tree
TOL_PALLAS = 1e-5   # the reference's own Pallas-vs-XLA bar


def _jax_runner(sim, kernel, monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", kernel)
    return JaxRunner(lower(sim))


def _jax_family(runner, state_np, family, newE=None):
    """One family update on the JAX runner; numpy (fields, psi) out."""
    consts = jax.device_put(runner.consts)
    st = jax.device_put(dict(state_np, Q=[], mon=[]))
    nE = jax.device_put(newE) if newE is not None else None

    def fn(st, consts, nE):
        return runner._update_field_family(0, st, consts, family, newE=nE)

    fields, psi = jax.jit(fn)(st, consts, nE)
    return ({c: np.asarray(v) for c, v in fields.items()},
            {k: np.asarray(v) for k, v in psi.items()})


def _port_family(runner, state_np, family, newE=None, fn=None):
    fn = fn or step_kernels.family_update
    state = convert.state_from_reference(state_np, runner)
    src = state["H"] if family == "E" else {
        c: torch.from_numpy(v).to(runner.device) for c, v in newE.items()}
    fields, psi = fn(family, state, runner.consts, src, runner.meta)
    return ({c: v.cpu().numpy() for c, v in fields.items()},
            {k: v.cpu().numpy() for k, v in psi.items()})


def _check(ref, got, tol, what):
    ref_f, ref_p = ref
    got_f, got_p = got
    assert set(ref_f) == set(got_f)
    assert set(ref_p) == set(got_p), f"{what}: psi keys differ"
    err_f = max_rel_err(ref_f, got_f)
    assert err_f <= tol, f"{what}: fields rel err {err_f:.2e}"
    if ref_p:
        err_p = max_rel_err(ref_p, got_p)
        assert err_p <= tol, f"{what}: psi rel err {err_p:.2e}"


@pytest.mark.parametrize("case", sorted(SIMS))
def test_family_update_matches_xla(case, monkeypatch):
    sim = SIMS[case]()
    jr = _jax_runner(sim, "xla", monkeypatch)
    port = FDTDRunner(lower(sim), device="cpu")
    assert port.psi_shapes() == {
        k: tuple(v.shape) for k, v in jr.init_state()["psi"].items()}
    rng = np.random.default_rng(7)
    st = random_state(rng, port.shape, port.psi_shapes())
    _check(_jax_family(jr, st, "E"), _port_family(port, st, "E"), TOL_XLA,
           f"{case} E")
    newE = {c: rng.standard_normal(port.shape).astype(np.float32)
            for c in ("Ex", "Ey", "Ez")}
    _check(_jax_family(jr, st, "H", newE), _port_family(port, st, "H", newE),
           TOL_XLA, f"{case} H")


def test_cases_cover_arrays_and_walls():
    """The case set reaches per-cell ca/cb and every wall kind."""
    kinds = set()
    arrays = False
    for make in SIMS.values():
        plan = lower(make())
        kinds.update(k for pair in plan.boundaries for k in pair)
        runner = FDTDRunner(plan, device="cpu")
        arrays |= any(isinstance(v, torch.Tensor)
                      for ab in runner.consts["coeffs_E"].values() for v in ab)
    assert kinds == {"pec", "pmc", "periodic"}
    assert arrays


def test_family_update_matches_pallas_interpret(monkeypatch):
    sim = SIMS["dielectric_mixed"]()
    jr = _jax_runner(sim, "pallas2_interpret", monkeypatch)
    assert jr.pallas is not None, "two-phase Pallas tier not selected"
    port = FDTDRunner(lower(sim), device="cpu")
    rng = np.random.default_rng(11)
    st = random_state(rng, port.shape, port.psi_shapes())
    st_pallas = convert.state_to_reference(
        convert.state_from_reference(st, port), z_transposed=True)
    ref_f, ref_p = _jax_family(jr, st_pallas, "E")
    ref_p = {k: (np.transpose(v, (0, 2, 1)) if k.split("|")[1] == "2"
                 else v) for k, v in ref_p.items()}
    _check((ref_f, ref_p), _port_family(port, st, "E"), TOL_PALLAS,
           "pallas E")


def test_convert_round_trip():
    port = FDTDRunner(lower(SIMS["pml_all"]()), device="cpu")
    st = random_state(np.random.default_rng(3), port.shape,
                      port.psi_shapes())
    for zt in (False, True):
        ref = convert.state_to_reference(
            convert.state_from_reference(st, port), z_transposed=zt)
        back = convert.state_to_reference(
            convert.state_from_reference(ref, port, z_transposed=zt))
        for fam in ("E", "H", "psi"):
            for k, v in st[fam].items():
                assert np.array_equal(back[fam][k], v)


def test_cpu_dispatch_counts_no_launch():
    port = FDTDRunner(lower(SIMS["pml_all"]()), device="cpu")
    state = port.init_state()
    before = step_kernels.LAUNCHES
    step_kernels.family_update("E", state, port.consts, state["H"],
                               port.meta)
    assert step_kernels.LAUNCHES == before


# --------------------------------------------------------------------------- #
# kernel against plain version, on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SIMS))
def test_kernel_matches_plain(case, cuda):
    port = FDTDRunner(lower(SIMS[case]()), device=cuda)
    rng = np.random.default_rng(5)
    st = random_state(rng, port.shape, port.psi_shapes())
    newE = {c: rng.standard_normal(port.shape).astype(np.float32)
            for c in ("Ex", "Ey", "Ez")}
    for fam, nE in (("E", None), ("H", newE)):
        before = step_kernels.LAUNCHES
        got = _port_family(port, st, fam, nE)
        assert step_kernels.LAUNCHES == before + 1
        ref = _port_family(port, st, fam, nE,
                           fn=step_kernels.family_update_reference)
        _check(ref, got, TOL_XLA, f"{case} {fam} kernel")
