"""Dispersive (pole-residue) media in the port against the JAX package.

The E family update with the pole currents' term, the pole-current update
on mask-compressed and dense residues (a purely real Drude pole included),
and ``tidy3d_tpu_torch.web.run`` of small Lorentz, Drude and 7-pole Au runs
on both kernel tiers, each against the JAX runner's XLA path. The tier
selection rules are checked at the end; the kernel-against-plain test of
the family kernel's pole term needs a CUDA card and skips without one.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch import convert
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner, update_poles
from tidy3d_tpu_torch.solver.kernels import step as step_kernels

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    DISPERSIVE, lower_reference as lower, max_rel_err, monitors, random_state,
    SIMS, to_reference,
)
from tidy3d_tpu import web as ref_web
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

TOL_XLA = 1e-6      # float32 rounding of the same expression tree
TOL_RUN = 2e-5      # the reference's own bar for whole runs
POLE_CASES = ["lorentz_mixed", "drude_periodic", "lorentz3_pml",
              "gold_halfspace"]


@pytest.fixture(autouse=True)
def _xla(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "xla")


def _dense(plan):
    """The plan with every residue as a dense map graded along x (the
    layout a spatially varying medium lowers to)."""
    nx = plan.shape[0]
    ramp = (1.0 + 0.5 * np.arange(nx) / nx).reshape(-1, 1, 1)
    for pp in plan.poles:
        pp.c_maps = tuple(m * ramp for m in
                          pp.dense_c_maps(plan.pole_masks, plan.shape))
    return plan


def _case(name, dense=False):
    plan = lower(DISPERSIVE[name]())
    return _dense(plan) if dense else plan


def _random(port, seed):
    return random_state(np.random.default_rng(seed), port.shape,
                        port.psi_shapes(), port.consts["pole_scalars"])


@pytest.mark.parametrize("case", POLE_CASES)
def test_family_update_with_poles_matches_xla(case):
    plan = _case(case)
    jr = JaxRunner(plan)
    port = FDTDRunner(plan, device="cpu")
    st = _random(port, 3)
    assert len(st["Q"]) == len(plan.poles) > 0
    consts = jax.device_put(jr.consts)
    fields, psi = jax.jit(
        lambda s, c: jr._update_field_family(0, s, c, "E"))(
            jax.device_put(dict(st, mon=[])), consts)
    got_f, got_p = step_kernels.family_update(
        "E", convert.state_from_reference(st, port), port.consts,
        convert.state_from_reference(st, port)["H"], port.meta)
    err = max_rel_err({c: np.asarray(v) for c, v in fields.items()},
                      {c: v.numpy() for c, v in got_f.items()})
    assert err <= TOL_XLA, f"fields rel err {err:.2e}"
    err = max_rel_err({k: np.asarray(v) for k, v in psi.items()},
                      {k: v.numpy() for k, v in got_p.items()})
    assert err <= TOL_XLA, f"psi rel err {err:.2e}"
    # the pole term is really there: without Q the update differs
    st0 = dict(st, Q=[{c: (0 * qr, 0 * qi) for c, (qr, qi) in Qp.items()}
                      for Qp in st["Q"]])
    f0, _ = step_kernels.family_update_reference(
        "E", convert.state_from_reference(st0, port), port.consts,
        convert.state_from_reference(st0, port)["H"], port.meta)
    assert max_rel_err({c: v.numpy() for c, v in got_f.items()},
                       {c: v.numpy() for c, v in f0.items()}) > 1e-3


@pytest.mark.parametrize("case,dense", [
    ("lorentz_mixed", False), ("drude_periodic", False),
    ("gold_halfspace", False), ("lorentz_mixed", True),
    ("gold_halfspace", True)])
def test_update_poles_matches_xla(case, dense):
    plan = _case(case, dense)
    jr = JaxRunner(plan)
    port = FDTDRunner(plan, device="cpu")
    kinds = {m["kind"] for metas in port.consts["pole_B_meta"]
             for m in metas}
    assert kinds == ({"dense"} if dense else {"mask"})
    if case == "drude_periodic":
        assert all(A.imag == 0 and Gc.imag == 0
                   for A, Gc in port.consts["pole_scalars"])
    st = _random(port, 9)
    rng = np.random.default_rng(10)
    new_e = {c: rng.standard_normal(port.shape).astype(np.float32)
             for c in ("Ex", "Ey", "Ez")}
    view = {"E": st["E"], "Q": st["Q"]}
    ref = jax.device_get(jax.jit(lambda ne, v, c: jr._update_poles(ne, v, c))(
        jax.device_put(new_e), jax.device_put(view),
        jax.device_put(jr.consts)))
    state = convert.state_from_reference(st, port)
    q_before = [{c: (qr.data_ptr(), qi.data_ptr())
                 for c, (qr, qi) in Qp.items()} for Qp in state["Q"]]
    got = update_poles({c: torch.from_numpy(v) for c, v in new_e.items()},
                       state["E"], state["Q"], port.consts)
    # in place: the same buffers carry the new currents
    assert [{c: (qr.data_ptr(), qi.data_ptr()) for c, (qr, qi) in Qp.items()}
            for Qp in got] == q_before
    for pi, (rq, gq) in enumerate(zip(ref, got)):
        r = {f"{c}{p}": np.asarray(v[p]) for c, v in rq.items()
             for p in range(2)}
        g = {f"{c}{p}": v[p].numpy() for c, v in gq.items() for p in range(2)}
        err = max_rel_err(r, g)
        assert err <= TOL_XLA, f"pole {pi}: rel err {err:.2e}"


WEB_CASES = ["lorentz_mixed", "drude_periodic", "gold_halfspace"]


def _web_sim(case):
    mons = [m for m in monitors() if m.name != "time"]
    return DISPERSIVE[case](monitors=mons, run_time=1.5e-14)


@functools.lru_cache(maxsize=None)
def _ref_web(case):
    return ref_web.run(to_reference(_web_sim(case)), verbose=False)


@pytest.mark.parametrize("tier", ["fused", "pallas2"])
@pytest.mark.parametrize("case", WEB_CASES)
def test_web_run_dispersive_matches_reference(case, tier, monkeypatch):
    ref = _ref_web(case)
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", tier)
    got = tt.web.run(_web_sim(case), device="cpu", verbose=False)
    assert f"kernel tier: {tier}" in got.log
    flux_r, flux_g = ref["flux"].flux.values, got["flux"].flux.values
    assert np.all(np.isfinite(flux_g)) and np.any(flux_g != 0)
    err = np.max(np.abs(flux_r - flux_g)) / np.max(np.abs(flux_r))
    assert err <= TOL_RUN, f"flux rel err {err:.2e}"
    comps = ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")
    err = max_rel_err({c: getattr(ref["field"], c).values for c in comps},
                      {c: getattr(got["field"], c).values for c in comps})
    assert err <= TOL_RUN, f"field rel err {err:.2e}"


def _many_dipoles(n):
    sim = SIMS["pml_all"]()
    src = sim.sources[0]
    return sim.copy(update=dict(sources=[
        src.copy(update=dict(center=(0.0, 0.0, -0.35 + 0.02 * i),
                             polarization="Ex")) for i in range(n)]))


def test_tier_selection(monkeypatch):
    monkeypatch.delenv("TIDY3D_TPU_KERNEL")
    plan = _case("gold_halfspace")
    assert FDTDRunner(plan, device="cpu").tier == "fused"
    for env, tier in (("auto", "fused"), ("fused", "fused"),
                      ("pallas2", "pallas2"), ("xla", "pallas2"),
                      ("pallas2_interpret", "pallas2")):
        monkeypatch.setenv("TIDY3D_TPU_KERNEL", env)
        assert FDTDRunner(plan, device="cpu").tier == tier, env
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    # more J source terms than the fused kernel's table holds
    crowded = lower(_many_dipoles(33))
    assert sum(sp.comp[0] == "E" for sp in crowded.sources) == 33
    assert FDTDRunner(crowded, device="cpu").tier == "pallas2"
    with pytest.raises(ValueError, match="fused tier does not take"):
        FDTDRunner(crowded, device="cpu", kernel="fused")
    with pytest.raises(ValueError, match="TIDY3D_TPU_KERNEL"):
        FDTDRunner(plan, device="cpu", kernel="triton")
    # the k-step tier: forced by name; auto on the CPU stays fused
    for env in ("kstep", "kstep_interpret"):
        monkeypatch.setenv("TIDY3D_TPU_KERNEL", env)
        runner = FDTDRunner(plan, device="cpu")
        assert (runner.tier, runner.k) == ("kstep", 2), env
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    light = lower(DISPERSIVE["lorentz_mixed"]())
    assert FDTDRunner(light, device="cpu").tier == "fused"
    assert FDTDRunner(light, device="cpu", kernel="kstep").k == 2
    # k = 4 is tried first and refused: the kernel is built for k = 2
    monkeypatch.setenv("TIDY3D_TPU_KSTEP", "4")
    assert FDTDRunner(light, device="cpu", kernel="kstep").k == 2
    assert FDTDRunner(plan, device="cpu", kernel="kstep").k == 2
    monkeypatch.setenv("TIDY3D_TPU_KSTEP", "0")
    with pytest.raises(ValueError, match="kstep tier does not take"):
        FDTDRunner(light, device="cpu", kernel="kstep")
    monkeypatch.delenv("TIDY3D_TPU_KSTEP")
    # a time monitor whose samples miss the group ends
    unaligned = lower(SIMS["pml_all"](monitors=monitors()))
    assert unaligned.monitors[-1].t_start % 2 != 1
    with pytest.raises(ValueError, match="kstep tier does not take"):
        FDTDRunner(unaligned, device="cpu", kernel="kstep")
    assert FDTDRunner(unaligned, device="cpu").tier == "fused"


def test_web_run_logs_the_tier(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    data = tt.web.run(SIMS["pml_all"](), device="cpu", verbose=False)
    assert data.log.splitlines()[-1] == (
        "kernel tier: fused"
        " [storage: fields float32, psi float32, Q float32]")


# --------------------------------------------------------------------------- #
# the family kernel's pole term against its plain version, on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", POLE_CASES)
def test_family_kernel_pole_term_matches_plain(case, cuda):
    port = FDTDRunner(_case(case), device=cuda, kernel="pallas2")
    st = _random(port, 5)
    outs = []
    for fn in (step_kernels.family_update,
               step_kernels.family_update_reference):
        state = convert.state_from_reference(st, port)
        before = step_kernels.LAUNCHES
        fields, psi = fn("E", state, port.consts, state["H"], port.meta)
        torch.cuda.synchronize()
        assert step_kernels.LAUNCHES == before + (
            fn is step_kernels.family_update)
        outs.append({c: v.cpu().numpy() for c, v in fields.items()})
    err = max_rel_err(outs[1], outs[0])
    assert err <= TOL_XLA, f"{case}: rel err {err:.2e}"
