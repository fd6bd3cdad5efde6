"""Bloch (complex) runs on the port's ``pallas2`` tier against the JAX
package's XLA step.

The k-step kernel takes a Bloch run only without poles, modulation, time
monitors off its group ends and with at most 64 source terms; every other
Bloch plan steps on ``pallas2``: the E family of both real copies (one
launch of ``csrc/step.cu``'s two-copy instantiation on a card), then per
copy its J sources, the modulation pass and the pole update (copy 1 with
its own currents ``Q1``), then the H family of both copies, as the JAX
package's ``_step`` does (``tidy3d_tpu/solver/fdtd.py:1620-1723``).
Checked on the CPU: one step from a seeded random two-copy state (fields,
psi and both copies' pole currents to 1e-6 of the largest magnitude over
both copies); whole runs, raw monitors to 2e-5; ``web.run``'s
``SimulationData`` against the JAX builders; a checkpointed run's resume;
bf16 storage within 1e-2 of the JAX XLA path at the same storage (the
JAX package has no one-step kernel for copies); the tier choice.

The kernel-against-plain tests at the end need a CUDA card and skip
without one.
"""

import os

import jax
import numpy as np
import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch import convert
from tidy3d_tpu_torch.solver import fdtd as port_fdtd
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.kernels import step as step_kernels

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    BLOCH, DRUDE, FREQ0, lower_reference as lower, max_rel_err, random_state,
    to_reference,
)
from tests.test_torch_bloch import _values
from tests.test_torch_nonlinear import _mod, _raw_err
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner
from tidy3d_tpu.web.run import assemble_sim_data as ref_assemble

TOL = 2e-5
TOL_STEP = 1e-6
TOL_BF16 = 1e-2
STEP = 20
LORENTZ3 = tt.Lorentz(eps_inf=1.5, coeffs=[
    (2.0, 1.6 * FREQ0, FREQ0 / 8), (1.0, 2.3 * FREQ0, FREQ0 / 5),
    (0.5, 0.8 * FREQ0, FREQ0 / 12)])
BOX = tt.Box(center=(0.05, 0.0, 0.1), size=(0.3, 0.3, 0.3))


@pytest.fixture(autouse=True)
def _auto(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    monkeypatch.delenv("TIDY3D_TPU_KSTEP", raising=False)


def _monitors():
    """A field plane, a flux box and a default-start field-time monitor
    (every step: off the k-step tier's group ends)."""
    freqs = [0.9 * FREQ0, FREQ0, 1.1 * FREQ0]
    return [
        tt.FieldMonitor(center=(0, 0, 0.05), size=(0.4, 0.3, 0),
                        freqs=freqs, name="field"),
        tt.FluxMonitor(center=(0, 0, 0), size=(0.3, 0.25, 0.4),
                       freqs=freqs, name="flux"),
        tt.FieldTimeMonitor(center=(0, 0, 0), size=(0.2, 0.2, 0.2),
                            name="time"),
    ]


def _with(medium):
    def make(**kw):
        return BLOCH["bloch_dipole"](**kw).copy(update=dict(structures=[
            tt.Structure(geometry=BOX, medium=medium)]))
    return make


CASES = {
    "drude": _with(DRUDE),
    "lorentz3": _with(LORENTZ3),
    "modulated": _with(_mod(eps=True, sigma=True)),
    "dipole_time": BLOCH["bloch_dipole"],
}


def _sim(case, run_time=3.5e-15, monitors=True):
    return CASES[case](monitors=_monitors() if monitors else [],
                       run_time=run_time)


def _state(port, seed):
    """A random two-copy state in the reference's layout, H scaled so that
    its curl moves E by about as much as E is."""
    rng = np.random.default_rng(seed)
    scalars = port.consts["pole_scalars"]
    out = {}
    for e, h, p, q in (("E", "H", "psi", "Q"), ("E1", "H1", "psi1", "Q1")):
        st = random_state(rng, port.shape, port.psi_shapes(), scalars)
        out.update({e: st["E"], p: st["psi"], q: st["Q"],
                    h: {c: np.float32(1e-2) * v for c, v in st["H"].items()}})
    return out


def _by_family(state: dict) -> dict:
    """Both copies of each kind in one dict, so that an error is relative
    to the largest magnitude over both copies."""
    out = {}
    for fam in ("E", "H", "psi"):
        out[fam] = {f"{c}:{key}": np.asarray(v)
                    for c, name in enumerate((fam, fam + "1"))
                    for key, v in state[name].items()}
    out["Q"] = {f"{c}:{p}:{comp}:{part}": np.asarray(v)
                for c, name in enumerate(("Q", "Q1"))
                for p, Qp in enumerate(state[name])
                for comp, pair in Qp.items() for part, v in enumerate(pair)}
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_xla(case):
    plan = lower(_sim(case, monitors=False))
    jr = JaxRunner(plan)
    assert jr.kstep is None and jr.is_complex
    port = FDTDRunner(plan, device="cpu", kernel="pallas2")
    assert port.tier == "pallas2" and port.is_complex
    st = _state(port, 5)
    ref = jax.device_get(jr._step(STEP, jax.device_put(dict(st, mon=[])),
                                  jax.device_put(jr.consts)))
    got = convert.state_to_reference(
        port.step(STEP, convert.state_from_reference(st, port)))
    ref, got = _by_family(ref), _by_family(got)
    assert set(ref) == set(got)
    for fam in ref:
        if not ref[fam]:
            continue
        assert set(ref[fam]) == set(got[fam]), fam
        err = max_rel_err(ref[fam], got[fam])
        assert err <= TOL_STEP, f"{case} {fam}: rel err {err:.2e}"
    assert bool(ref["Q"]) == bool(plan.poles)


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_matches_xla(case):
    plan = lower(_sim(case))
    port = FDTDRunner(plan, device="cpu")
    assert port.tier == "pallas2" and port.k == 1
    ref = JaxRunner(plan).run()
    got = port.run()
    assert any(np.iscomplexobj(v) and np.any(np.imag(v))
               for mon in got.values() for v in mon.values())
    err = _raw_err(ref, got)
    assert err <= TOL, f"{case}: rel err {err:.2e}"


def test_web_run_matches_reference_builders():
    """``web.run`` of the Bloch Drude case: the field, flux and field-time
    builders on the port's data against the JAX package's on the raw data
    of its XLA runner."""
    sim = _sim("drude")
    plan = lower(sim)
    jr = JaxRunner(plan)
    ref = _values(ref_assemble(to_reference(sim), plan, jr.run(), jr))
    data = tt.web.run(sim, device="cpu", verbose=False)
    assert "kernel tier: pallas2" in data.log
    got = _values(data)
    assert set(got) == set(ref) and {"field.Ez", "flux.flux",
                                     "time.Ez"} <= set(ref)
    # each array relative to the largest magnitude over its monitor's
    # components of its family, the raw monitors' bar
    scale = {}
    for key, (vals, _) in ref.items():
        group = key.split(".")[0] + key.split(".")[1][0]
        scale[group] = max(scale.get(group, 0.0), float(np.max(np.abs(vals))))
    for key, (vals, _) in ref.items():
        group = key.split(".")[0] + key.split(".")[1][0]
        err = float(np.max(np.abs(got[key][0] - vals))) / (scale[group]
                                                           + 1e-30)
        assert err <= TOL, f"{key}: rel err {err:.2e}"


def test_checkpoint_resume_is_exact(tmp_path):
    """Half of the chunks by hand, saved (``Q1`` with them), then a fresh
    runner resumes and ends bit-equal to the uninterrupted run."""
    plan = lower(_sim("drude", run_time=2e-15))
    ref = FDTDRunner(plan, device="cpu").run()
    r1 = FDTDRunner(plan, device="cpu")
    chunk, num_chunks = r1.chunking()
    state, max_ever, cur = r1.init_state(), 0.0, 0.0
    for ci in range(num_chunks // 2):
        state = r1.run_steps(ci * chunk, chunk, state)
        cur = float(r1._max_field(state))
        max_ever = max(max_ever, cur)
    ckpt = str(tmp_path / "bloch.npz")
    r1.save_checkpoint(ckpt, state, num_chunks // 2, max_ever, cur)
    with np.load(ckpt) as data:
        assert "Q1.0.Ez.im" in data.files and "E1.Ex" in data.files
        assert np.any(data["Q.0.Ez.re"])
    out = FDTDRunner(plan, device="cpu").run_checkpointed(ckpt)
    assert not os.path.exists(ckpt)
    for idx in ref:
        for comp, arr in ref[idx].items():
            np.testing.assert_array_equal(out[idx][comp], arr)


def test_bf16_run_matches_xla():
    """bf16 storage on the Bloch Drude case against the JAX XLA path at
    the same storage."""
    plan = lower(_sim("drude", run_time=2e-15))
    ref = JaxRunner(plan, precision="bfloat16").run()
    port = FDTDRunner(plan, device="cpu", precision="bfloat16")
    assert port.tier == "pallas2" and port.q_dtype == torch.bfloat16
    assert port.init_state()["Q1"][0]["Ex"][0].dtype == torch.bfloat16
    err = _raw_err(ref, port.run())
    print(f"[bf16] Bloch Drude pallas2 vs XLA: {err:.2e}")
    assert err <= TOL_BF16


def test_tier_choice():
    """kstep where it takes the run, else pallas2, on either device; a
    forced fused raises; a forced pallas2 takes the pole-free dipole."""
    one = {"E": 1, "H": 0}
    for case in sorted(CASES):
        plan = lower(_sim(case))
        for device in ("cpu", "cuda"):
            assert port_fdtd.select_tier(plan, one, device) == \
                ("pallas2", 1), case
        with pytest.raises(ValueError, match="no Bloch copies"):
            port_fdtd.select_tier(plan, one, "cpu", "fused")
    grouped = lower(_sim("dipole_time", monitors=False))
    assert port_fdtd.select_tier(grouped, one, "cuda") == ("kstep", 2)
    assert port_fdtd.select_tier(grouped, one, "cuda", "pallas2") == \
        ("pallas2", 1)
    est = FDTDRunner(lower(_sim("drude")), device="cpu") \
        .estimate_device_memory()
    assert est["state"] > 0 and est["work"] > 0


# --------------------------------------------------------------------------- #
# the two-copy kernel against its plain version, on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES) + ["bloch_x_pec",
                                                  "bloch_planewave"])
def test_bloch_family_kernel_matches_plain(case, precision, cuda):
    """One family of both copies in one call of the two-copy instantiation
    against the plain version copy by copy (1e-6 in float32, 1e-2 in
    bf16)."""
    from tidy3d_tpu_torch.solver.lowering import lower as port_lower

    sim = _sim(case) if case in CASES else BLOCH[case]()
    port = FDTDRunner(port_lower(sim), device=cuda, kernel="pallas2",
                      precision=precision)
    state = convert.state_from_reference(_state(port, 9), port)
    views = port._views(state)
    tol = TOL_STEP if precision == "float32" else TOL_BF16
    for fam in ("E", "H"):
        srcs = [v["H"] if fam == "E" else v["E"] for v in views]
        before = step_kernels.BLOCH_LAUNCHES
        got = step_kernels.family_update_copies(fam, views, port.consts,
                                                srcs, port.meta)
        assert step_kernels.BLOCH_LAUNCHES == before + 1
        ref = step_kernels.family_update_copies_reference(
            fam, views, port.consts, srcs, port.meta)
        flat = [{f"{p}:{k}": v.float().cpu().numpy()
                 for p, (f, s) in enumerate(out)
                 for k, v in list(f.items()) + list(s.items())}
                for out in (ref, got)]
        err = max_rel_err(*flat)
        assert err <= tol, f"{case} {fam}: {err:.2e}"
