"""The port's runner against the JAX runner's XLA path.

Raw E/H after 40 steps (the harness of ``tests/test_solver/test_kstep.py``)
and the raw-monitor dicts of a whole run, on a 3D CPML simulation with a
field, a flux and a field-time monitor. The bar, 2e-5 relative to the
largest magnitude across components, is the one the reference holds its
own kernels to.
"""

import jax
import numpy as np
import pytest

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    lower_reference as lower, max_rel_err, monitors, SIMS,
)
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

from tidy3d_tpu_torch.exceptions import DivergenceError
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner

TOL = 2e-5
NSTEPS = 40


@pytest.fixture(autouse=True)
def _xla(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "xla")


def _jax_fields(plan, nsteps):
    runner = JaxRunner(plan)
    runner._pad_time_tables(nsteps)
    consts = jax.device_put(runner.consts)
    state = jax.jit(runner.init_state)()
    state = jax.jit(lambda st: runner._run_chunk(0, nsteps, st, consts))(state)
    return {c: np.asarray(v) for fam in ("E", "H")
            for c, v in state[fam].items()}


def _port_fields(plan, nsteps):
    runner = FDTDRunner(plan, device="cpu")
    runner._pad_time_tables(nsteps)
    state = runner.run_steps(0, nsteps, runner.init_state())
    return {c: v.numpy() for fam in ("E", "H")
            for c, v in state[fam].items()}


@pytest.mark.parametrize("case", ["pml_all", "dielectric_mixed", "periodic"])
def test_fields_after_40_steps(case):
    plan = lower(SIMS[case](monitors=monitors()))
    ref = _jax_fields(plan, NSTEPS)
    got = _port_fields(plan, NSTEPS)
    assert max(np.max(np.abs(v)) for v in ref.values()) > 0
    for c in got:
        assert np.all(np.isfinite(got[c])), c
    err = max_rel_err(ref, got)
    assert err <= TOL, f"rel err {err:.2e}"


def test_raw_monitors_match():
    plan = lower(SIMS["pml_all"](monitors=monitors(), run_time=2e-14))
    ref_runner = JaxRunner(plan)
    ref = ref_runner.run()
    runner = FDTDRunner(plan, device="cpu")
    got = runner.run()
    assert runner.steps_run == ref_runner.steps_run
    assert runner.final_decay == pytest.approx(ref_runner.final_decay,
                                               rel=1e-4)
    assert set(got) == set(ref)
    kinds = set()
    for idx in ref:
        kinds.add(plan.monitors[idx].kind)
        assert set(got[idx]) == set(ref[idx])
        for comp in ref[idx]:
            assert got[idx][comp].shape == ref[idx][comp].shape
            assert got[idx][comp].dtype == ref[idx][comp].dtype
        err = max_rel_err(ref[idx], got[idx])
        assert err <= TOL, f"monitor {idx}: rel err {err:.2e}"
    assert kinds == {"field", "field_time"}
    for name in ("wall_time", "compile_time", "transfer_time"):
        assert getattr(runner, name) >= 0


def test_shutoff_stops_early():
    plan = lower(SIMS["pml_all"](run_time=6e-14).copy(
        update=dict(shutoff=1e-2)))
    ref_runner = JaxRunner(plan)
    ref_runner.run()
    runner = FDTDRunner(plan, device="cpu")
    runner.run()
    assert runner.steps_run < plan.num_steps
    assert runner.steps_run == ref_runner.steps_run


def test_divergence_raises():
    plan = lower(SIMS["pml_all"]())
    runner = FDTDRunner(plan, device="cpu")
    # an unstable update: ca > 1 grows every field without bound
    runner.consts["coeffs_E"] = {c: (1e30, cb) for c, (_, cb)
                                 in runner.consts["coeffs_E"].items()}
    with pytest.raises(DivergenceError):
        runner.run()
