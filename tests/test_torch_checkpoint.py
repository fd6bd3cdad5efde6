"""Checkpoint and resume of the port's time loop: the JAX package's two
tests (``tests/test_solver/test_checkpoint.py``) on every tier, a Bloch run
and a sharded run, and the refusal of a file of another run.

A resumed run's raw monitors equal the uninterrupted run's to 1e-6 of each
array's largest magnitude (the reference's bar; on the CPU they are equal
bit for bit), and ``steps_run`` is the same. Cases: the one-pole Lorentz
case (pole currents in the state) on the ``kstep``, ``fused`` and
``pallas2`` tiers, the Bloch dipole (two copies of the fields on the kstep
tier) and the Lorentz case grown to 24 x planes over 4 virtual x-shards.
"""

import os

import numpy as np
import pytest

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch.exceptions import SetupError
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.lowering import lower
from tidy3d_tpu_torch.solver.sharding import ShardingPlan, make_mesh

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import BLOCH, DISPERSIVE, DL, FREQ0, SIMS

TOL = 1e-6          # tests/test_solver/test_checkpoint.py:41-45
NX = 24             # 4 shards of 6 planes hold the 4-plane x-PML slabs


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for key in ("TIDY3D_TPU_KERNEL", "TIDY3D_TPU_KSTEP", "TIDY3D_TPU_SHARD"):
        monkeypatch.delenv(key, raising=False)


def _monitors():
    """A field plane and a flux box (the DFT) and a field-time box whose
    samples land on the ends of 2-step groups."""
    freqs = list(np.linspace(0.9 * FREQ0, 1.1 * FREQ0, 3))
    return [
        tt.FieldMonitor(center=(0, 0, 0.05), size=(0.4, 0.3, 0),
                        freqs=freqs, name="field"),
        tt.FluxMonitor(center=(0, 0, 0), size=(0.3, 0.25, 0.4),
                       freqs=freqs, name="flux"),
        tt.FieldTimeMonitor(center=(0, 0, 0), size=(0.2, 0.2, 0.2),
                            start=2.5 * lower(SIMS["pml_all"]()).dt,
                            interval=4, name="time"),
    ]


def _grown(sim, nx: int = NX):
    """``sim`` with its x size grown so that the grid has ``nx`` x
    planes."""
    for n in range(int(round(sim.size[0] / DL)), 4 * nx):
        new = sim.copy(update=dict(
            size=(round(n * DL, 9),) + tuple(sim.size[1:])))
        if lower(new).shape[0] == nx:
            return new
    raise ValueError(f"no x size gives {nx} planes")


def _sim(case: str):
    if case == "bloch":
        return BLOCH["bloch_dipole"](monitors=_monitors())
    sim = DISPERSIVE["lorentz_mixed"](monitors=_monitors())
    return _grown(sim) if case == "sharded" else sim


def _runner(case: str, ndev: int = 4) -> FDTDRunner:
    """A fresh runner of ``case``: a tier name, ``bloch`` or ``sharded``
    (``ndev`` virtual shards)."""
    plan = lower(_sim(case))
    if case == "sharded":
        mesh, _ = make_mesh(devices=["cpu"] * ndev)
        return FDTDRunner(plan, device="cpu",
                          sharding_plan=ShardingPlan(mesh, plan.shape))
    return FDTDRunner(plan, device="cpu",
                      kernel="kstep" if case == "bloch" else case)


def _check(ref: dict, got: dict):
    assert set(got) == set(ref)
    for mi in ref:
        assert set(got[mi]) == set(ref[mi])
        for comp in ref[mi]:
            np.testing.assert_allclose(
                got[mi][comp], ref[mi][comp], rtol=0,
                atol=TOL * np.max(np.abs(ref[mi][comp]) + 1e-30))


CASES = ["kstep", "fused", "pallas2", "bloch", "sharded"]


@pytest.mark.parametrize("case", CASES)
def test_checkpoint_resume_matches_uninterrupted(case, tmp_path,
                                                 monkeypatch):
    """A run saving every 3 chunks dies in chunk 8; a fresh runner resumes
    from the file of chunk 6 and ends where the uninterrupted run ends; the
    file is gone afterwards."""
    ckpt = str(tmp_path / "state.npz")
    r0 = _runner(case)
    ref = r0.run()
    assert r0.tier == ("fused" if case == "fused" else
                       "pallas2" if case == "pallas2" else "kstep")

    r1 = _runner(case)
    run_steps, calls = r1.run_steps, []

    def dies_in_chunk_8(start, num, state):
        calls.append(start)
        if len(calls) == 8:
            raise RuntimeError("preempted")
        return run_steps(start, num, state)

    monkeypatch.setattr(r1, "run_steps", dies_in_chunk_8)
    with pytest.raises(RuntimeError, match="preempted"):
        r1.run_checkpointed(ckpt, checkpoint_every=3)
    assert os.path.exists(ckpt) and not os.path.exists(ckpt + ".tmp")

    r2 = _runner(case)
    _, idx, _, _ = r2.load_checkpoint(ckpt)
    assert idx == 6
    out = r2.run_checkpointed(ckpt, checkpoint_every=3)
    assert not os.path.exists(ckpt)
    assert r2.steps_run == r0.steps_run
    assert r2.final_decay == pytest.approx(r0.final_decay, rel=1e-6)
    _check(ref, out)


@pytest.mark.parametrize("case", CASES)
def test_resume_from_partial_checkpoint(case, tmp_path):
    """The first half of the chunks by hand (``run_steps``), saved; a fresh
    runner resumes from the file and completes."""
    ckpt = str(tmp_path / "state.npz")
    r0 = _runner(case)
    ref = r0.run_checkpointed(str(tmp_path / "ref.npz"),
                              checkpoint_every=999)

    r1 = _runner(case)
    chunk, num_chunks = r1.chunking()
    half = num_chunks // 2
    state, max_ever = r1.init_state(), 0.0
    for ci in range(half):
        state = r1.run_steps(ci * chunk, chunk, state)
        cur = float(r1._max_field(state))
        max_ever = max(max_ever, cur)
    size = r1.save_checkpoint(ckpt, state, half, max_ever, cur)
    assert size == os.path.getsize(ckpt) > 0

    r2 = _runner(case)
    out = r2.run_checkpointed(ckpt, checkpoint_every=999)
    assert r2.steps_run == r0.steps_run
    _check(ref, out)


def test_checkpoint_names_its_arrays(tmp_path):
    """Arrays are named by their place in the state; the ping-pong set is
    not saved; the run's identity and loop position are."""
    ckpt = str(tmp_path / "state.npz")
    runner = _runner("kstep")
    state = runner.init_state()
    runner.save_checkpoint(ckpt, state, 3, 2.0, 1.5)
    with np.load(ckpt) as data:
        names = set(data.files)
        assert str(data["__tier__"]) == "kstep" and int(data["__k__"]) == 2
        assert tuple(data["__grid_shape__"]) == runner.shape
        assert tuple(data["__decomp__"]) == (1, 1, 1)
        assert int(data["__chunk_idx__"]) == 3
        assert float(data["__max_ever__"]) == 2.0
        assert float(data["__cur__"]) == 1.5
    last = len(runner.plan.monitors) - 1       # the field-time monitor
    assert {"E.Ex", "H.Hz", "Q.0.Ey.re", "Q.0.Ey.im", "mon.0.Ex.re",
            "mon.0.Ex.im", f"mon.{last}.Ez"} <= names
    assert any(n.startswith("psi.") for n in names)
    assert not any(n.startswith("alt") for n in names)
    assert "__version__" in names


def test_refuses_a_file_of_another_run(tmp_path):
    """A file of another tier, decomposition or grid raises SetupError."""
    def saved(runner, name):
        path = str(tmp_path / name)
        runner.save_checkpoint(path, runner.init_state(), 1, 1.0, 1.0)
        return path

    kstep_file = saved(_runner("kstep"), "kstep.npz")
    with pytest.raises(SetupError, match="tier"):
        _runner("fused").load_checkpoint(kstep_file)
    with pytest.raises(SetupError, match="tier"):
        _runner("pallas2").load_checkpoint(saved(_runner("fused"),
                                                 "fused.npz"))
    four = saved(_runner("sharded"), "four.npz")
    with pytest.raises(SetupError, match="decomp"):
        _runner("sharded", ndev=2).load_checkpoint(four)
    with pytest.raises(SetupError, match="decomp"):
        FDTDRunner(lower(_sim("sharded")), device="cpu",
                   kernel="kstep").load_checkpoint(four)
    with pytest.raises(SetupError, match="grid_shape"):
        _runner("kstep").load_checkpoint(four)


def test_web_run_checkpoint_path(tmp_path):
    """``web.run(checkpoint_path=...)`` gives the data of a plain run and
    leaves no file behind."""
    ckpt = str(tmp_path / "run.npz")
    sim = _sim("fused")
    ref = tt.web.run(sim, device="cpu", verbose=False)
    got = tt.web.run(sim, device="cpu", verbose=False, checkpoint_path=ckpt,
                     checkpoint_every=2)
    assert not os.path.exists(ckpt)
    for name in ("flux",):
        assert np.array_equal(got[name].flux.values, ref[name].flux.values)
    assert np.array_equal(got["field"].Ez.values, ref["field"].Ez.values)
    with pytest.raises(ValueError, match="checkpoint_every"):
        _runner("fused").run_checkpointed(ckpt, checkpoint_every=0)
