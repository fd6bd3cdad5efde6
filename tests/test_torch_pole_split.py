"""Pole tables of more than ``poles.MAX_SLOTS`` records, cut into launches.

The pole kernel (``csrc/poles.cu``) stages at most ``MAX_SLOTS`` (240) slot
records a launch, one record per slot and copy. ``PoleTable`` cuts a larger
table into consecutive launches of at most that many, each with its own
copy ranges (``first``) and the components its records read (``need``).
Held here on the CPU: the split of 241 slots of one copy and of 121 slots
of each of two copies (every record once, in order; the ranges and the
components recomputed from the records), and plans past the limit (a
241-pole Lorentz medium, and 121 poles in a Bloch run) taken by
``select_tier`` and run on the CPU against the JAX package's XLA run
(2e-5).

The kernel tests at the end need a CUDA card and skip without one: the
split launches against the plain update, bit for bit (float32 against the
out-of-place ``pole_update``, whose rounding points the kernel keeps;
bf16 against ``update_poles``), and the 241-pole plan's run on the card
against its run on the CPU.
"""

import ctypes

import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch.solver.fdtd import (
    FDTDRunner, count_sources, select_tier,
)
from tidy3d_tpu_torch.solver.kernels import poles
from tidy3d_tpu_torch.solver.lowering import E_COMPS, lower

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import FREQ0, _sim, lower_reference
from tests.test_torch_sharded import _raw_err
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

TOL_RUN = 2e-5
RUN_TIME = 1.5e-15   # some 15 steps through the source's rise


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    for key in ("TIDY3D_TPU_KSTEP", "TIDY3D_TPU_SHARD",
                "TIDY3D_TPU_PRECISION"):
        monkeypatch.delenv(key, raising=False)


def lorentz(n: int):
    """A Lorentz medium of ``n`` weak terms spread over 1.1 to 2.5 f0:
    ``n`` pole slots."""
    return tt.Lorentz(eps_inf=1.5, coeffs=[
        (1.0 / n, FREQ0 * (1.1 + 1.4 * i / n), FREQ0 / 8)
        for i in range(n)])


def many_sim(n: int, bloch: bool = False):
    """The small case grid (19 x 16 x 22 with its 3-layer PML) with the
    ``n``-pole medium in its upper half, PML on every side, or Bloch x
    and y and a PML z."""
    bspec = tt.BoundarySpec(
        x=tt.Boundary.bloch(bloch_vec=0.27),
        y=tt.Boundary.bloch(bloch_vec=-0.13),
        z=tt.Boundary.pml(num_layers=3)) if bloch else \
        tt.BoundarySpec.all_sides(tt.PML(num_layers=3))
    mons = [tt.FieldMonitor(center=(0, 0, -0.05), size=(0.4, 0.3, 0),
                            freqs=[FREQ0], name="f"),
            tt.FieldTimeMonitor(center=(0, 0, 0.1), size=(0.2, 0.2, 0),
                                interval=2, name="t")]
    return _sim(bspec, [tt.Structure(
        geometry=tt.Box(center=(0, 0, 0.3), size=(tt.inf, tt.inf, 0.4)),
        medium=lorentz(n))], mons, run_time=RUN_TIME)


CASES = {"real_241": (241, False), "bloch_121": (121, True)}


def _records(runner, state) -> tuple:
    Qs = [state[key] for key in ("Q", "Q1") if key in state]
    return Qs, poles.slot_records(Qs, runner.consts)


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_tables(case):
    """Every record once and in order, at most ``MAX_SLOTS`` a launch;
    each launch's copy ranges and the components its records read."""
    n, bloch = CASES[case]
    plan = lower(many_sim(n, bloch))
    assert len(plan.poles) == n
    runner = FDTDRunner(plan, device="cpu", kernel="pallas2")
    state = runner.init_state()
    Qs, records = _records(runner, state)
    assert len(records) == n * len(Qs) > poles.MAX_SLOTS
    table = poles.PoleTable(poles.table_key(Qs, runner.consts), Qs,
                            runner.consts, runner.shape, torch.float32,
                            "cpu")
    launches = table.launches
    assert len(launches) == -(-len(records) // poles.MAX_SLOTS) == 2
    assert [lc.start for lc in launches] == [0, poles.MAX_SLOTS]
    assert launches[-1].stop == len(records)
    assert table.tensor.numel() == len(records) * ctypes.sizeof(
        poles.PoleSlot)
    for lc in launches:
        part = records[lc.start:lc.stop]
        assert 1 <= len(part) <= poles.MAX_SLOTS
        # copy 0's records first: copy c spans first[c] .. first[c+1]
        for c in range(len(Qs)):
            got = [rec.copy for rec in part[lc.first[c]:lc.first[c + 1]]]
            assert got == [c] * (lc.first[c + 1] - lc.first[c])
            assert lc.need[c] == tuple(
                any(r.kind[ci] and r.copy == c for r in part)
                for ci in range(3))
        assert lc.first[0] == 0 and lc.first[-1] == len(part)
    # the split of two copies: copy 0's last records and copy 1's first
    # share the first launch
    if bloch:
        assert launches[0].first[:3] == (0, 121, 240)
        assert launches[1].first[:3] == (0, 0, 2)
    else:
        assert launches[1].first[:2] == (0, 1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_many_slot_plan_runs_like_jax(case):
    """``select_tier`` takes the plan (``pallas2``: the fused kernel's
    table stops at 240 slots, the k-step kernel at 8) and the CPU run
    matches the JAX package's XLA run."""
    n, bloch = CASES[case]
    sim = many_sim(n, bloch)
    plan = lower(sim)
    for device in ("cpu", "cuda"):
        assert select_tier(plan, count_sources(plan), device, "auto") == \
            ("pallas2", 1)
    got = FDTDRunner(plan, device="cpu").run()
    ref = JaxRunner(lower_reference(sim)).run()
    err = _raw_err(ref, got)
    print(f"{case}: port pallas2 vs JAX XLA {err:.2e}")
    assert err <= TOL_RUN


# --------------------------------------------------------------------------- #
# the kernel on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_kernel_bit_equal(case, precision, cuda):
    """One call (two launches) against the plain update of every copy,
    from random E' and currents: float32 bit-equal to ``pole_update``,
    bf16 to ``update_poles``."""
    n, bloch = CASES[case]
    plan = lower(many_sim(n, bloch))
    runner = FDTDRunner(plan, device=cuda, kernel="pallas2",
                        precision=precision)
    state = runner.init_state()
    gen = torch.Generator(device=cuda).manual_seed(5)
    views = runner._views(state)
    for view in views:
        for t in [*view["E"].values(), *(x for Qp in view["Q"]
                                         for pair in Qp.values()
                                         for x in pair)]:
            t.copy_(torch.randn(t.shape, generator=gen, device=cuda))
    new_es = [{c: torch.randn(v.shape, generator=gen, device=cuda,
                              dtype=v.dtype) for c, v in view["E"].items()}
              for view in views]
    old_es = [view["E"] for view in views]
    Qs = [view["Q"] for view in views]
    if precision == "float32":
        want = [poles.pole_update(ne, oe, Q, runner.consts)
                for ne, oe, Q in zip(new_es, old_es, Qs)]
    else:
        want = [[{c: (qr.clone(), qi.clone()) for c, (qr, qi) in Qp.items()}
                 for Qp in Q] for Q in Qs]
        for ne, oe, Q in zip(new_es, old_es, want):
            poles.update_poles(ne, oe, Q, runner.consts)
    before = (poles.LAUNCHES, poles.DEVICE_LAUNCHES)
    poles.update_poles_copies(new_es, old_es, Qs, runner.consts, {})
    torch.cuda.synchronize()
    assert poles.LAUNCHES - before[0] == 1
    assert poles.DEVICE_LAUNCHES - before[1] == 2
    for got_q, want_q in zip(Qs, want):
        for gp, wp in zip(got_q, want_q):
            for c in E_COMPS:
                for g, w in zip(gp[c], wp[c]):
                    assert torch.equal(g, w), (case, precision, c)


@pytest.mark.gpu
def test_many_slot_run_on_the_card(cuda):
    """The 241-pole plan under ``auto`` on the card (``pallas2``, the pole
    kernel in two launches a step) against its CPU run."""
    plan = lower(many_sim(241))
    ref = FDTDRunner(plan, device="cpu").run()
    runner = FDTDRunner(plan, device=cuda)
    assert runner.tier == "pallas2"
    before = (poles.LAUNCHES, poles.DEVICE_LAUNCHES)
    got = runner.run()
    torch.cuda.synchronize()
    assert poles.LAUNCHES - before[0] == runner.steps_run
    assert poles.DEVICE_LAUNCHES - before[1] == 2 * runner.steps_run
    assert _raw_err(ref, got) <= TOL_RUN
