"""Pieces of ``chip_smoke.py`` that need no card: the device busy time of a
profiler window (the union of the device events' intervals, so that the
two overlapping launches of a k-step group count once) and the device
launches a k-step group makes (one per non-empty block list, per shard).
"""

from types import SimpleNamespace

import pytest

import chip_smoke
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.kernels import kstep
from tidy3d_tpu_torch.solver.lowering import lower
from tidy3d_tpu_torch.solver.sharding import ShardingPlan, make_mesh

from tests.torch_cases import SIMS, TILED


def _event(start, end, name="kstep_kernel", device="CUDA", note=False):
    return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end),
                           device_type=SimpleNamespace(name=device),
                           name=name, is_user_annotation=note)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


@pytest.mark.parametrize("events,busy", [
    ([], 0.0),
    ([_event(0, 10)], 10.0),
    # the bulk launch starting in the shell launch's last wave
    ([_event(0, 10), _event(8, 15)], 15.0),
    ([_event(0, 10), _event(2, 5), _event(20, 25)], 15.0),
    # host events, the runner's ranges and annotations are no device work
    ([_event(0, 10), _event(0, 100, device="CPU"),
      _event(0, 100, name="fdtd.poles"), _event(30, 40, note=True),
      _event(50, 60, name="Command Buffer Full")], 10.0),
])
def test_device_busy_counts_overlapping_kernels_once(events, busy):
    assert chip_smoke._device_busy_us(_Prof(events)) == busy


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for key in ("TIDY3D_TPU_KERNEL", "TIDY3D_TPU_KSTEP", "TIDY3D_TPU_SHARD"):
        monkeypatch.delenv(key, raising=False)


@pytest.mark.parametrize("case,ndev", [
    ("tiled_lorentz2", 1), ("tiled_bloch", 1), ("tiled_lorentz2", 4),
    ("pml_all", 1), ("tiled_lorentz_periodic", 1),
    ("tiled_lorentz_periodic", 2)])
def test_lists_per_group_counts_nonempty_lists(case, ndev):
    plan = lower({**SIMS, **TILED}[case]())
    kw = {}
    if ndev > 1:
        mesh, _ = make_mesh(devices=["cpu"] * ndev)
        kw["sharding_plan"] = ShardingPlan(mesh, plan.shape)
    runner = FDTDRunner(plan, device="cpu", kernel="kstep", **kw)
    metas = [sh.meta for sh in runner.shards] if runner.shards \
        else [runner.meta]
    ncopy = 2 if runner.is_complex else 1
    want = sum(bool(len(bulk)) + bool(len(shell)) for bulk, shell in
               (kstep.classify_blocks(m, runner.k, ncopy) for m in metas))
    assert chip_smoke.lists_per_group(runner) == want
    assert ndev <= want <= 2 * ndev
    if case in TILED and ndev == 1:
        assert want == 2
