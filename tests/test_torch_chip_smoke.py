"""Pieces of ``chip_smoke.py`` that need no card: the device busy time of a
profiler window (the union of the device events' intervals, so that the
two overlapping launches of a k-step group count once), the device
launches a k-step group makes (one per non-empty block list, per shard),
the records a profiler trace holds, the memory line of a run's log, the
full-size cases of the new monitors (built, not run) and phase 29's pieces:
its cases, the block of its finite-difference check, the split of an
adjoint call's seconds into runs, mode solves and kernel builds, and the
clock and the operations of its design region.
"""

import json
from types import SimpleNamespace

import numpy as np

import pytest

import chip_smoke
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.kernels import kstep
from tidy3d_tpu_torch.solver.lowering import lower
from tidy3d_tpu_torch.solver.sharding import ShardingPlan, make_mesh

import tidy3d_tpu_torch as td
from tests.torch_cases import SIMS, TILED, monitors


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


def test_trace_counts(tmp_path):
    """The k-step kernel's device records and the ``fdtd.monitors``
    ranges of a Chrome trace; host records and other kernels do not
    count."""
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"cat": "kernel", "name": "void kstep_kernel<0, false, true>(...)"},
        {"cat": "kernel", "name": "void kstep_kernel<1, false, false>(...)"},
        {"cat": "kernel", "name": "fused_step_kernel"},
        {"cat": "cpu_op", "name": "kstep_kernel"},
        {"cat": "user_annotation", "name": "fdtd.monitors"},
        {"cat": "gpu_user_annotation", "name": "fdtd.monitors"},
        {"cat": "user_annotation", "name": "fdtd.poles"}]}))
    assert chip_smoke.trace_counts(str(path)) == {
        "kstep_kernel": 2, "fdtd.monitors": 2, "events": 7}


def test_log_memory_reads_the_run_log():
    """``log_memory`` and ``log_field`` read what ``web.run`` logs: the
    peak (0 on the CPU), the estimate and each monitor's host seconds."""
    sim = SIMS["pml_all"](monitors=monitors()[:2], run_time=5e-15)
    data = td.web.run(sim, device="cpu", verbose=False)
    lines = data.log.splitlines()
    mem = chip_smoke.log_memory(lines)
    runner = FDTDRunner(lower(sim), device="cpu")
    assert mem == {"peak": 0,
                   "estimate": runner.estimate_device_memory()["total"]}
    host = chip_smoke.log_field(lines, "monitor data host seconds: ")
    assert [part.split()[0] for part in host.split(", ")] == ["field", "flux"]


@pytest.mark.parametrize("make", ["waveguide_case", "farfield_case",
                                  "diffraction_case"])
def test_new_cases_build(make):
    """The full-size cases of phases 16 to 18 validate (they are lowered
    and run on the card only)."""
    sim = getattr(chip_smoke, make)(td)
    names = [m.name for m in sim.monitors]
    want = {"waveguide_case": ["flux", "mode", "modes", "eps"],
            "farfield_case": ["field", "flux", "far"],
            "diffraction_case": ["flux", "flux_back", "fwd", "bwd",
                                 "diff"]}[make]
    assert names == want
    if make == "farfield_case":
        far = sim.monitors[-1]
        assert np.isclose(np.asarray(far.theta), np.pi / 2).any()
    if make == "waveguide_case":
        assert [m.name for m in chip_smoke.waveguide_case(
            td, monitors=False).monitors] == ["flux"]


def test_bf16_phase_pieces():
    """Phase 28's libraries (six bf16 variants, labelled by their defines),
    its comparison (float32 differences, the bit-equal share, the bar) and
    its short main-path case."""
    import torch

    from tidy3d_tpu_torch import _build

    labels = [_build.label(*v) for v in chip_smoke.bf16_variants()]
    assert labels == [
        "step[T3D_FIELD_BF16,T3D_PSI_BF16,T3D_Q_BF16]",
        "fused[T3D_FIELD_BF16,T3D_PSI_BF16,T3D_Q_BF16]",
        "kstep[T3D_PSI_BF16]", "kstep[T3D_Q_BF16]",
        "kstep[T3D_PSI_BF16,T3D_Q_BF16]",
        "kstep[T3D_FIELD_BF16,T3D_PSI_BF16,T3D_Q_BF16]"]
    ref = {"E:Ex": torch.tensor([1.0, 2.0, -4.0], dtype=torch.bfloat16),
           "psi:Ex|1|lo": torch.tensor([0.5, 0.25], dtype=torch.bfloat16)}
    got = dict(ref, **{"E:Ex": torch.tensor([1.0, 2.0, -4.03125],
                                            dtype=torch.bfloat16)})
    rel, ab, share = chip_smoke.bf16_compare(got, ref, "test")
    assert (rel, ab) == (0.03125 / 4, 0.03125) and share == 0.8
    with pytest.raises(AssertionError, match="rel err"):
        chip_smoke.bf16_compare(dict(ref, **{"E:Ex": ref["E:Ex"] * 1.5}),
                                ref, "test")
    sim = chip_smoke.mixed_dft_case(td, dispersive=True)
    assert [m.name for m in sim.monitors] == ["field", "flux"]
    assert len(sim.monitors[1].freqs) == 11


def test_invdes_cases_build():
    """Phase 29's cases: the 3D waveguide-offset problem at 5.8 M cells
    with its 100 x 100 x 12 design region (built, not run), and the 2D
    coupling case equal to the tests' own."""
    from tidy3d_tpu_torch.plugins import invdes
    from tests.torch_cases import COUPLING_REGION, coupling

    sim = chip_smoke.invdes_case(td)
    assert tuple(sim.grid.num_cells) == (274, 204, 104)
    region = chip_smoke.invdes_region(invdes)
    assert region.params_shape(sim) == chip_smoke.INVDES_SHAPE
    # the filter, the projection and the penalty all run
    assert region.radius > 0 and region.beta > 1 and region.penalty_weight > 0
    assert [m.name for m in sim.monitors] == ["out"]
    assert chip_smoke.coupling_case(td).json() == coupling().json()
    assert chip_smoke.coupling_region(td) == COUPLING_REGION


@pytest.mark.parametrize("peak, want", [
    ((50, 50), (slice(46, 54), slice(46, 54))),
    ((0, 99), (slice(0, 8), slice(92, 100))),
    ((99, 3), (slice(92, 100), slice(0, 8))),
])
def test_fd_block_is_centred_on_the_largest_gradient(peak, want):
    g = np.random.default_rng(0).uniform(-1, 1, (100, 100, 12)) * 1e-3
    g[peak[0], peak[1], 5] = -2.0
    block = chip_smoke.fd_block(g)
    assert block == want + (slice(None),)
    assert g[block].shape == (8, 8, 12)


def test_split_record_and_mode_solve_clock():
    """``split_record`` takes each run's mode solves out of its seconds by
    the solves' end times and reads the runs' logs; the clock times
    ``compute_modes`` while entered and restores it after."""
    from tidy3d_tpu_torch.plugins.mode import mode_solver

    inner = mode_solver.compute_modes
    with chip_smoke.ModeSolveClock() as clock:
        assert mode_solver.compute_modes is not inner
        clock.solves += [(10.5, 0.25), (13.2, 0.5), (20.0, 9.0)]
    assert mode_solver.compute_modes is inner
    sim = SIMS["pml_all"](monitors=monitors()[:1], run_time=5e-15)
    log_ = td.web.run(sim, device="cpu", verbose=False).log
    rec = {"started": 10.0, "forward_s": 1.0, "vjp_s": 2.0, "adjoint_s": 1.0,
           "assembly_s": 0.1, "forward_log": log_, "adjoint_log": log_}
    # the solves end in the forward run (10.5), the VJP stage (12.5) and
    # the adjoint run (13.2); the one at 20.0 is after the call
    clock.solves.insert(1, (12.5, 0.125))
    r = chip_smoke.split_record(rec, clock)
    build = float(log_.split(" s compile")[0].rsplit("+", 1)[1])
    assert r["build_s"] == 2 * build
    assert r["forward_s"] == pytest.approx(0.75 - build)
    assert r["adjoint_s"] == pytest.approx(0.5 - build)
    assert r["vjp_s"] == 1.875 and r["mode_s"] == 0.875
    assert r["assembly_s"] == 0.1
    assert r["forward"]["tier"].startswith("fused")
    assert r["forward"]["sources"] == "E 1, H 0"
    # a CPU run of a few cells logs 0.000 Gcell*steps/s at this precision
    assert r["forward"]["rate"] >= 0 and r["forward"]["peak"] == 0


def test_region_clock_and_region_ops():
    """``RegionClock`` records each transformation and penalty call with the
    device of its parameters and restores the class after; ``region_ops``
    gives the transformation, its VJP, the penalty and its gradient, the
    VJP equal to the transformation's Jacobian applied by hand on a one-hot
    cotangent."""
    import torch

    from tidy3d_tpu_torch.plugins import invdes

    region = invdes.TopologyDesignRegion(
        center=(0, 0, 0), size=(0.4, 0.4, 0.2), radius=0.06, beta=2.0,
        penalty_weight=0.01)
    params = np.random.default_rng(0).uniform(0, 1, (8, 8, 4)).astype(
        np.float32)
    cls = invdes.TopologyDesignRegion
    inner = cls.transform
    with chip_smoke.RegionClock() as clock:
        assert cls.transform is not inner
        out = chip_smoke.region_ops(region, params, np.ones_like(params),
                                    0.02, "cpu")
    assert cls.transform is inner
    assert [(c[0], c[1]) for c in clock.calls] == [("transform", "cpu"),
                                                  ("penalty", "cpu")]
    density, vjp, pen, g_pen = out
    assert density.shape == vjp.shape == g_pen.shape == params.shape
    assert pen.ndim == 0 and float(pen) > 0
    np.testing.assert_array_equal(
        density, region.transform(torch.as_tensor(params), dl=0.02))
    cot = np.zeros_like(params)
    cot[3, 4, 1] = 1.0
    _, vjp1, _, _ = chip_smoke.region_ops(region, params, cot, 0.02, "cpu")
    p = torch.as_tensor(params).requires_grad_(True)
    region.transform(p, dl=0.02)[3, 4, 1].backward()
    np.testing.assert_allclose(vjp1, p.grad, rtol=0, atol=1e-7)


def test_gc_clock_counts_collections():
    import gc

    with chip_smoke.GcClock() as clock:
        gc.collect()
        gc.collect()
    assert clock.count == 2 and clock.seconds >= 0
    assert clock._call not in gc.callbacks


def test_timemonitor_case_builds():
    """Phase 30's case: the dispersive case's monitors, a point Ez probe
    at the dipole sampled every step from the start and a flux-time
    monitor on the flux box (built, not run)."""
    sim = chip_smoke.timemonitor_case(td)
    assert [m.name for m in sim.monitors] == ["field", "flux", "probe",
                                             "flux_time"]
    probe, flux_t = sim.monitors[2:]
    assert isinstance(probe, td.FieldTimeMonitor)
    assert tuple(probe.size) == (0, 0, 0) and probe.fields == ("Ez",)
    assert tuple(probe.center) == tuple(sim.sources[0].center)
    assert probe.start == 0 and probe.interval == 1
    assert isinstance(flux_t, td.FluxTimeMonitor) and flux_t.start == 0
    assert tuple(flux_t.size) == tuple(sim.monitors[1].size)
    assert len(sim.structures) == 1


def test_load_widths_reads_the_sass_modifiers():
    ops = ["LDG.E.64.CONSTANT", "LDG.E", "LDG.E.U16.CONSTANT", "LDS.64",
           "LDS.U16", "LDGSTS.E.BYPASS.LTC128B", "LDGSTS.E.64", "STG.E.64",
           "FFMA", "LDS.128"]
    assert chip_smoke.load_widths(ops) == {
        "LDG.64": 1, "LDG.32": 1, "LDG.16": 1, "LDS.64": 1, "LDS.16": 1,
        "LDGSTS.32": 1, "LDGSTS.64": 1, "LDS.128": 1}


def test_fused_work_counts_the_pole_currents_both_ways():
    """A fused step's bound reads E, H, psi and Q and writes them once,
    with the residues among the constants; the group errors compare Q'."""
    import torch

    from tests.torch_cases import DISPERSIVE

    runner = FDTDRunner(lower(DISPERSIVE["lorentz_mixed"]()), device="cpu",
                        kernel="fused")
    state = runner.init_state()
    nbytes, ops = chip_smoke.fused_work(runner, state)
    ncell = int(np.prod(runner.shape))
    q = 6 * 4 * ncell
    assert chip_smoke.nbytes(state["Q"]) == q
    assert nbytes == 2 * chip_smoke.nbytes(
        state["E"], state["H"], state["psi"]) + 2 * q + chip_smoke.nbytes(
        chip_smoke.stepping_consts(runner))
    assert ops == (2 * chip_smoke.OPS_FAMILY * ncell
                   + chip_smoke.OPS_PSI * chip_smoke.numel(state["psi"])
                   + chip_smoke.OPS_POLE * 3 * ncell)
    out = runner.step(40, dict(state))
    flat = chip_smoke.fused_flat((out["E"], out["H"], out["psi"], out["Q"]))
    assert {k.split(":")[0] for k in flat} >= {"E", "H", "psi", "Q0"}
    moved = dict(flat, **{"Q0:Ex:re": flat["Q0:Ex:re"] + 1.0})
    rel, ab = chip_smoke.group_errors(moved, flat)
    assert ab == 1.0 and rel > 0
    assert chip_smoke.group_errors(flat, flat) == (0.0, 0.0)
    assert len(chip_smoke.q_buffers(state)) == 1
    assert all(t.shape == state["E"]["Ex"].shape and t.dtype == torch.float32
               for Qp in chip_smoke.q_buffers(state) for pair in Qp.values()
               for t in pair)


@pytest.mark.parametrize("case,copies", [("lorentz_mixed", 1),
                                         ("gold_halfspace", 1),
                                         ("lorentz_mixed", 2)])
def test_pole_work_counts_each_array_once(case, copies):
    """A pole-kernel call's bound reads and writes every slot's currents,
    reads E' and E of each component a residue reads, and each support
    mask once however many slots share it."""
    from tests.torch_cases import DISPERSIVE

    runner = FDTDRunner(lower(DISPERSIVE[case]()), device="cpu",
                        kernel="pallas2")
    state = runner.init_state()
    views = [runner._views(state)[0]] * copies
    Qs = [v["Q"] for v in views]
    new_es = [dict(v["E"]) for v in views]
    nbytes, ops = chip_smoke.pole_work(new_es, [v["E"] for v in views], Qs,
                                       runner.consts)
    ncell = int(np.prod(runner.shape))
    metas = runner.consts["pole_B_meta"]
    comps = {ci for ms in metas for ci, m in enumerate(ms)
             if m["kind"] != "zero"}
    masks = {m["mask_id"] for ms in metas for m in ms if m["kind"] == "mask"}
    assert comps and masks and len(Qs[0]) == len(runner.plan.poles)
    assert nbytes == 4 * ncell * (copies * (2 * 6 * len(Qs[0])
                                            + 2 * len(comps)) + len(masks))
    assert ops >= copies * ncell * (6 * 3 * len(Qs[0]) + len(comps))
