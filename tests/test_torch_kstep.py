"""The k-step tier of the port against the JAX package.

The Nyquist-strided DFT tables, the monitor group stride B, the monitor
gate and the chunk alignment against the JAX runner's own functions (its
``kstep`` set to a stand-in holding k, which is all they read); one group
of ``kstep_group_reference`` from a random state against k calls of the
JAX runner's XLA ``_step`` (fields, psi and pole currents to 1e-6 of the
largest magnitude); and whole runs on the kstep tier against the JAX XLA
runner fed the same strided tables (raw monitors to 2e-5).

The kernel-against-plain tests at the end need a CUDA card and skip without
one.
"""

import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch import convert
from tidy3d_tpu_torch.solver import fdtd as port_fdtd
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.kernels import kstep as kstep_kernels

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    DISPERSIVE, lower_reference as lower, max_rel_err, monitors, random_state,
    SIMS, TILED,
)
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

TOL_XLA = 1e-6      # float32 rounding of the same expression tree
TOL_RUN = 2e-5      # the reference's own bar for whole runs
T0 = 36             # a group inside the source pulse

CASES = {**SIMS, **DISPERSIVE}


@pytest.fixture(autouse=True)
def _xla(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "xla")
    monkeypatch.delenv("TIDY3D_TPU_KSTEP", raising=False)


def _time_monitor(plan_dt, start_step, interval):
    """A field-time monitor whose first sample is step ``start_step``."""
    return tt.FieldTimeMonitor(center=(0, 0, 0), size=(0.2, 0.2, 0.2),
                               start=max(start_step - 0.5, 0) * plan_dt,
                               interval=interval, name="time")


def _dft_monitors():
    return [m for m in monitors() if m.name != "time"]


def _dt():
    return lower(SIMS["pml_all"]()).dt


def _jax_with_k(plan, k):
    """A JAX XLA runner whose DFT tables and group stride are those of the
    k-step tier (its ``kstep`` is a stand-in holding k while they are
    built, and None again afterwards, so it steps on the XLA path)."""
    jr = JaxRunner(plan)
    jr.kstep = SimpleNamespace(k=k)
    jr._build_dft_tables()
    B, aligned = jr._mon_group_stride, jr._align_chunk(
        max(plan.num_steps // 20, 1))
    jr.kstep = None
    return jr, B, aligned


@pytest.mark.parametrize("k", [2, 4])
def test_dft_tables_and_group_stride_match_jax(k, monkeypatch):
    mons = _dft_monitors() + [_time_monitor(_dt(), 8 * k - 1, 8 * k)]
    plan = lower(SIMS["pml_all"](monitors=mons, run_time=2e-14))
    jr, B, aligned = _jax_with_k(plan, k)
    tables = port_fdtd.build_dft_tables(plan, k)
    assert set(tables) == set(jr.consts["dft"]) and tables
    for key, ref in jr.consts["dft"].items():
        for r, g in zip(ref, tables[key]):
            assert r.dtype == g.dtype == np.float32
            assert np.array_equal(r, g), key
        # strided: some rows are zero, and the sampled rows land on group
        # ends
        rows = np.nonzero(np.any(ref[0] != 0, axis=1))[0]
        assert 0 < len(rows) < plan.num_steps
        assert np.all((rows + 1) % k == 0)
    assert port_fdtd.monitor_group_stride(plan, k) == B
    assert port_fdtd.align_chunk(max(plan.num_steps // 20, 1), k, B) == \
        aligned
    # the runner tries k first; the kernel is built for k = 2 only
    monkeypatch.setenv("TIDY3D_TPU_KSTEP", str(k))
    port = FDTDRunner(plan, device="cpu", kernel="kstep")
    assert port.tier == "kstep" and port.k == 2
    if k == port.k:
        assert port.mon_group_stride == B
        assert port.align_chunk(max(plan.num_steps // 20, 1)) == aligned
    # the k = 1 tables are the every-step ones
    for key, ref in JaxRunner(plan).consts["dft"].items():
        for r, g in zip(ref, port_fdtd.build_dft_tables(plan)[key]):
            assert np.array_equal(r, g)


@pytest.mark.parametrize("start,interval,k", [
    (1, 4, 4), (0, 4, 2), (3, 4, 4), (1, 4, 2), (7, 8, 4), (3, 6, 4)])
def test_monitors_allow_k_matches_jax(start, interval, k):
    """Refused: a first sample off a group end, or an interval that is not
    a multiple of k; allowed otherwise, and the DFT monitors' Nyquist
    bound is checked as well."""
    mons = _dft_monitors() + [_time_monitor(_dt(), start, interval)]
    plan = lower(SIMS["pml_all"](monitors=mons, run_time=2e-14))
    assert plan.monitors[-1].t_start == start
    jr = JaxRunner(plan)
    want = jr._monitors_allow_k(k)
    assert port_fdtd.monitors_allow_k(plan, k) == want
    assert want == (start % k == k - 1 and interval % k == 0)
    # a stride longer than the DFT monitors' Nyquist step count
    nyq = int(1.0 / (2 * port_fdtd.nyquist_fmax(plan, plan.monitors[0].freqs))
              / plan.dt)
    assert not port_fdtd.monitors_allow_k(plan, nyq + 1)
    assert not jr._monitors_allow_k(nyq + 1)


@functools.lru_cache(maxsize=None)
def _jax_step_fn(case):
    plan = lower(CASES[case]())
    jr = JaxRunner(plan)
    return plan, jr, jax.jit(lambda s, c, t: jr._step(t, s, c))


def _jax_group(case, state_np, t0, k):
    _, jr, fn = _jax_step_fn(case)
    consts = jax.device_put(jr.consts)
    st = jax.device_put(dict(state_np, mon=[]))
    for t in range(t0, t0 + k):
        st = fn(st, consts, t)
    st = jax.device_get(st)
    return {"E": st["E"], "H": st["H"], "psi": st["psi"], "Q": st["Q"]}


def _flat(state: dict) -> dict:
    out = {}
    for fam in ("E", "H", "psi"):
        out.update({f"{fam}:{key}": np.asarray(v)
                    for key, v in state[fam].items()})
    for pi, Qp in enumerate(state["Q"]):
        for c, (qr, qi) in Qp.items():
            out[f"Q{pi}:{c}:re"] = np.asarray(qr)
            out[f"Q{pi}:{c}:im"] = np.asarray(qi)
    return out


def _check_groups(ref: dict, got: dict, tol: float, what: str):
    assert set(ref) == set(got), f"{what}: keys differ"
    for group in sorted({k.split(":")[0] for k in ref}):
        keys = [k for k in ref if k.split(":")[0] == group]
        err = max_rel_err({k: ref[k] for k in keys},
                          {k: got[k] for k in keys})
        assert err <= tol, f"{what} {group}: rel err {err:.2e}"


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kstep_group_matches_xla_steps(case, k):
    plan, _, _ = _jax_step_fn(case)
    port = FDTDRunner(plan, device="cpu", kernel="fused")
    tables = kstep_kernels.SourceTables(port._sources, port._waveforms,
                                        port.shape, "cpu")
    assert port._waveforms[:, T0:T0 + k].any(), "source off in the group"
    st = random_state(np.random.default_rng(23), port.shape,
                      port.psi_shapes(), port.consts["pole_scalars"])
    ref = _jax_group(case, st, T0, k)
    state = convert.state_from_reference(st, port)
    before = kstep_kernels.LAUNCHES
    got = kstep_kernels.kstep_group(state, port.consts, port.meta, tables,
                                    T0, k)
    assert kstep_kernels.LAUNCHES == before
    # the input state is left as it was (the pole currents included)
    for pi, Qp in enumerate(st["Q"]):
        for c, (qr, _) in Qp.items():
            assert np.array_equal(state["Q"][pi][c][0].numpy(), qr)
    got = convert.state_to_reference(got)
    assert len(got["Q"]) == len(plan.poles)
    _check_groups(_flat(ref), _flat(got), TOL_XLA, f"{case} k={k}")


def test_kstep_cases_cover_poles_walls_and_sheets():
    poles, kinds = set(), set()
    for case in CASES:
        plan = lower(CASES[case]())
        poles.add(len(plan.poles))
        kinds.update(k for pair in plan.boundaries for k in pair)
    assert {0, 1, 3, 7} <= poles
    assert kinds == {"pec", "pmc", "periodic"}


@pytest.mark.parametrize("case", ["pml_all", "lorentz_mixed"])
def test_kstep_runner_matches_xla_with_strided_tables(case):
    sim = CASES[case](monitors=_dft_monitors(), run_time=2e-14)
    plan = lower(sim)
    port = FDTDRunner(plan, device="cpu", kernel="kstep")
    assert port.tier == "kstep" and port.k == 2
    jr, _, aligned = _jax_with_k(plan, port.k)
    ref = jr.run()
    got = port.run()
    assert port.steps_run % (port.k * port.mon_group_stride) == 0
    assert port.steps_run == -(-plan.num_steps // aligned) * aligned
    assert set(got) == set(ref)
    for idx in ref:
        assert set(got[idx]) == set(ref[idx])
        err = max_rel_err(ref[idx], got[idx])
        assert err <= TOL_RUN, f"monitor {idx}: rel err {err:.2e}"


def test_kstep_runner_time_monitor_and_every_step_dft():
    """A time monitor on group ends is sampled at the right steps, and the
    strided DFT stays within the JAX package's 2e-2 of the every-step
    quadrature once the pulse has left (the run is long enough that the
    strided sum does not cut the signal short)."""
    k = 2
    mons = _dft_monitors() + [_time_monitor(_dt(), 3, 8)]
    plan = lower(SIMS["pml_all"](monitors=mons, run_time=4e-14))
    ref = FDTDRunner(plan, device="cpu", kernel="fused").run()
    got = FDTDRunner(plan, device="cpu", kernel="kstep").run()
    for idx, mp in enumerate(plan.monitors):
        err = max_rel_err(ref[idx], got[idx])
        if mp.kind == "field_time":
            assert err <= TOL_RUN, f"time monitor: rel err {err:.2e}"
        else:
            assert err <= 2e-2, f"monitor {idx}: rel err {err:.2e}"
    assert k == FDTDRunner(plan, device="cpu", kernel="kstep").k


def test_auto_order_on_a_cuda_device(monkeypatch):
    """``auto`` for a CUDA device takes kstep, then fused, then pallas2,
    from the plan alone (nothing touches a card to decide)."""
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    select = port_fdtd.select_tier
    light = lower(DISPERSIVE["lorentz_mixed"]())
    gold = lower(DISPERSIVE["gold_halfspace"]())
    one = {"E": 1, "H": 0}
    assert select(light, one, "cuda") == ("kstep", 2)
    assert select(gold, one, "cuda") == ("kstep", 2)
    assert select(light, one, "cpu") == ("fused", 1)
    unaligned = lower(SIMS["pml_all"](monitors=monitors()))
    assert select(unaligned, one, "cuda") == ("fused", 1)
    assert select(unaligned, {"E": 40, "H": 0}, "cuda") == ("pallas2", 1)
    assert select(light, {"E": 40, "H": 0}, "cuda") == ("kstep", 2)
    assert select(light, {"E": 65, "H": 0}, "cuda") == ("pallas2", 1)
    # the JAX package's order of k: auto tries 4 then 2, an integer first
    assert port_fdtd.kstep_order() == (4, 2)
    monkeypatch.setenv("TIDY3D_TPU_KSTEP", "0")
    assert port_fdtd.kstep_order() == ()
    assert select(light, one, "cuda") == ("fused", 1)
    # a group size the kernel is not built for is refused: k = 2 runs
    for env, order in (("4", (4, 2)), ("3", (3, 4, 2)), ("2", (2, 4))):
        monkeypatch.setenv("TIDY3D_TPU_KSTEP", env)
        assert port_fdtd.kstep_order() == order
        assert select(light, one, "cuda") == ("kstep", 2)
        assert select(gold, one, "cuda") == ("kstep", 2)


def test_kstep_group_uses_the_ping_pong_set():
    plan = lower(DISPERSIVE["lorentz_mixed"](monitors=_dft_monitors()))
    port = FDTDRunner(plan, device="cpu", kernel="kstep")
    state = port.init_state()
    alt_ids = {id(v) for v in state["alt"]["E"].values()}
    old_ids = {id(v) for v in state["E"].values()}
    new = port.step_group(0, state)
    assert {id(v) for v in new["alt"]["E"].values()} == old_ids
    assert set(new["alt"]) == {"E", "H", "psi", "Q"} and alt_ids
    with pytest.raises(ValueError, match="groups"):
        port.step(0, state)
    with pytest.raises(ValueError, match="whole groups"):
        port.run_steps(0, port.k + 1, state)


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
    k = 2
    plan = lower(CASES[case]())
    port = FDTDRunner(plan, device=cuda, kernel="fused")
    tables = kstep_kernels.SourceTables(port._sources, port._waveforms,
                                        port.shape, cuda)
    st = random_state(np.random.default_rng(5), port.shape,
                      port.psi_shapes(), port.consts["pole_scalars"])
    # the kernel is built for k = 2 only: the wrapper refuses before
    # launching
    with pytest.raises(ValueError, match="group size 4"):
        kstep_kernels.kstep_group(convert.state_from_reference(st, port),
                                  port.consts, port.meta, tables, T0, 4)
    outs = []
    for fn in (kstep_kernels.kstep_group,
               kstep_kernels.kstep_group_reference):
        state = convert.state_from_reference(st, port)
        before = kstep_kernels.LAUNCHES
        new = fn(state, port.consts, port.meta, tables, T0, k)
        torch.cuda.synchronize()
        assert kstep_kernels.LAUNCHES == before + (
            fn is kstep_kernels.kstep_group)
        outs.append(_flat(convert.state_to_reference(new)))
    _check_groups(outs[1], outs[0], TOL_XLA, f"{case} k={k} kstep kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lorentz_mixed", "gold_halfspace",
                                  "sheet_lorentz", "periodic"])
def test_kernel_runner_matches_plain_runner(case, cuda):
    """40 whole steps on the kstep tier, kernel against plain: 2e-5."""
    plan = lower(CASES[case]())
    finals = []
    for use_kernel in (True, False):
        runner = FDTDRunner(plan, device=cuda, kernel="kstep",
                            use_kernel=use_kernel)
        runner._pad_time_tables(40)
        before = kstep_kernels.LAUNCHES
        state = runner.run_steps(0, 40, runner.init_state())
        assert kstep_kernels.LAUNCHES - before == \
            (40 // runner.k if use_kernel else 0)
        finals.append({c: v.cpu().numpy() for fam in ("E", "H")
                       for c, v in state[fam].items()})
    assert max(np.max(np.abs(v)) for v in finals[1].values()) > 0
    assert max_rel_err(finals[1], finals[0]) <= TOL_RUN


def _tiled_state(port, seed):
    """A random state in the reference's layout; a complex run's copy 1
    under ``E1``, ``H1``, ``psi1``."""
    rng = np.random.default_rng(seed)
    st = random_state(rng, port.shape, port.psi_shapes(),
                      port.consts["pole_scalars"])
    if port.is_complex:
        im = random_state(rng, port.shape, port.psi_shapes())
        st.update(E1=im["E"], H1=im["H"], psi1=im["psi"])
    return st


def _flat_copies(state: dict) -> dict:
    out = _flat(state)
    for fam in ("E1", "H1", "psi1"):
        out.update({f"{fam}:{key}": np.asarray(v)
                    for key, v in state.get(fam, {}).items()})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(TILED))
def test_kernel_matches_plain_on_bulk_and_shell_blocks(case, cuda):
    """Grids of 3 or more blocks per axis: the bulk and the shell
    instantiation in one group (two launches), against plain to 1e-6, for
    0, 1, 2, 7 and 8 pole slots, PEC and PMC lo walls, periodic axes and
    the Bloch copies."""
    from tidy3d_tpu_torch.solver.lowering import lower as port_lower

    plan = port_lower(TILED[case]())
    port = FDTDRunner(plan, device=cuda, kernel="kstep")
    ncopy = 2 if port.is_complex else 1
    assert all(g >= 3 for g in kstep_kernels.grid_blocks(plan.shape, 2))
    bulk, shell = kstep_kernels.block_lists(port.meta, 2, ncopy, cuda)
    assert bulk.numel() > 0 and shell.numel() > 0
    st = _tiled_state(port, 7)
    outs = []
    for fn in (kstep_kernels.kstep_group,
               kstep_kernels.kstep_group_reference):
        state = convert.state_from_reference(st, port)
        before = (kstep_kernels.LAUNCHES, kstep_kernels.DEVICE_LAUNCHES)
        new = fn(state, port.consts, port.meta, port.tables, T0, 2)
        torch.cuda.synchronize()
        launched = fn is kstep_kernels.kstep_group
        assert (kstep_kernels.LAUNCHES - before[0],
                kstep_kernels.DEVICE_LAUNCHES - before[1]) == \
            ((1, 2) if launched else (0, 0))
        outs.append(_flat_copies(convert.state_to_reference(new)))
    _check_groups(outs[1], outs[0], TOL_XLA, f"{case} kstep kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("case,ndev", [("tiled_lorentz2", 4),
                                       ("tiled_lorentz_periodic", 2)])
def test_sharded_kernel_on_bulk_and_shell_blocks(case, ndev, cuda):
    """Virtual x-shards of a tiled grid (two poles over 4 shards; one pole
    and a periodic x over 2): one shard-local group of the kernel against
    plain and against the unsharded kernel."""
    from tidy3d_tpu_torch.solver.lowering import lower as port_lower
    from tidy3d_tpu_torch.solver.sharding import ShardingPlan, make_mesh

    plan = port_lower(TILED[case]())
    ref = FDTDRunner(plan, device=cuda, kernel="kstep")
    st = _tiled_state(ref, 9)
    unsharded = _flat(convert.state_to_reference(kstep_kernels.kstep_group(
        convert.state_from_reference(st, ref), ref.consts, ref.meta,
        ref.tables, T0, 2)))
    mesh, _ = make_mesh(devices=[cuda] * ndev)
    run = FDTDRunner(plan, device=cuda, kernel="kstep",
                     sharding_plan=ShardingPlan(mesh, plan.shape))
    assert any(kstep_kernels.block_lists(sh.meta, 2, 1, cuda)[0].numel()
               for sh in run.shards)
    outs = []
    for fn in (kstep_kernels.kstep_group,
               kstep_kernels.kstep_group_reference):
        states = convert.shard_states_from_reference(st, run)
        before = kstep_kernels.SHARDED_LAUNCHES
        news = [fn(s, sh.consts, sh.meta, sh.tables, T0, 2, out=s["alt"])
                for sh, s in zip(run.shards, states)]
        torch.cuda.synchronize()
        assert kstep_kernels.SHARDED_LAUNCHES - before == (
            ndev if fn is kstep_kernels.kstep_group else 0)
        outs.append(_flat(convert.shard_states_to_reference(news, run)))
    _check_groups(outs[1], outs[0], TOL_XLA, f"{ndev} shards, kernel vs plain")
    _check_groups(unsharded, outs[0], TOL_XLA, f"{ndev} shards vs unsharded")


@pytest.mark.gpu
def test_groups_on_two_streams_match_plain(cuda):
    """Two runners stepping groups on two streams at once, enqueued in
    turns: each group's second launch counts its finished blocks in its
    own stream's word, so every group ends after its first launch and
    both runs match plain to 1e-6 a group."""
    from tidy3d_tpu_torch.solver.lowering import lower as port_lower

    plan = port_lower(TILED["tiled_lorentz2"]())
    ports = [FDTDRunner(plan, device=cuda, kernel="kstep") for _ in range(2)]
    starts = [_tiled_state(port, seed) for port, seed in zip(ports, (11, 12))]
    streams = [torch.cuda.Stream(cuda) for _ in ports]
    groups = 6
    # each run's states, group by group (every group writes a new set)
    runs = [[convert.state_from_reference(st, port)]
            for st, port in zip(starts, ports)]
    torch.cuda.synchronize()
    for g in range(groups):
        for port, stream, run in zip(ports, streams, runs):
            with torch.cuda.stream(stream):
                run.append(kstep_kernels.kstep_group(
                    run[-1], port.consts, port.meta, port.tables,
                    T0 + 2 * g, 2))
    torch.cuda.synchronize()
    assert len({id(kstep_kernels.done_word(s)) for s in streams}) == 2
    for port, run in zip(ports, runs):
        for g in range(groups):
            ref = kstep_kernels.kstep_group_reference(
                run[g], port.consts, port.meta, port.tables, T0 + 2 * g, 2)
            _check_groups(_flat(convert.state_to_reference(ref)),
                          _flat(convert.state_to_reference(run[g + 1])),
                          TOL_XLA, f"two streams, group {g}, kernel vs plain")
