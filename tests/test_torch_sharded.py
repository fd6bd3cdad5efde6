"""Sharded runs of the port (x-slabs on the k-step kernel) against its
unsharded runs and the JAX package.

On the CPU every shard is a virtual one (the mesh names the CPU several
times) and steps with the plain version of the k-step group. Held here:
the plan rotation and the env decisions against the JAX package's own
functions, exactly; one group of the shard-local plain version, started
from one random global state split into shards, against the unsharded
group on that state, for 1, 2 and 4 shards (fields, psi and pole currents
to 1e-6 of the largest magnitude); whole sharded runs against the port's
unsharded kstep runs and against the JAX XLA runner fed the same strided
DFT tables (raw monitors to 2e-5, the JAX package's bar in
``tests/test_solver/test_kstep_sharded.py``); the y and z decompositions
through the rotation; ``web.run`` under ``TIDY3D_TPU_SHARD``; and the
refusals of a forced ``kstep`` (the plans ``auto`` sends to bricks,
``tests/test_torch_sharded_bricks.py``).

The JAX package's own sharded path (``_run(sim, ndev=4,
kernel="kstep_interpret", k=2)`` of ``test_kstep_sharded.py``) is not run
here: it steps its Pallas kernel in interpret mode on grids its TPU layout
admits (nz a multiple of 8, 224 x planes in 8-plane blocks), one of its
cases did not finish within 150 s on this CPU, and it is the same XLA
semantics that the JAX XLA runner gives here on the small cases.

The kernel tests at the end need a CUDA card and skip without one.
"""

import os

import numpy as np
import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch import convert
from tidy3d_tpu_torch.solver import distributed, plan_rotate
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner, halo_arrays
from tidy3d_tpu_torch.solver.kernels import kstep as kstep_kernels
from tidy3d_tpu_torch.solver.lowering import lower
from tidy3d_tpu_torch.solver.sharding import ShardingPlan, XSlabs, make_mesh

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    BLOCH, DISPERSIVE, DL, SIMS, lower_reference, max_rel_err, monitors,
    random_state,
)
from tests.test_torch_imports import _equal
from tests.test_torch_kstep import _check_groups, _flat, _jax_with_k
from tidy3d_tpu.solver import distributed as ref_distributed
from tidy3d_tpu.solver import plan_rotate as ref_rotate

TOL_GROUP = 1e-6    # float32 rounding of the same expression tree
TOL_RUN = 2e-5      # the reference's own bar for whole sharded runs
T0 = 36             # a group inside the source pulse
NX = 24             # x planes: 4 shards of 6 hold the 4-plane x-PML slabs
CASES = {**SIMS, **DISPERSIVE}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "xla")
    for key in ("TIDY3D_TPU_KSTEP", "TIDY3D_TPU_SHARD",
                "TIDY3D_TPU_COORDINATOR"):
        monkeypatch.delenv(key, raising=False)


def sized(sim, nx: int = NX):
    """``sim`` with its x size changed so that the grid has ``nx`` x
    planes (the PML included)."""
    for n in range(4, 4 * nx):
        new = sim.copy(update=dict(
            size=(round(n * DL, 9),) + tuple(sim.size[1:])))
        if lower(new).shape[0] == nx:
            return new
    raise ValueError(f"no x size gives {nx} planes")


def boundary_dipole(**kw):
    """``pml_all`` with its dipole at x = 0, on the boundary of the middle
    shards of a 4-way split of 24 planes (the broadband case's dipole sits
    on a 4-way boundary of 384 in the same way)."""
    sim = sized(SIMS["pml_all"](**kw))
    src = sim.sources[0]
    return sim.copy(update=dict(sources=[src.copy(update=dict(
        center=(0.0,) + tuple(src.center[1:])))]))


GROUP_CASES = {name: (lambda f=f: sized(f())) for name, f in CASES.items()
               if name in ("pml_all", "periodic", "pec_pmc", "lorentz_mixed",
                           "gold_halfspace")}
GROUP_CASES["boundary_dipole"] = boundary_dipole


def sharded(plan, ndev: int, decomp=None, **kw) -> FDTDRunner:
    """A runner over ``ndev`` virtual CPU shards (the kstep tier forced:
    the fixture names the JAX package's XLA path)."""
    kw.setdefault("kernel", "kstep")
    mesh, _ = make_mesh(devices=["cpu"] * ndev, decomp=decomp)
    return FDTDRunner(plan, device="cpu",
                      sharding_plan=ShardingPlan(mesh, plan.shape), **kw)


def _dft_monitors():
    return [m for m in monitors() if m.name != "time"]


def _raw_err(ref: dict, got: dict) -> float:
    assert set(ref) == set(got)
    worst = 0.0
    for idx in ref:
        assert set(ref[idx]) == set(got[idx])
        for comp in ref[idx]:
            assert ref[idx][comp].shape == got[idx][comp].shape, (idx, comp)
        if ref[idx]:
            worst = max(worst, max_rel_err(ref[idx], got[idx]))
    return worst


# --------------------------------------------------------------------------- #
# plan rotation and env decisions against the JAX package
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("case", sorted({**CASES, **BLOCH}))
def test_rotation_matches_the_reference(case, r):
    sim = {**CASES, **BLOCH}[case](monitors=monitors())
    got = plan_rotate.rotate_plan(lower(sim), r)
    ref_plan = lower_reference(sim)
    ref = ref_rotate.rotate_plan(ref_plan, r)
    _equal(ref, got, f"{case} r={r}")
    # raw monitors of the rotated plan, rotated back
    rng = np.random.default_rng(r)
    raw = {}
    for idx, mp in enumerate(ref.monitors):
        sizes = {c: tuple(s.stop - s.start for s in sl)
                 for c, sl in mp.slices.items()}
        if mp.kind == "field":
            raw[idx] = {c: rng.standard_normal(s + (3,)) + 1j
                        * rng.standard_normal(s + (3,))
                        for c, s in sizes.items()}
        else:
            raw[idx] = {c: rng.standard_normal((5,) + s)
                        for c, s in sizes.items()}
    want = ref_rotate.unrotate_raw(raw, ref, r)
    have = plan_rotate.unrotate_raw(raw, got, r)
    _equal(want, have, f"{case} r={r} unrotate")


@pytest.mark.parametrize("val,shape", [
    ("", (32, 32, 32)), ("0", (32, 32, 32)), ("none", (32, 32, 32)),
    ("2,2", (32, 32, 32)), ("auto", (4, 4, 4)), ("auto", (32, 32, 32)),
    ("4", (32, 32, 32)), ("1,2", (32, 32, 32)), ("1,1,1", (32, 32, 32)),
    ("1,1,4", (32, 32, 6)), ("8,1,1", (32, 32, 32))])
def test_env_decisions_match_the_reference(val, shape, monkeypatch):
    """The decisions of ``test_sharding.py:150-160`` and their
    neighbours: the same ``decomp`` or None, on eight CPU devices."""
    monkeypatch.setenv("TIDY3D_TPU_SHARD", val)
    ref = ref_distributed.sharding_plan_from_env(shape)
    got = distributed.sharding_plan_from_env(shape, "cpu")
    assert (ref is None) == (got is None), (val, shape)
    if ref is not None:
        assert got.decomp == ref.decomp
        assert got.shape == tuple(shape)
        assert all(d == torch.device("cpu") for d in got.devices)


def test_env_refuses_more_devices_than_there_are(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_SHARD", "16,1,1")
    with pytest.raises(ValueError, match="needs 16 devices"):
        ref_distributed.sharding_plan_from_env((64, 8, 8))
    with pytest.raises(ValueError, match="needs 16 devices"):
        distributed.sharding_plan_from_env((64, 8, 8), "cpu")
    # a CUDA run counts the visible CUDA devices (nothing touches a card)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("TIDY3D_TPU_SHARD", "4,1,1")
    with pytest.raises(ValueError, match="needs 4 devices, only 2"):
        distributed.sharding_plan_from_env((64, 8, 8), "cuda")
    monkeypatch.setenv("TIDY3D_TPU_SHARD", "auto")
    sp = distributed.sharding_plan_from_env((64, 8, 8), "cuda")
    assert sp.decomp == (2, 1, 1)
    assert sp.devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert distributed.ring_device_order(
        ["cuda:1", "cuda:0"]) == sp.devices


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def world_of_one(monkeypatch):
    """The environment of a one-process world on the coordinator
    ``127.0.0.1:<free port>``, left again afterwards (the worlds of
    several processes: ``tests/test_torch_multiprocess.py``)."""
    monkeypatch.setenv("TIDY3D_TPU_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("TIDY3D_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("TIDY3D_TPU_PROCESS_ID", "0")
    monkeypatch.setenv("TIDY3D_TPU_DIST_TIMEOUT", "60")
    try:
        yield
    finally:
        distributed.shutdown()


def test_initialize_without_a_coordinator_is_single_process():
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1
    assert distributed.all_gather_object("x") == ["x"]


def test_initialize_needs_the_process_count_and_index(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.delenv("TIDY3D_TPU_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("TIDY3D_TPU_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="TIDY3D_TPU_NUM_PROCESSES"):
        distributed.initialize(device="cpu")
    assert not torch.distributed.is_initialized()


def test_initialize_joins_a_gloo_world_of_one(world_of_one):
    assert distributed.initialize(device="cpu") is True
    assert torch.distributed.is_initialized()
    assert torch.distributed.get_backend() == "gloo"
    assert (distributed.process_index(), distributed.process_count()) \
        == (0, 1)
    # idempotent; a CUDA run never rides the gloo group
    assert distributed.initialize(device="cpu") is True
    with pytest.raises(RuntimeError, match="needs nccl"):
        distributed.initialize(device="cuda")
    mesh, decomp = distributed.make_global_mesh((2, 1, 1), ["cpu"] * 2)
    assert decomp == (2, 1, 1)
    assert np.array_equal(mesh.ranks, np.zeros((2, 1, 1), int))
    assert list(mesh.devices.reshape(-1)) == [torch.device("cpu")] * 2


def test_exchange_fills_the_halos_from_the_ring():
    lay = XSlabs(12, 3, 2, periodic=False)
    glob = np.arange(12 * 2 * 3, dtype=np.float32).reshape(12, 2, 3)
    arrays = [[torch.from_numpy(lay.take(glob, s)).clone()]
              for s in range(3)]
    for a in arrays:
        a[0][:2] = -1.0
        a[0][-2:] = -1.0
    lay.exchange(arrays)
    for s in range(3):
        assert np.array_equal(arrays[s][0].numpy(), lay.take(glob, s))
    assert lay.halo(0) == (False, True) and lay.halo(2) == (True, False)
    assert XSlabs(12, 1, 2, periodic=True).halo(0) == (True, True)


# --------------------------------------------------------------------------- #
# one group: shard-local plain version against the unsharded group
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_sharded_group_matches_unsharded(case, ndev):
    plan = lower(GROUP_CASES[case]())
    assert plan.shape[0] == NX
    ref = FDTDRunner(plan, device="cpu", kernel="kstep")
    st = random_state(np.random.default_rng(11), ref.shape,
                      ref.psi_shapes(), ref.consts["pole_scalars"])
    want = convert.state_to_reference(kstep_kernels.kstep_group(
        convert.state_from_reference(st, ref), ref.consts, ref.meta,
        ref.tables, T0, ref.k))
    run = sharded(plan, ndev)
    assert run.tier == "kstep" and len(run.shards) == ndev
    states = convert.shard_states_from_reference(st, run)
    before = kstep_kernels.LAUNCHES
    news = [kstep_kernels.kstep_group(s, sh.consts, sh.meta, sh.tables, T0,
                                      run.k)
            for sh, s in zip(run.shards, states)]
    assert kstep_kernels.LAUNCHES == before
    got = convert.shard_states_to_reference(news, run)
    _check_groups(_flat(want), _flat(got), TOL_GROUP, f"{case} ndev={ndev}")
    if case == "boundary_dipole" and ndev == 4:
        # the dipole's box reaches a boundary: more than one shard holds it
        held = sum(int(sh.tables.boxes["E"].shape[0]) for sh in run.shards)
        assert held > len(ref.tables.sources["E"]) > 0
        x0 = ref.tables.sources["E"][0].slices[0].start
        assert x0 % run.layout.nx_loc in (0, run.layout.nx_loc - 1)


# --------------------------------------------------------------------------- #
# whole runs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", ["pml_all", "lorentz_mixed", "periodic"])
def test_sharded_run_matches_unsharded_and_jax(case):
    sim = sized(CASES[case](monitors=_dft_monitors(), run_time=2e-14))
    plan = lower(sim)
    run = sharded(plan, 4)
    got = run.run()
    assert run.tier_name == "kstep (k=2, 4 x-shards)"
    ref = FDTDRunner(plan, device="cpu", kernel="kstep").run()
    err = _raw_err(ref, got)
    assert err <= TOL_RUN, f"sharded vs unsharded: rel err {err:.2e}"
    jr, _, _ = _jax_with_k(lower_reference(sim), run.k)
    err = _raw_err(jr.run(), got)
    assert err <= TOL_RUN, f"sharded vs JAX XLA: rel err {err:.2e}"


@pytest.mark.parametrize("decomp,rot", [((1, 2, 1), 1), ((1, 1, 2), 2)])
@pytest.mark.parametrize("case", ["pml_all", "lorentz3_pml"])
def test_y_and_z_decompositions_rotate_onto_x(case, decomp, rot):
    plan = lower(CASES[case](monitors=_dft_monitors(), run_time=2e-14))
    run = sharded(plan, 2, decomp=decomp)
    assert run._plan_rot == rot and len(run.shards) == 2
    assert run.shape == tuple(plan.shape[a] for a in
                              plan_rotate.perm_for_rot(rot))
    got = run.run()
    ref = FDTDRunner(plan, device="cpu", kernel="kstep").run()
    err = _raw_err(ref, got)
    assert err <= TOL_RUN, f"{decomp}: rel err {err:.2e}"


def test_web_run_sharded_env_matches_unsharded(monkeypatch, caplog):
    """The counterpart of ``test_sharding.py:162-175``."""
    sim = sized(SIMS["pml_all"](monitors=_dft_monitors(), run_time=2e-14))
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "kstep")
    ref = tt.web.run(sim, device="cpu", verbose=False)
    monkeypatch.setenv("TIDY3D_TPU_SHARD", "4,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    got = tt.web.run(sim, device="cpu", verbose=False)
    assert "kstep (k=2, 4 x-shards)" in got.log
    for name in ("flux", "field"):
        for comp in (("flux",) if name == "flux" else ("Ex", "Ez", "Hy")):
            r = getattr(ref[name], comp).values
            g = getattr(got[name], comp).values
            assert r.shape == g.shape and np.any(r != 0)
            err = np.max(np.abs(g - r)) / np.max(np.abs(r))
            assert err <= TOL_RUN, f"{name}.{comp}: rel err {err:.2e}"


# --------------------------------------------------------------------------- #
# refusals
# --------------------------------------------------------------------------- #


def forced_kstep(env, plan, ndev: int, decomp=None) -> FDTDRunner:
    """``sharded`` under ``TIDY3D_TPU_KERNEL=kstep``: the x-slab k-step
    route or its refusal (``auto`` takes bricks where it refuses,
    ``tests/test_torch_sharded_bricks.py``)."""
    env.setenv("TIDY3D_TPU_KERNEL", "kstep")
    return sharded(plan, ndev, decomp, kernel=None)


def _refuse_2d(env):
    forced_kstep(env, lower(sized(SIMS["pml_all"]())), 4, decomp=(2, 2, 1))


def _refuse_bloch(env):
    forced_kstep(env, lower(BLOCH["bloch_dipole"]()), 2)


def _refuse_uneven(env):
    plan = lower(SIMS["pml_all"]())
    assert plan.shape[0] % 2
    forced_kstep(env, plan, 2)


def _refuse_cone(env):
    forced_kstep(env, lower(sized(SIMS["pml_all"](), 20)), 4)


def _refuse_thin(env):
    forced_kstep(env, lower(sized(SIMS["periodic"](), 12)), 4)


def _refuse_fused(env):
    sharded(lower(sized(SIMS["pml_all"]())), 4, kernel="fused")


@pytest.mark.parametrize("attempt,error,match", [
    (_refuse_2d, NotImplementedError, "mixed 2D/3D"),
    (_refuse_bloch, NotImplementedError, "sharded Bloch"),
    (_refuse_uneven, ValueError, "do not split into 2 equal shards"),
    (_refuse_cone, ValueError, "x-PML slab of 4 planes"),
    (_refuse_thin, ValueError, "shards of 3 planes"),
    (_refuse_fused, ValueError, "no shard-local mode"),
], ids=lambda v: getattr(v, "__name__", None))
def test_sharded_refusals(attempt, error, match, monkeypatch):
    with pytest.raises(error, match=match):
        attempt(monkeypatch)


def test_web_run_with_a_coordinator_matches_the_run_without(
        monkeypatch, world_of_one):
    """``web.run`` under ``TIDY3D_TPU_SHARD=2,1,1`` in a world of one gloo
    process: the collective path (process 0 lowers and builds the data,
    the all-reduced shutoff maximum, the gathered monitors) gives the data
    of the run without a coordinator, bit for bit."""
    sim = sized(SIMS["pml_all"](monitors=_dft_monitors(), run_time=2e-14))
    monkeypatch.setenv("TIDY3D_TPU_SHARD", "2,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    coordinator = os.environ.pop("TIDY3D_TPU_COORDINATOR")
    ref = tt.web.run(sim, device="cpu", verbose=False)
    os.environ["TIDY3D_TPU_COORDINATOR"] = coordinator
    got = tt.web.run(sim, device="cpu", verbose=False)
    assert torch.distributed.is_initialized()
    assert "kstep (k=2, 2 x-shards)" in got.log
    for name in ("flux", "field"):
        for comp in (("flux",) if name == "flux" else ("Ex", "Ez", "Hy")):
            r = getattr(ref[name], comp).values
            assert np.any(r != 0)
            assert np.array_equal(r, getattr(got[name], comp).values)


def test_shard_state_keeps_its_x_psi_slabs_on_the_edges():
    run = sharded(lower(sized(SIMS["pml_all"]())), 4)
    states = run.init_state()["shards"]
    sides = [{key.split("|")[2] for key in st["psi"]
              if key.split("|")[1] == "0"} for st in states]
    assert sides == [{"lo"}, set(), set(), {"hi"}]
    # every exchanged array spans the padded x planes of the shard
    padded = run.layout.padded
    for st in states:
        assert all(a.shape[0] == padded for a in halo_arrays(st))


# --------------------------------------------------------------------------- #
# the sharded kernel on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _cuda_shards(plan, ndev, cuda, **kw):
    kw.setdefault("kernel", "kstep")
    mesh, _ = make_mesh(devices=[cuda] * ndev)
    return FDTDRunner(plan, device=cuda,
                      sharding_plan=ShardingPlan(mesh, plan.shape), **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_sharded_kernel_matches_plain_and_unsharded(case, ndev, cuda):
    plan = lower(GROUP_CASES[case]())
    ref = FDTDRunner(plan, device=cuda, kernel="kstep")
    st = random_state(np.random.default_rng(17), ref.shape,
                      ref.psi_shapes(), ref.consts["pole_scalars"])
    unsharded = _flat(convert.state_to_reference(kstep_kernels.kstep_group(
        convert.state_from_reference(st, ref), ref.consts, ref.meta,
        ref.tables, T0, ref.k)))
    run = _cuda_shards(plan, ndev, cuda)
    outs = []
    for fn in (kstep_kernels.kstep_group,
               kstep_kernels.kstep_group_reference):
        states = convert.shard_states_from_reference(st, run)
        before = kstep_kernels.SHARDED_LAUNCHES
        news = [fn(s, sh.consts, sh.meta, sh.tables, T0, run.k,
                   out=s["alt"]) for sh, s in zip(run.shards, states)]
        torch.cuda.synchronize()
        assert kstep_kernels.SHARDED_LAUNCHES - before == (
            ndev if fn is kstep_kernels.kstep_group else 0)
        outs.append(_flat(convert.shard_states_to_reference(news, run)))
    _check_groups(outs[1], outs[0], TOL_GROUP, f"{case} kernel vs plain")
    _check_groups(unsharded, outs[0], TOL_GROUP,
                  f"{case} sharded vs unsharded kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["lorentz_mixed", "periodic"])
def test_sharded_kernel_runner_matches_unsharded(case, cuda):
    plan = lower(sized(CASES[case](monitors=_dft_monitors(),
                                   run_time=2e-14)))
    ref = FDTDRunner(plan, device=cuda, kernel="kstep").run()
    before = kstep_kernels.SHARDED_LAUNCHES
    run = _cuda_shards(plan, 4, cuda)
    got = run.run()
    assert kstep_kernels.SHARDED_LAUNCHES - before == \
        4 * run.steps_run // run.k
    assert _raw_err(ref, got) <= TOL_RUN
