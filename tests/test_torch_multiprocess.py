"""Sharded runs of the port across processes, on the CPU: real worlds of
gloo processes (``tests/torch_multiprocess_worker.py``) against the
single-process run of the same mesh and the JAX package.

Two worlds run, each started once for the whole file with a hard
wall-clock limit (``WORLD_TIMEOUT``; the group's own timeout,
``TIDY3D_TPU_DIST_TIMEOUT``, is shorter, so a process that dies makes its
peers fail first): 2 processes on the coordinator ``127.0.0.1:<free
port>``, and 4 processes of one virtual CPU device each. In the 2-process
world, the ``pml_all`` case with a Lorentz pole on x-slabs of the k-step
route (4, 1, 1), two shards a process; the Bloch dipole on bricks (2, 2,
1), the x split (and its periodic wall, whose halo carries the Bloch phase)
between the processes; Kerr + TPA on bricks (2, 1, 1), a brick a process;
a run that stops on the shutoff; a process that owns no mesh entry; a
plain mesh that every process runs whole; a memory gate that refuses in
one process (every process raises); checkpoint and resume; and
``web.run`` under ``TIDY3D_TPU_SHARD=2,2`` with a mode source and a mode
monitor. In the 4-process world, ``pml_all`` on bricks (2, 2, 1).

Held: every process's raw monitors (or ``SimulationData`` arrays) equal,
bit for bit, to every other process's and to the single-process run of the
same mesh (virtual shards, ``tests/test_torch_sharded*.py``); within 2e-5
of the JAX package's XLA run (the bar of ``test_torch_sharded_bricks.py``;
on x-slabs its run with the k-step tier's strided DFT tables); the same
``steps_run`` everywhere; halos across processes really moved. The ring
order and the global mesh are held as the JAX package's own
``tests/test_solver/test_sharding.py`` holds them, with stand-in devices.
"""

import json
import os
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch.solver import distributed
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.lowering import lower
from tidy3d_tpu_torch.solver.sharding import ShardingPlan, make_mesh

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    BLOCH, LORENTZ, SIMS, _box, lower_reference, monitors,
    waveguide,
)
from tests.test_torch_checkpoint import _sim as checkpoint_sim
from tests.test_torch_kstep import _jax_with_k
from tests.test_torch_nonlinear import nl_sim
from tests.test_torch_sharded import _dft_monitors, _raw_err, sized
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multiprocess_worker.py")
TOL_RUN = 2e-5          # the reference's bar for whole sharded runs
# web.run's data in a worker against this process's web.run of the same
# mesh: float64 mode solves whose BLAS rounds otherwise with other threads
# (1e-12 measured), float32 fields
TOL_MODE_DATA = 1e-9
WORLD_TIMEOUT = 300     # seconds a world may take, its start included
DIST_TIMEOUT = 120      # the process group's own timeout in the workers
RUN_TIME = 4e-15        # 40-odd steps through the source pulse


def _lorentz_slabs():
    return sized(SIMS["pml_all"](monitors=_dft_monitors(),
                                 run_time=2e-14).copy(
        update=dict(structures=[_box(LORENTZ)])))


def _bloch():
    return sized(BLOCH["bloch_dipole"](monitors=monitors(),
                                       run_time=RUN_TIME), 12)


def _shutoff():
    """``pml_all`` over 20 x planes run long enough for its field to decay
    below the shutoff."""
    return sized(SIMS["pml_all"](monitors=_dft_monitors(), run_time=2e-13),
                 20).copy(update=dict(shutoff=1e-4))


def _pml():
    return sized(SIMS["pml_all"](monitors=monitors(), run_time=RUN_TIME),
                 20)


# name: (simulation, decomposition, devices a process, kernel, JAX run)
RUNS = {
    "lorentz_slabs": (_lorentz_slabs, (4, 1, 1), 2, "kstep", "kstep"),
    "bloch_bricks": (_bloch, (2, 2, 1), 2, None, "xla"),
    "kerr_tpa_bricks": (lambda: nl_sim("kerr_tpa_1"), (2, 1, 1), 1, None,
                        "xla"),
    "shutoff_bricks": (_shutoff, (2, 2, 1), 2, None, None),
}
RESUME = (lambda: checkpoint_sim("sharded"), (4, 1, 1), 2)
FOUR = (_pml, (2, 2, 1), 1, None, "xla")
IDLE = (_pml, (2, 1, 1), 2, None, None)
EVERYWHERE = (_pml, (4, 1, 1), 4, None, None)


def _case(name, make, decomp, local, kernel, kind="run", **kw):
    return dict(name=name, sim=make().json(), kind=kind,
                decomp=list(decomp), local=local, kernel=kernel, **kw)


def _web_sim():
    return waveguide()


def _two_cases() -> list:
    cases = [_case(name, make, decomp, local, kernel)
             for name, (make, decomp, local, kernel, _) in RUNS.items()]
    # a mesh of 2 entries, a prefix of the ring: both on process 0
    cases.append(_case("idle", *IDLE[:4]))
    # a plain mesh of 4 entries: each process runs all of them
    cases.append(_case("everywhere", *EVERYWHERE[:4], plain=True))
    cases.append(_case("memory", _pml, (2, 2, 1), 2, None, kind="memory",
                       rank_env={"1": {"TIDY3D_TPU_HBM_BYTES": "1000"}}))
    make, decomp, local = RESUME
    cases.append(_case("resume", make, decomp, local, None, kind="resume",
                       every=3, die=8))
    cases.append(dict(name="web", sim=_web_sim().json(), kind="web",
                      env={"TIDY3D_TPU_SHARD": "2,2"}))
    return cases


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """``nproc`` worker processes of one spec, started at once; ``result``
    waits for them (at most ``WORLD_TIMEOUT`` from the start, then kills
    every one), retries once on a fresh port if the coordinator's address
    was taken, and returns each process's ``(arrays, info)``."""

    def __init__(self, cases: list, nproc: int, local_ids: str, out: str):
        self.nproc, self.local_ids, self.out = nproc, local_ids, out
        os.makedirs(out, exist_ok=True)
        self.spec = os.path.join(out, "spec.json")
        with open(self.spec, "w") as f:
            json.dump({"cases": cases}, f)
        self._start()
        self._results = None

    def _start(self):
        port = _free_port()
        self.t0 = time.perf_counter()
        self.procs = []
        for rank in range(self.nproc):
            env = dict(os.environ)
            for key in ("TIDY3D_TPU_SHARD", "TIDY3D_TPU_KSTEP",
                        "TIDY3D_TPU_PRECISION", "TIDY3D_TPU_HBM_BYTES"):
                env.pop(key, None)
            env.update(
                PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
                TIDY3D_TPU_COORDINATOR=f"127.0.0.1:{port}",
                TIDY3D_TPU_NUM_PROCESSES=str(self.nproc),
                TIDY3D_TPU_PROCESS_ID=str(rank),
                TIDY3D_TPU_LOCAL_DEVICE_IDS=self.local_ids,
                TIDY3D_TPU_DIST_TIMEOUT=str(DIST_TIMEOUT),
                TIDY3D_TPU_KERNEL="auto", TIDY3D_TPU_TILE_QUANTA="1,1,1",
                OMP_NUM_THREADS="1")
            self.procs.append(subprocess.Popen(
                [sys.executable, WORKER, self.spec, self.out], cwd=REPO,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))

    def _wait(self) -> list:
        outs = []
        try:
            for p in self.procs:
                left = WORLD_TIMEOUT - (time.perf_counter() - self.t0)
                outs.append(p.communicate(timeout=max(left, 1))[0])
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
                p.communicate()
            raise AssertionError(f"a world of {self.nproc} processes did "
                                 f"not end within {WORLD_TIMEOUT} s")
        return outs

    def result(self) -> list:
        if self._results is None:
            outs = self._wait()
            if any(p.returncode for p in self.procs) and any(
                    "address already in use" in o.lower() for o in outs):
                self._start()
                outs = self._wait()
            for rank, (p, out) in enumerate(zip(self.procs, outs)):
                assert p.returncode == 0, f"process {rank}:\n{out[-4000:]}"
            self.seconds = time.perf_counter() - self.t0
            self._results = []
            for rank in range(self.nproc):
                with np.load(os.path.join(self.out, f"rank{rank}.npz")) as z:
                    arrays = {k: z[k] for k in z.files}
                with open(os.path.join(self.out, f"rank{rank}.json")) as f:
                    self._results.append((arrays, json.load(f)))
        return self._results


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, started before any reference is computed, so that they
    run beside the references."""
    base = tmp_path_factory.mktemp("worlds")
    out = {"two": World(_two_cases(), 2, "0,1", str(base / "two")),
           "four": World([_case("pml_bricks", *FOUR[:4])], 4, "0",
                         str(base / "four"))}
    yield out
    for world in out.values():
        for p in world.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    for key in ("TIDY3D_TPU_KSTEP", "TIDY3D_TPU_SHARD",
                "TIDY3D_TPU_COORDINATOR", "TIDY3D_TPU_PRECISION",
                "TIDY3D_TPU_LOCAL_DEVICE_IDS"):
        monkeypatch.delenv(key, raising=False)


def _raw_of(arrays: dict, case: str) -> dict:
    out = {}
    for key, arr in arrays.items():
        name, idx, comp = key.split("|")
        if name == case:
            out.setdefault(int(idx), {})[comp] = arr
    return out


def _single(plan, decomp, kernel) -> FDTDRunner:
    """The single-process run of the same mesh: virtual CPU shards."""
    mesh, _ = make_mesh(devices=["cpu"] * int(np.prod(decomp)),
                        decomp=decomp)
    return FDTDRunner(plan, device="cpu", kernel=kernel,
                      sharding_plan=ShardingPlan(mesh, plan.shape))


def _bit_equal(ref: dict, got: dict, what: str):
    assert set(ref) == set(got), what
    for idx in ref:
        assert set(ref[idx]) == set(got[idx]), (what, idx)
        for comp, arr in ref[idx].items():
            assert arr.shape == got[idx][comp].shape, (what, idx, comp)
            assert np.array_equal(arr, got[idx][comp]), (what, idx, comp)


def _jax_run(sim, kind: str, k: int) -> dict:
    if kind == "kstep":
        return _jax_with_k(lower_reference(sim), k)[0].run()
    return JaxRunner(lower_reference(sim)).run()


def _check_run(world, name, make, decomp, local, kernel, jax_kind):
    sim = make()
    plan = lower(sim)
    single = _single(plan, decomp, kernel)
    want = single.run()
    ref = _jax_run(sim, jax_kind, single.k) if jax_kind else None
    results = world.result()
    ranks = len(results)
    for rank, (arrays, info) in enumerate(results):
        got = _raw_of(arrays, name)
        _bit_equal(want, got, f"{name}: process {rank} vs single process")
        case = info[name]
        assert case["steps_run"] == single.steps_run, (rank, case)
        assert case["tier"] == single.tier_name, (rank, case)
        assert case["chunks"] > 0
        # each process owns its share of the mesh, and halos crossed
        assert len(case["local_shards"]) == int(np.prod(decomp)) // ranks
        assert case["swaps"] > 0 and case["sent"] > 0, case
    if ref is not None:
        err = _raw_err(ref, want)
        print(f"{name}: {ranks} processes vs JAX {jax_kind} {err:.2e}")
        assert err <= TOL_RUN, f"{name}: vs JAX rel err {err:.2e}"
    return single


@pytest.mark.parametrize("name", sorted(RUNS))
def test_two_process_runs_match_single_process_and_jax(name, worlds):
    make, decomp, local, kernel, jax_kind = RUNS[name]
    single = _check_run(worlds["two"], name, make, decomp, local, kernel,
                        jax_kind)
    if name == "shutoff_bricks":
        assert single.steps_run < single.num_steps, single.steps_run
    if name == "bloch_bricks":
        # the periodic x wall with its phase lies between the processes
        assert single.layout.decomp[0] == 2 and single.halo_phases[0]
    if name == "lorentz_slabs":
        assert single.tier_name == "kstep (k=2, 4 x-shards)"


def test_worlds_report_their_time(worlds):
    for name, world in worlds.items():
        results = world.result()
        print(f"world {name}: {world.seconds:.1f} s wall; per process "
              + ", ".join(f"{info['__seconds__']:.1f}" for _, info in results)
              + "; cases " + ", ".join(
                  f"{case} {info['seconds']:.1f}" for case, info in
                  results[0][1].items() if not case.startswith("__")))
        assert world.seconds < WORLD_TIMEOUT


def test_four_process_bricks_match_single_process_and_jax(worlds):
    _check_run(worlds["four"], "pml_bricks", *FOUR)
    for rank, (_, info) in enumerate(worlds["four"].result()):
        assert info["__group__"] == {"rank": rank, "count": 4,
                                     "backend": "gloo"}


def test_a_process_that_owns_no_mesh_entry_takes_part(worlds):
    """(2, 1, 1) over 2 x 2 devices takes the ring's first two, both of
    process 0: process 1 steps nothing, moves no halo, and still returns
    the whole raw monitors, bit for bit."""
    make, decomp, local, kernel, _ = IDLE
    single = _single(lower(make()), decomp, kernel)
    want = single.run()
    infos = []
    for rank, (arrays, info) in enumerate(worlds["two"].result()):
        _bit_equal(want, _raw_of(arrays, "idle"), f"idle: process {rank}")
        assert info["idle"]["steps_run"] == single.steps_run
        infos.append(info["idle"])
    assert [i["local_shards"] for i in infos] == [[0, 1], []], infos
    assert all(i["swaps"] == 0 for i in infos), infos


def test_a_plain_mesh_runs_whole_in_every_process(worlds):
    """A mesh of ``make_mesh`` in a process group: each process owns every
    entry and runs the whole plan; the gathered monitors count each entry
    once."""
    make, decomp, local, kernel, _ = EVERYWHERE
    want = _single(lower(make()), decomp, kernel).run()
    for rank, (arrays, info) in enumerate(worlds["two"].result()):
        _bit_equal(want, _raw_of(arrays, "everywhere"),
                   f"everywhere: process {rank}")
        assert info["everywhere"]["local_shards"] == [0, 1, 2, 3]
        assert info["everywhere"]["swaps"] == 0


def test_memory_gate_refuses_in_every_process(worlds):
    """``TIDY3D_TPU_HBM_BYTES`` is set in process 1 only: both raise."""
    infos = [info["memory"] for _, info in worlds["two"].result()]
    for info in infos:
        assert "device memory" in info.get("error", ""), infos
    assert infos[0]["error"] == infos[1]["error"]


def test_resume_across_two_processes_matches_uninterrupted(worlds):
    """The run dies in chunk 8 in both processes, each saved its own file
    at chunk 6; fresh runners resume from them and end where the
    uninterrupted run ends; the files are gone afterwards."""
    make, decomp, local = RESUME
    plan = lower(make())
    want = _single(plan, decomp, None).run()
    for rank, (arrays, info) in enumerate(worlds["two"].result()):
        got = _raw_of(arrays, "resume")
        _bit_equal(_raw_of(arrays, "resume:uninterrupted"), got,
                   f"process {rank}: resumed vs uninterrupted")
        _bit_equal(want, got, f"process {rank}: resumed vs single process")
        case = info["resume"]
        assert case["saved"] and not case["left"], case
        assert case["file"] == f"resume.npz.process{rank}"
        assert case["steps_run"] == case["steps_uninterrupted"]


def test_web_run_returns_equal_data_in_every_process(worlds, monkeypatch):
    """``web.run`` under ``TIDY3D_TPU_SHARD=2,2``, a mode source and a mode
    monitor: process 0 lowers and builds the data, every process returns
    it, equal to the single-process run of the same mesh, array for
    array."""
    monkeypatch.setenv("TIDY3D_TPU_SHARD", "2,2")
    data = tt.web.run(_web_sim(), device="cpu", verbose=False)
    want = {}
    for md in data.data:
        for key in type(md).model_fields:
            val = getattr(md, key)
            if hasattr(val, "dims") and hasattr(val, "values"):
                want[f"web|{md.monitor.name}|{key}"] = np.asarray(val.values)
    assert "web|mode|amps" in want and "web|modes|Ey" in want
    results = worlds["two"].result()
    for rank, (arrays, info) in enumerate(results):
        got = {k: v for k, v in arrays.items() if k.startswith("web|")}
        assert set(got) == set(want), rank
        for key, arr in want.items():
            # every process returns process 0's data, bit for bit
            assert np.array_equal(got[key], results[0][0][key]), (rank, key)
            # this process's own run: its mode solves (float64, ARPACK) may
            # round otherwise in another process (BLAS threads)
            err = np.max(np.abs(got[key] - arr)) / max(np.max(np.abs(arr)),
                                                       1e-300)
            assert err <= TOL_MODE_DATA, (rank, key, err)
        assert info["web"]["tier"].startswith("kernel tier: pallas2 (2x2x1"), \
            info["web"]
        assert info["web"]["steps"] == results[0][1]["web"]["steps"]


# --------------------------------------------------------------------------- #
# the ring order and the global mesh (tests/test_solver/test_sharding.py)
# --------------------------------------------------------------------------- #


def test_ring_device_order_without_coords_groups_by_process():
    devs = [SimpleNamespace(type="cpu", index=i, process_index=i // 2)
            for i in (3, 0, 2, 1)]
    order = distributed.ring_device_order(devs)
    procs = [d.process_index for d in order]
    assert procs == sorted(procs)
    assert [d.index for d in order] == [0, 1, 2, 3]
    # a process's devices keep their index order; the CPU repeated keeps
    # its place
    cards = [distributed.ProcessDevice(p, torch.device("cuda", i))
             for p, i in ((1, 1), (0, 1), (1, 0), (0, 0))]
    assert [(d.process_index, d.index) for d in
            distributed.ring_device_order(cards)] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


def test_make_global_mesh_and_env_plan(monkeypatch):
    mesh, decomp = distributed.make_global_mesh(devices=["cpu"] * 8)
    assert decomp == (8, 1, 1) and mesh.shape == decomp
    plan_shape = (32, 32, 32)
    monkeypatch.setenv("TIDY3D_TPU_SHARD", "")
    assert distributed.sharding_plan_from_env(plan_shape, "cpu") is None
    monkeypatch.setenv("TIDY3D_TPU_SHARD", "2,2")
    sp = distributed.sharding_plan_from_env(plan_shape, "cpu")
    assert sp is not None and sp.decomp[:2] == (2, 2)
    # one process without a group owns every entry
    assert np.array_equal(sp.ranks, np.zeros((2, 2, 1), int))
    monkeypatch.setenv("TIDY3D_TPU_SHARD", "auto")
    assert distributed.sharding_plan_from_env((4, 4, 4), "cpu") is None
    # this process's virtual devices: TIDY3D_TPU_LOCAL_DEVICE_IDS
    monkeypatch.setenv("TIDY3D_TPU_LOCAL_DEVICE_IDS", "0,1")
    assert distributed.local_devices("cpu") == [torch.device("cpu")] * 2


def test_a_mesh_of_other_processes_needs_a_group():
    plan = lower(_pml())
    mesh, _ = make_mesh(devices=["cpu"] * 4, decomp=(2, 2, 1))
    ranks = np.array([0, 0, 1, 1]).reshape(2, 2, 1)
    with pytest.raises(ValueError, match="no process group"):
        FDTDRunner(plan, device="cpu",
                   sharding_plan=ShardingPlan(mesh, plan.shape, ranks))
