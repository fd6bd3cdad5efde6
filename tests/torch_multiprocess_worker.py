"""One process of a multi-process world of the port, on the CPU.

``tests/test_torch_multiprocess.py`` starts one of these per process:

    python tests/torch_multiprocess_worker.py SPEC.json OUT_DIR

with ``TIDY3D_TPU_COORDINATOR``, ``TIDY3D_TPU_NUM_PROCESSES``,
``TIDY3D_TPU_PROCESS_ID`` (and ``TIDY3D_TPU_LOCAL_DEVICE_IDS``,
``TIDY3D_TPU_DIST_TIMEOUT``) in its environment. The process joins the gloo
group, runs every case of the spec in order (the same on every process),
and writes ``rank<i>.npz`` (each case's raw monitors or ``SimulationData``
arrays, named ``case|monitor|component``) and ``rank<i>.json`` (per case:
``steps_run``, the tier, the transport's traffic, an expected error's
message) to ``OUT_DIR``. It imports nothing of JAX or the JAX package, and
checks so before it writes. A case that fails unexpectedly ends the process
with a non-zero code (its peers then fail within the group's timeout).

A case (``SPEC["cases"]``) is a dict: ``name``; ``sim``, a port
``Simulation``'s JSON; ``kind``: ``run`` (``FDTDRunner.run`` over
``make_global_mesh(decomp, ["cpu"] * local)``), ``resume`` (a run saving
every ``every`` chunks that dies in chunk ``die``, resumed by a fresh
runner, beside the uninterrupted run), ``memory`` (``check_memory_budget``,
expected to raise) or ``web`` (``web.run`` under ``TIDY3D_TPU_SHARD``);
``decomp``, ``local``, ``kernel``, ``plain`` (a plain mesh, each process
owning every entry) and ``env`` (set for the case, and ``rank_env`` on one
process only).
"""

import json
import os
import sys
import time

import numpy as np


def _set_env(env: dict) -> dict:
    old = {key: os.environ.get(key) for key in env}
    os.environ.update({key: str(val) for key, val in env.items()})
    return old


def _restore(old: dict) -> None:
    for key, val in old.items():
        if val is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = val


def _runner(case, plan):
    from tidy3d_tpu_torch.solver import distributed
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
    from tidy3d_tpu_torch.solver.sharding import ShardingPlan, make_mesh

    if case.get("plain"):
        # a plain mesh: this process owns every entry
        mesh, _ = make_mesh(devices=["cpu"] * case["local"],
                            decomp=tuple(case["decomp"]))
    else:
        mesh, _ = distributed.make_global_mesh(tuple(case["decomp"]),
                                               ["cpu"] * case["local"])
    return FDTDRunner(plan, device="cpu", kernel=case.get("kernel"),
                      sharding_plan=ShardingPlan(mesh, plan.shape))


def _put_raw(arrays: dict, prefix: str, raw: dict) -> None:
    for idx, mon in raw.items():
        for comp, arr in mon.items():
            arrays[f"{prefix}|{idx}|{comp}"] = arr


def _put_data(arrays: dict, prefix: str, sim_data) -> None:
    for md in sim_data.data:
        for key in type(md).model_fields:
            val = getattr(md, key)
            if hasattr(val, "dims") and hasattr(val, "values"):
                arrays[f"{prefix}|{md.monitor.name}|{key}"] = np.asarray(
                    val.values)


def _traffic(runner) -> dict:
    t = runner.transport
    return {"swaps": 0 if t is None else t.swaps,
            "sent": 0 if t is None else t.sent,
            "local_shards": [sh.index for sh in runner.shards]}


def run_case(case, rank: int, arrays: dict, out_dir: str) -> dict:
    import tidy3d_tpu_torch as td
    from tidy3d_tpu_torch.exceptions import SetupError
    from tidy3d_tpu_torch.solver.lowering import lower

    name = case["name"]
    sim = td.Simulation.parse_raw(case["sim"])
    info = {}
    if case["kind"] == "web":
        data = td.web.run(sim, device="cpu", verbose=False)
        _put_data(arrays, name, data)
        tier = [line for line in data.log.splitlines()
                if line.startswith("kernel tier:")]
        return {"tier": tier[0] if tier else None,
                "steps": [line for line in data.log.splitlines()
                          if line.startswith("steps run:")][0]}
    plan = lower(sim)
    runner = _runner(case, plan)
    info["tier"] = runner.tier_name
    if case["kind"] == "memory":
        try:
            runner.check_memory_budget()
        except SetupError as exc:
            info["error"] = str(exc)
        return info
    if case["kind"] == "run":
        raw = runner.run()
        _put_raw(arrays, name, raw)
        info.update(steps_run=runner.steps_run, **_traffic(runner))
        info["chunks"] = len(runner.chunk_records)
        return info
    # resume: the uninterrupted run, a run that dies, a fresh one resumed
    path = os.path.join(out_dir, f"{name}.npz")
    _put_raw(arrays, name + ":uninterrupted", runner.run())
    info["steps_uninterrupted"] = runner.steps_run
    dying = _runner(case, plan)
    run_steps, calls = dying.run_steps, []

    def dies(start, num, state):
        calls.append(start)
        if len(calls) == case["die"]:
            raise RuntimeError("preempted")
        return run_steps(start, num, state)

    dying.run_steps = dies
    try:
        dying.run_checkpointed(path, checkpoint_every=case["every"])
    except RuntimeError as exc:
        if "preempted" not in str(exc):
            raise
    own = dying.checkpoint_file(path)
    info["saved"] = os.path.exists(own)
    resumed = _runner(case, plan)
    _put_raw(arrays, name, resumed.run_checkpointed(
        path, checkpoint_every=case["every"]))
    info.update(steps_run=resumed.steps_run, file=os.path.basename(own),
                left=os.path.exists(own))
    return info


def main(spec_path: str, out_dir: str) -> int:
    import torch

    torch.set_num_threads(1)
    from tidy3d_tpu_torch.solver import distributed

    t0 = time.perf_counter()
    rank = int(os.environ["TIDY3D_TPU_PROCESS_ID"])
    with open(spec_path) as f:
        spec = json.load(f)
    assert distributed.initialize(device="cpu")
    assert distributed.process_index() == rank
    arrays, infos = {}, {}
    for case in spec["cases"]:
        env = dict(case.get("env", {}))
        env.update(case.get("rank_env", {}).get(str(rank), {}))
        old = _set_env(env)
        t0 = time.perf_counter()
        try:
            infos[case["name"]] = run_case(case, rank, arrays, out_dir)
        finally:
            _restore(old)
        infos[case["name"]]["seconds"] = time.perf_counter() - t0
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "tidy3d_tpu"))
    assert not leaked, f"imported {leaked[:5]}"
    infos["__seconds__"] = time.perf_counter() - t0
    infos["__group__"] = {"rank": rank,
                          "count": distributed.process_count(),
                          "backend": str(torch.distributed.get_backend())}
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(infos, f)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
