"""Sharded runs from the environment and across processes: the counterpart
of ``tidy3d_tpu/solver/distributed.py`` on ``torch.distributed``.

``TIDY3D_TPU_SHARD`` asks for a sharded run as in the JAX package: unset,
``""``, ``"0"`` or ``"none"`` run unsharded; ``"auto"`` splits x over every
device; ``"dx,dy,dz"`` (padded with ones) names the decomposition. The
runner takes the plan on x-slabs of the k-step kernel where that route
takes it and on bricks of the ``pallas2`` tier otherwise (any
decomposition: ``solver/fdtd.py``).

Processes join one ``torch.distributed`` process group through a
coordinator (``initialize``: an argument or ``TIDY3D_TPU_COORDINATOR``,
``TIDY3D_TPU_NUM_PROCESSES`` and ``TIDY3D_TPU_PROCESS_ID``, as the JAX
package reads them). The group's backend follows the run's device: NCCL
for a CUDA run, gloo for a CPU run; a CUDA run also opens a gloo side group
for host objects (plans, monitor parts, flags), and nothing else rides it.
``make_global_mesh`` then spans every process's devices, ring-ordered by
process, and each process builds and steps only the mesh entries it owns
(``sharding.ShardingPlan.ranks``). Without a coordinator nothing joins and
one process drives every shard.

This process's devices are, on a CUDA run, the cards of
``local_device_ids`` (or ``TIDY3D_TPU_LOCAL_DEVICE_IDS``, default every
visible card); on the CPU, the CPU repeated once per entry of
``local_device_ids`` (default ``CPU_DEVICES`` times, the counterpart of the
eight virtual host devices the JAX package's tests run on,
``--xla_force_host_platform_device_count=8``).
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..log import log
from .sharding import ProcessMesh, ShardingPlan, make_mesh

CPU_DEVICES = 8
# seconds a collective or a halo transfer may wait for the other processes
# before it fails (TIDY3D_TPU_DIST_TIMEOUT): a process that died or took
# another branch makes the others raise, not wait forever
DEFAULT_TIMEOUT_S = 600

# the process group this module started: its local device ids and, on a
# CUDA run, the gloo side group for host objects
_GROUP = {"local_ids": None, "host": None}


def _env_ints(name: str) -> Optional[list]:
    val = os.environ.get(name, "").strip()
    return [int(v) for v in val.split(",")] if val else None


def timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(os.environ.get(
        "TIDY3D_TPU_DIST_TIMEOUT", DEFAULT_TIMEOUT_S)))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               device=None) -> bool:
    """Joins this process to the process group (idempotent).

    The coordinator, the process count and this process's index come from
    the arguments or from ``TIDY3D_TPU_COORDINATOR`` (``host:port``),
    ``TIDY3D_TPU_NUM_PROCESSES`` and ``TIDY3D_TPU_PROCESS_ID``. With no
    coordinator it returns False: a single-process run. With one it calls
    ``init_process_group`` on ``tcp://<coordinator>`` with an explicit
    timeout, NCCL when ``device`` (default: CUDA when a card is visible) is
    a CUDA device and gloo otherwise, checks the group with one all-reduce
    (a failed NCCL start raises; nothing falls back to gloo) and returns
    True. ``local_device_ids`` (or ``TIDY3D_TPU_LOCAL_DEVICE_IDS``) names
    this process's cards; on the CPU its length is the number of virtual
    devices it contributes."""
    device = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        if backend not in str(dist.get_backend()):
            raise RuntimeError(
                f"the process group runs {dist.get_backend()}, a "
                f"{device.type} run needs {backend}")
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "TIDY3D_TPU_COORDINATOR")
    if not coordinator_address:
        return False
    if num_processes is None:
        num_processes = os.environ.get("TIDY3D_TPU_NUM_PROCESSES")
    if process_id is None:
        process_id = os.environ.get("TIDY3D_TPU_PROCESS_ID")
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address}: the process count and this "
            "process's index are needed too (num_processes and process_id, "
            "or TIDY3D_TPU_NUM_PROCESSES and TIDY3D_TPU_PROCESS_ID)")
    num_processes, process_id = int(num_processes), int(process_id)
    ids = list(local_device_ids) if local_device_ids is not None \
        else _env_ints("TIDY3D_TPU_LOCAL_DEVICE_IDS")
    kw = {}
    if backend == "nccl":
        card = torch.device("cuda", (ids or [0])[0])
        torch.cuda.set_device(card)
        kw["device_id"] = card
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timeout(), **kw)
    _GROUP["local_ids"] = ids
    if backend == "nccl":
        _GROUP["host"] = dist.new_group(backend="gloo", timeout=timeout())
    # the first collective: a group that cannot start fails here
    probe = torch.ones(1, device=kw.get("device_id", "cpu"))
    dist.all_reduce(probe)
    if int(probe.item()) != num_processes:
        raise RuntimeError(f"the process group's probe summed to "
                           f"{probe.item()}, not {num_processes}")
    log.info(f"process group up: process {process_index()} / "
             f"{process_count()} on {backend}"
             + (f" (NCCL {nccl_version()})" if backend == "nccl" else ""))
    return True


def shutdown() -> None:
    """Leaves the process group that ``initialize`` joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUP.update(local_ids=None, host=None)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def nccl_version() -> str:
    return ".".join(map(str, torch.cuda.nccl.version()))


def host_group():
    """The group that carries host objects: the gloo side group of a CUDA
    run, else the default group."""
    return _GROUP["host"]


def all_gather_object(obj) -> list:
    """Every process's ``obj``, by process index (host objects, gloo)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj, group=host_group())
    return out


def broadcast_object(obj, src: int = 0):
    """Process ``src``'s ``obj`` in every process (host objects, gloo)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=host_group())
    return box[0]


def on_process_zero(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` computed by process 0 and handed to every
    process; an exception there is raised in every process (as a
    ``RuntimeError`` naming it, elsewhere) instead of leaving them waiting.
    Without a process group, just the call."""
    if not dist.is_initialized():
        return fn(*args, **kwargs)
    result = error = None
    if process_index() == 0:
        try:
            result = fn(*args, **kwargs)
        except Exception as exc:     # handed on, then raised below
            error = exc
    result, failed = broadcast_object(
        (result, None if error is None else repr(error)))
    if error is not None:
        raise error
    if failed is not None:
        raise RuntimeError(f"process 0 failed: {failed}")
    return result


@contextlib.contextmanager
def process_zero_first(active: bool = True):
    """Process 0 runs the block first and the others after it has (a
    barrier on the host group): a kernel library that every process builds
    at first use is then built once and loaded by the rest."""
    if not (active and dist.is_initialized()):
        yield
        return
    if process_index() != 0:
        dist.barrier(group=host_group())
    try:
        yield
    finally:
        if process_index() == 0:
            dist.barrier(group=host_group())


def all_max(value: torch.Tensor) -> torch.Tensor:
    """The largest ``value`` (a one-element tensor, on the group's device:
    the card of a CUDA run, over NCCL) over every process, in place."""
    if dist.is_initialized():
        dist.all_reduce(value, op=dist.ReduceOp.MAX)
    return value


def agree(error: Optional[str], exc_type=RuntimeError) -> None:
    """A collective decision: raises ``exc_type`` in every process when
    any process brings an ``error`` message (the first one's), so that
    all raise or none does."""
    errors = [e for e in all_gather_object(error) if e]
    if errors:
        raise exc_type(errors[0])


class ProcessDevice(NamedTuple):
    """One entry of the global device list: a device of process
    ``process_index`` (``device`` as that process names it)."""
    process_index: int
    device: torch.device

    @property
    def type(self) -> str:
        return self.device.type

    @property
    def index(self):
        return self.device.index


def ring_device_order(devices: Optional[Sequence] = None) -> list:
    """The devices in ring order: by process (``process_index``, 0 for a
    plain ``torch.device``), then CUDA devices by index, as the JAX
    package's key orders devices without chip coordinates
    (``tidy3d_tpu/solver/distributed.py:119-130``); one host's cards are
    all to all over NVLink, so any order of them is a ring of neighbours.
    Equal keys (the CPU repeated) keep their order."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [d if hasattr(d, "type") else torch.device(d)
               for d in devices]
    return sorted(devices, key=lambda d: (
        getattr(d, "process_index", 0), d.type, d.index or 0))


def local_devices(device) -> list:
    """This process's devices of ``device``'s kind (the module's
    docstring)."""
    device = torch.device(device)
    ids = _GROUP["local_ids"] if dist.is_initialized() \
        else _env_ints("TIDY3D_TPU_LOCAL_DEVICE_IDS")
    if device.type == "cuda":
        if ids is not None:
            return [torch.device("cuda", i) for i in ids]
        return ring_device_order()
    return [device] * (len(ids) if ids is not None else CPU_DEVICES)


def make_global_mesh(decomp: Optional[Tuple[int, int, int]] = None,
                     devices: Optional[Sequence] = None):
    """``(mesh, decomp)`` over ``devices``, x-only ``(n, 1, 1)`` by
    default. Without a process group: over ``devices`` as given (default:
    the visible CUDA devices in ring order), a plain mesh. In a process
    group ``devices`` are this process's (default: every visible card);
    every process's list is gathered and ring-ordered by process, and the
    mesh is a ``ProcessMesh`` whose ``ranks`` name each entry's process. A
    decomposition that needs fewer devices takes a prefix of the ring; one
    that needs more raises ``ValueError``."""
    if not dist.is_initialized():
        ordered = ring_device_order(devices) if devices is None \
            else [torch.device(d) for d in devices]
    else:
        local = ring_device_order() if devices is None else devices
        lists = all_gather_object([str(torch.device(d)) for d in local])
        ordered = ring_device_order([
            ProcessDevice(p, torch.device(d))
            for p, names in enumerate(lists) for d in names])
    n = len(ordered)
    if decomp is None:
        decomp = (n, 1, 1)
    need = int(np.prod(decomp))
    if need > n:
        raise ValueError(f"decomposition {decomp} needs {need} devices, "
                         f"only {n} available")
    ordered = ordered[:need]
    if not dist.is_initialized():
        return make_mesh(devices=ordered, decomp=decomp)
    mesh, decomp = make_mesh(devices=[d.device for d in ordered],
                             decomp=decomp)
    ranks = np.array([d.process_index for d in ordered]).reshape(decomp)
    return ProcessMesh(mesh, ranks), decomp


def sharding_plan_from_env(plan_shape: Tuple[int, int, int], device
                           ) -> Optional[ShardingPlan]:
    """The ``ShardingPlan`` that ``TIDY3D_TPU_SHARD`` asks for on
    ``device``'s kind of device, or None for an unsharded run, decided as
    ``tidy3d_tpu/solver/distributed.py:160-188`` decides; with a
    coordinator configured, over every process's devices."""
    val = os.environ.get("TIDY3D_TPU_SHARD", "").strip()
    if val in ("", "0", "none"):
        return None
    initialize(device=device)
    if val == "auto":
        decomp = None
    else:
        parts = tuple(int(v) for v in val.split(","))
        decomp = parts + (1,) * (3 - len(parts))
    mesh, decomp = make_global_mesh(decomp, local_devices(device))
    if int(np.prod(decomp)) == 1:
        return None
    # refuse decompositions the grid can't carry
    for ax in range(3):
        if decomp[ax] > 1 and plan_shape[ax] < 2 * decomp[ax]:
            log.warning(
                f"TIDY3D_TPU_SHARD={val}: axis {ax} too small for "
                f"{decomp[ax]}-way decomposition; running unsharded")
            return None
    return ShardingPlan(mesh, plan_shape)
