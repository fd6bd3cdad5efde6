"""Sharded runs from the environment: the single-host part of
``tidy3d_tpu/solver/distributed.py``.

``TIDY3D_TPU_SHARD`` asks for a sharded run as in the JAX package: unset,
``""``, ``"0"`` or ``"none"`` run unsharded; ``"auto"`` splits x over every
device; ``"dx,dy,dz"`` (padded with ones) names the decomposition. One
process drives every shard. The runner takes the plan on x-slabs of the
k-step kernel where that route takes it and on bricks of the ``pallas2``
tier otherwise (any decomposition: ``solver/fdtd.py``). Multi-host runs, which the JAX package joins
through ``jax.distributed.initialize`` and a coordinator, are not ported:
``initialize`` raises when a coordinator is set.

The devices of a CUDA run are the visible CUDA devices, ordered by index.
On the CPU they are the CPU repeated ``CPU_DEVICES`` times, the counterpart
of the eight virtual host devices the JAX package's tests run on
(``--xla_force_host_platform_device_count=8``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..log import log
from .sharding import ShardingPlan, make_mesh

CPU_DEVICES = 8


def initialize(coordinator_address: Optional[str] = None) -> bool:
    """False when no coordinator is configured (a single-host run, the
    only kind the port takes); raises ``NotImplementedError`` when one is
    (argument or ``TIDY3D_TPU_COORDINATOR``)."""
    coordinator_address = coordinator_address or os.environ.get(
        "TIDY3D_TPU_COORDINATOR")
    if coordinator_address:
        raise NotImplementedError(
            f"multi-host runs (coordinator {coordinator_address}) are not "
            "ported yet (ROADMAP.md: multi-host runs)")
    return False


def ring_device_order(devices: Optional[Sequence] = None) -> list:
    """The devices in ring order: CUDA devices by index (one host, all to
    all over NVLink, so any order is a ring of neighbours)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return sorted((torch.device(d) for d in devices),
                  key=lambda d: (d.type, d.index or 0))


def _host_devices(device) -> list:
    device = torch.device(device)
    if device.type == "cuda":
        return ring_device_order()
    return [device] * CPU_DEVICES


def make_global_mesh(decomp: Optional[Tuple[int, int, int]] = None,
                     devices: Optional[Sequence] = None):
    """``(mesh, decomp)`` over ``devices`` (default: the visible CUDA
    devices in ring order), x-only ``(n, 1, 1)`` by default. A
    decomposition that needs fewer devices takes a prefix of the ring; one
    that needs more raises ``ValueError``."""
    ordered = ring_device_order(devices) if devices is None \
        else [torch.device(d) for d in devices]
    n = len(ordered)
    if decomp is None:
        decomp = (n, 1, 1)
    need = int(np.prod(decomp))
    if need > n:
        raise ValueError(f"decomposition {decomp} needs {need} devices, "
                         f"only {n} available")
    return make_mesh(devices=ordered[:need], decomp=decomp)


def sharding_plan_from_env(plan_shape: Tuple[int, int, int], device
                           ) -> Optional[ShardingPlan]:
    """The ``ShardingPlan`` that ``TIDY3D_TPU_SHARD`` asks for on
    ``device``'s kind of device, or None for an unsharded run, decided as
    ``tidy3d_tpu/solver/distributed.py:160-188`` decides."""
    val = os.environ.get("TIDY3D_TPU_SHARD", "").strip()
    if val in ("", "0", "none"):
        return None
    initialize()
    if val == "auto":
        decomp = None
    else:
        parts = tuple(int(v) for v in val.split(","))
        decomp = parts + (1,) * (3 - len(parts))
    mesh, decomp = make_global_mesh(decomp, _host_devices(device))
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
