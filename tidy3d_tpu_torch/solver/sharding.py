"""Domain decomposition of the FDTD state: the counterpart of
``tidy3d_tpu/solver/sharding.py``.

A mesh is a numpy object array of ``torch.device``s shaped like the grid
decomposition ``(dx, dy, dz)``, as ``jax.sharding.Mesh.devices`` is. A
mesh may name one device several times: each entry is then a "virtual
shard" with its own tensors and its own kernel launches on that device.
That is how the tests (on the CPU) and ``chip_smoke.py`` (on one card) run
the sharded path.

The port runs one decomposition: x-only slabs on the k-step kernel
(``XSlabs``), one process driving every shard, with a ring halo exchange
before every group (``FDTDRunner``). Single-axis y and z decompositions
reach it through the plan rotation of ``plan_rotate.py``. The JAX
package's GSPMD path, which takes mixed 2D/3D layouts, has no counterpart
here, so ``ShardingPlan`` keeps only the mesh and its decomposition.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

def make_mesh(n_devices: int = None, devices=None,
              decomp: Tuple[int, int, int] = None):
    """``(mesh, decomp)`` for a (dx, dy, dz) grid decomposition over
    ``devices`` (a list of devices, repeats allowed) or the first
    ``n_devices`` CUDA devices. ``decomp`` defaults to ``(n, 1, 1)``."""
    if devices is None:
        count = torch.cuda.device_count()
        n = n_devices or count
        if n > count:
            raise ValueError(f"{n} devices asked for, {count} CUDA devices "
                             "visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if decomp is None:
        decomp = (n, 1, 1)
    decomp = tuple(int(d) for d in decomp)
    if int(np.prod(decomp)) != n:
        raise ValueError(f"decomposition {decomp} does not match {n} devices")
    mesh = np.empty(n, dtype=object)
    mesh[:] = devices
    return mesh.reshape(decomp), decomp


class ShardingPlan:
    """A mesh of devices and the grid it decomposes."""

    def __init__(self, mesh: np.ndarray, shape: Tuple[int, int, int]):
        self.mesh = mesh
        self.shape = tuple(shape)
        self.decomp = tuple(mesh.shape)

    @property
    def devices(self) -> list:
        """The mesh's devices in x order (row-major)."""
        return list(mesh_devices(self.mesh))


def mesh_devices(mesh: np.ndarray):
    return mesh.reshape(-1).tolist()


class XSlabs:
    """The x-slab layout of a sharded k-step run.

    Shard s owns the global planes ``[s nx_loc, (s + 1) nx_loc)`` and holds
    every x-spanning array padded by ``pad`` (= k) halo planes on each
    side: local plane i is padded plane ``i + pad``. x is the slowest axis,
    so each halo is one contiguous block of an array. A side is a halo
    (``halo(s)``) when it has a neighbour in the ring, which it always has
    on a periodic x axis; otherwise it is the global x edge, whose wall
    the shard applies itself and whose halo is never read."""

    def __init__(self, nx: int, ndev: int, pad: int, periodic: bool):
        if nx % ndev:
            raise ValueError(f"{nx} x planes do not split into {ndev} shards")
        self.nx, self.ndev, self.pad = nx, ndev, pad
        self.nx_loc = nx // ndev
        self.periodic = periodic

    @property
    def padded(self) -> int:
        return self.nx_loc + 2 * self.pad

    def x0(self, s: int) -> int:
        """The first global plane shard s owns."""
        return s * self.nx_loc

    def halo(self, s: int) -> Tuple[bool, bool]:
        """Whether shard s reads its (lo, hi) halo planes."""
        return (self.periodic or s > 0,
                self.periodic or s < self.ndev - 1)

    def index(self, s: int) -> np.ndarray:
        """The global plane of each padded plane of shard s, on the ring
        (halo planes past a global edge wrap; a non-periodic shard never
        reads them)."""
        return (np.arange(-self.pad, self.nx_loc + self.pad)
                + self.x0(s)) % self.nx

    def take(self, arr, s: int):
        """Shard s's padded x-slice of a global array (numpy or tensor)
        whose axis 0 is x."""
        idx = self.index(s)
        if isinstance(arr, torch.Tensor):
            return arr[torch.as_tensor(idx, device=arr.device)].contiguous()
        return np.ascontiguousarray(np.asarray(arr)[idx])

    def owned(self, arr):
        """The owned planes of a padded array (a view)."""
        return arr[self.pad:self.pad + self.nx_loc]

    def exchange(self, arrays: list) -> None:
        """The ring halo exchange (``pallas_kstep.py:1386-1421``), in
        place: ``arrays[s]`` lists shard s's padded arrays, in the same
        order on every shard. Each shard's lo halo planes take its left
        neighbour's top ``pad`` core planes, its hi halo planes its right
        neighbour's bottom ``pad``; shard 0's left neighbour is the last
        shard, and a lone shard is its own neighbour. A plane keeps its
        array's storage type (float32 or bfloat16: the shards' arrays of
        one kind share it), as the reference casts each halo to its
        array's type (``pallas_kstep.py:1408-1411``). Only halo planes are
        written and only core planes read, so the copies commute, and each
        is one contiguous block (x is the slowest axis). When every shard
        lies on one device, all the copies go in one ``_foreach_copy_``
        on its current stream: a ``copy_`` per block cost about 25 us of
        host time each, 224 blocks per group on a 384^3 dispersive run in
        4 shards (PERF.md). Across devices each shard's
        stream first waits for an event recorded on each neighbour's
        stream after its last launch, then pulls the planes with
        non-blocking peer copies."""
        n, pad, nl = self.ndev, self.pad, self.nx_loc
        dst, src = [], []
        for s in range(n):
            for mine, lo, hi in zip(arrays[s], arrays[(s - 1) % n],
                                    arrays[(s + 1) % n]):
                dst += [mine[:pad], mine[pad + nl:]]
                src += [lo[nl:nl + pad], hi[pad:2 * pad]]
        devices = [a[0].device for a in arrays]
        if len(set(devices)) == 1:
            torch._foreach_copy_(dst, src)
            return
        events = []
        for dev in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        per = len(dst) // n
        for s in range(n):
            with torch.cuda.device(devices[s]):
                stream = torch.cuda.current_stream(devices[s])
                stream.wait_event(events[(s - 1) % n])
                stream.wait_event(events[(s + 1) % n])
                for d, v in zip(dst[s * per:(s + 1) * per],
                                src[s * per:(s + 1) * per]):
                    d.copy_(v, non_blocking=True)

    def owned_range(self, s: int, start: int, stop: int):
        """``(lo, hi)``: the part of global planes ``[start, stop)`` that
        shard s owns, in padded coordinates, or None where it owns none."""
        lo = max(start, self.x0(s))
        hi = min(stop, self.x0(s) + self.nx_loc)
        if lo >= hi:
            return None
        shift = self.pad - self.x0(s)
        return lo + shift, hi + shift
