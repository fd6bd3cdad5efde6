"""Domain decomposition of the FDTD state: the counterpart of
``tidy3d_tpu/solver/sharding.py``.

A mesh is a numpy object array of ``torch.device``s shaped like the grid
decomposition ``(dx, dy, dz)``, as ``jax.sharding.Mesh.devices`` is. A
mesh may name one device several times: each entry is then a "virtual
shard" with its own tensors and its own kernel launches on that device.
That is how the tests (on the CPU) and ``chip_smoke.py`` (on one card) run
the sharded path. One process drives every shard.

The port runs two layouts:

* ``XSlabs``: x-only slabs on the k-step kernel, with a ring halo exchange
  of k planes before every group. Single-axis y and z decompositions reach
  it through the plan rotation of ``plan_rotate.py``.
* ``Bricks``: any ``(dx, dy, dz)`` decomposition on the one-step
  ``pallas2`` tier, the counterpart of the JAX package's GSPMD placement
  (``ShardingPlan``, ``make_mesh``): each axis splits as
  ``np.array_split`` splits it, and each brick holds its owned cells plus
  one halo plane on each decomposed side, in tensors of their own. Each
  step exchanges twice: the H lo halos before the E family, the E hi halos
  before the H family; the halo that crosses a periodic wall with a Bloch
  phase carries the phase.

``ShardingPlan`` keeps the mesh and its decomposition; the runner
(``fdtd.py``) picks the layout.
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


def split_sizes(n: int, parts: int) -> list:
    """The extents of ``parts`` consecutive pieces of ``n`` planes, as
    ``np.array_split`` cuts them: the first ``n % parts`` one plane
    longer."""
    return [n // parts + (i < n % parts) for i in range(parts)]


class Bricks:
    """The brick layout of a sharded one-step (``pallas2``) run.

    Axis a of a grid of ``shape`` splits into ``decomp[a]`` pieces
    (``split_sizes``: extents differ by one plane at most, and a piece may
    be one plane thick); brick s is mesh entry s in row-major order, its
    coordinates ``coords(s)``. A brick's arrays hold exactly its owned
    cells. Its halo planes, one on each side of each decomposed axis that
    has a neighbour (``halo(s)``: always on a periodic axis, whose first
    and last bricks are neighbours), are tensors of their own: the planes
    the curl reads across that side, shaped as the brick with that axis
    one plane thick. Only face planes are needed (the curl reads its
    neighbours along one axis at a time) and only on the side that the
    family's difference crosses: backward differences of H for the E
    family (lo halos), forward differences of E^{n+1} for the H family (hi
    halos). A side without a halo is the global wall, which the kernel
    applies as in an unsharded run; an axis that is not decomposed keeps
    its own wall or wrap."""

    def __init__(self, shape, decomp, periodic):
        self.shape = tuple(int(n) for n in shape)
        self.decomp = tuple(int(d) for d in decomp)
        self.periodic = tuple(bool(p) for p in periodic)
        self.sizes = [split_sizes(n, d) for n, d in zip(self.shape,
                                                        self.decomp)]
        for a, sizes in enumerate(self.sizes):
            if min(sizes) < 1:
                raise ValueError(f"axis {a} of {self.shape[a]} planes does "
                                 f"not split into {self.decomp[a]} bricks")
        self.starts = [np.concatenate([[0], np.cumsum(sz)[:-1]]).tolist()
                       for sz in self.sizes]
        self.n = int(np.prod(self.decomp))

    def coords(self, s: int) -> Tuple[int, int, int]:
        return tuple(int(c) for c in np.unravel_index(s, self.decomp))

    def index(self, coords) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.decomp))

    def origin(self, s: int) -> Tuple[int, int, int]:
        """The global cell of brick s's first owned cell."""
        return tuple(st[c] for st, c in zip(self.starts, self.coords(s)))

    def extent(self, s: int) -> Tuple[int, int, int]:
        return tuple(sz[c] for sz, c in zip(self.sizes, self.coords(s)))

    def halo(self, s: int) -> Tuple[Tuple[bool, bool], ...]:
        """Per axis, whether brick s reads a (lo, hi) halo plane."""
        out = []
        for a, c in enumerate(self.coords(s)):
            d = self.decomp[a]
            if d == 1:
                out.append((False, False))
            else:
                out.append((self.periodic[a] or c > 0,
                            self.periodic[a] or c < d - 1))
        return tuple(out)

    def neighbour(self, s: int, axis: int, side: int) -> int:
        """The brick across side ``side`` (0 lo, 1 hi) of ``axis``."""
        c = list(self.coords(s))
        c[axis] = (c[axis] + (1 if side else -1)) % self.decomp[axis]
        return self.index(c)

    def crosses_wall(self, s: int, axis: int, side: int) -> bool:
        """Whether brick s's halo on that side lies across the global
        (periodic) wall."""
        c = self.coords(s)[axis]
        return c == (self.decomp[axis] - 1 if side else 0)

    def owned_slices(self, s: int) -> Tuple[slice, slice, slice]:
        return tuple(slice(o, o + e) for o, e in zip(self.origin(s),
                                                     self.extent(s)))

    def take(self, arr, s: int):
        """Brick s's cells of a global array (numpy or tensor): each axis
        as long as the grid's is cut to the owned range, an axis of one
        cell (a broadcast coefficient) is kept."""
        sl = tuple(own if arr.shape[a] == self.shape[a] else slice(None)
                   for a, own in enumerate(self.owned_slices(s)))
        if isinstance(arr, torch.Tensor):
            return arr[sl].contiguous()
        return np.ascontiguousarray(np.asarray(arr)[sl])

    def owned_range(self, s: int, axis: int, start: int, stop: int):
        """``(lo, hi)``: the part of global planes ``[start, stop)`` of
        ``axis`` that brick s owns, in its local coordinates, or None
        where it owns none."""
        o, e = self.origin(s)[axis], self.extent(s)[axis]
        lo, hi = max(start, o), min(stop, o + e)
        if lo >= hi:
            return None
        return lo - o, hi - o

    def halo_shape(self, s: int, axis: int) -> Tuple[int, int, int]:
        shape = list(self.extent(s))
        shape[axis] = 1
        return tuple(shape)

    def exchange(self, fields: list, halos: list, side: int,
                 phases=(None, None, None)) -> None:
        """One halo exchange, in place: ``fields[s]`` lists brick s's
        copies (one, or the two of a Bloch run) of the family whose planes
        are read, ``{comp: tensor}`` each; ``halos[s]`` the same copies'
        halo planes ``{axis: {comp: tensor}}`` on ``side`` (0 lo, 1 hi).
        Each halo takes the neighbour's core plane that touches it (the
        lo halo the neighbour's last plane, the hi halo its first). A halo
        across the global wall of an axis with a Bloch phase ``phases[a] =
        (c, s)`` mixes the copies as ``_wrap_col`` does
        (``tidy3d_tpu/solver/fdtd.py:861-893``): ``F(-1) = e^{-i phi}
        F(N - 1)``, ``F(N) = e^{i phi} F(0)``, so copy 0 takes ``c F0 +- s
        F1`` and copy 1 ``c F1 -+ s F0`` (upper signs lo); the mix is
        computed in float32 and rounded once to the halo's type. This is
        the only place where a sharded run's copies mix. A plane keeps its
        array's storage type.

        When every brick lies on one device the plain copies go in one
        ``_foreach_copy_`` on its current stream (the y and z planes are
        strided views of the neighbour's arrays). Across devices each
        brick's stream first waits for an event recorded on each
        neighbour's stream after its last launch, then pulls the planes
        with non-blocking peer copies."""
        dst, src, mixes = [], [], []
        for s, copies in enumerate(halos):
            for a in copies[0]:
                t = self.neighbour(s, a, side)
                at = self.extent(t)[a] - 1 if side == 0 else 0
                wall = self.crosses_wall(s, a, side) \
                    and phases[a] is not None
                for p, copy in enumerate(copies):
                    for comp, h in copy[a].items():
                        core = fields[t][p][comp].narrow(a, at, 1)
                        if not wall:
                            dst.append(h)
                            src.append(core)
                            continue
                        c, sn = phases[a]
                        sgn = (1.0 if p == 0 else -1.0) * (
                            1.0 if side == 0 else -1.0)
                        other = fields[t][1 - p][comp].narrow(a, at, 1)
                        mixes.append((h, core, other, c, sgn * sn))
        devices = [next(iter(copies[0].values())).device
                   for copies in fields]
        if len(set(devices)) == 1:
            if dst:
                torch._foreach_copy_(dst, src)
            for h, core, other, c, sn in mixes:
                h.copy_(core.float() * c + other.float() * sn)
            return
        events = []
        for dev in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        for s in range(len(fields)):
            with torch.cuda.device(devices[s]):
                stream = torch.cuda.current_stream(devices[s])
                for a in halos[s][0]:
                    stream.wait_event(events[self.neighbour(s, a, side)])
        for d, v in zip(dst, src):
            with torch.cuda.device(d.device):
                d.copy_(v, non_blocking=True)
        for h, core, other, c, sn in mixes:
            with torch.cuda.device(h.device):
                h.copy_(core.to(h.device, non_blocking=True).float() * c
                        + other.to(h.device, non_blocking=True).float()
                        * sn)
