"""Domain decomposition of the FDTD state: the counterpart of
``tidy3d_tpu/solver/sharding.py``.

A mesh is a numpy object array of ``torch.device``s shaped like the grid
decomposition ``(dx, dy, dz)``, as ``jax.sharding.Mesh.devices`` is. A
mesh may name one device several times: each entry is then a "virtual
shard" with its own tensors and its own kernel launches on that device.
That is how the tests (on the CPU) and ``chip_smoke.py`` (on one card) run
the sharded path. In a process group each entry belongs to one process
(``ShardingPlan.ranks``); a process builds and steps only its own entries,
and halo planes between entries of two processes go through the group
(``Transport``).

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
import torch.distributed as dist


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


class ProcessMesh:
    """A mesh over the devices of several processes
    (``distributed.make_global_mesh``): ``devices``, the mesh of
    ``torch.device`` s as each entry's process names them, and ``ranks``,
    each entry's process index, of the same shape."""

    def __init__(self, devices: np.ndarray, ranks: np.ndarray):
        self.devices = devices
        self.ranks = np.asarray(ranks, dtype=int).reshape(devices.shape)

    @property
    def shape(self):
        return self.devices.shape

    def reshape(self, *shape):
        return self.devices.reshape(*shape)


class ShardingPlan:
    """A mesh of devices, the grid it decomposes and the process that owns
    each mesh entry (``ranks``: from a ``ProcessMesh``, else this process
    everywhere, so that one process drives every shard)."""

    def __init__(self, mesh, shape: Tuple[int, int, int],
                 ranks: np.ndarray = None):
        if isinstance(mesh, ProcessMesh):
            ranks = mesh.ranks if ranks is None else ranks
            mesh = mesh.devices
        self.mesh = mesh
        self.shape = tuple(shape)
        self.decomp = tuple(mesh.shape)
        me = dist.get_rank() if dist.is_initialized() else 0
        self.ranks = np.full(mesh.shape, me) if ranks is None \
            else np.asarray(ranks, dtype=int).reshape(mesh.shape)

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

    def exchange(self, arrays: list, shards=None, transport=None) -> None:
        """The ring halo exchange (``pallas_kstep.py:1386-1421``), in
        place: ``arrays[i]`` lists the padded arrays of shard
        ``shards[i]`` (default: every shard, in order), in the same order
        on every shard. Each shard's lo halo planes take its left
        neighbour's top ``pad`` core planes, its hi halo planes its right
        neighbour's bottom ``pad``; shard 0's left neighbour is the last
        shard, and a lone shard is its own neighbour. A plane keeps its
        array's storage type (float32 or bfloat16: the shards' arrays of
        one kind share it), as the reference casts each halo to its
        array's type (``pallas_kstep.py:1408-1411``). Only halo planes are
        written and only core planes read, so the copies commute, and each
        is one contiguous block (x is the slowest axis). Between shards of
        this process the planes are copied (``copy_planes``: one
        ``_foreach_copy_`` when they all lie on one device; a ``copy_`` per
        block cost about 25 us of host time each, 224 blocks per group on
        a 384^3 dispersive run in 4 shards, PERF.md). In a process group
        a process passes its own shards, and the halos it reads from
        another process's shards come through ``transport``."""
        n, pad, nl = self.ndev, self.pad, self.nx_loc
        shards = list(range(n)) if shards is None else list(shards)
        mine = dict(zip(shards, arrays))
        pairs = []
        for s, arrs in mine.items():
            for t, dst, src in (((s - 1) % n, slice(0, pad),
                                 slice(nl, nl + pad)),
                                ((s + 1) % n, slice(pad + nl, None),
                                 slice(pad, 2 * pad))):
                if t in mine:
                    pairs += [(a[dst], b[src])
                              for a, b in zip(arrs, mine[t])]
        copy_planes(pairs)
        if transport is None:
            return
        # the halos a shard reads across a process boundary, in a global
        # order (receiving shard, side, array) that both sides list alike
        me, owner = transport.me, transport.owner
        sends, recvs, into = [], [], []
        for s in range(n):
            for read, t, dst, src in zip(
                    self.halo(s), ((s - 1) % n, (s + 1) % n),
                    (slice(0, pad), slice(pad + nl, None)),
                    (slice(nl, nl + pad), slice(pad, 2 * pad))):
                if not read or owner[s] == owner[t] \
                        or me not in (owner[s], owner[t]):
                    continue
                if owner[t] == me:
                    sends += [(owner[s], a[src]) for a in mine[t]]
                else:
                    into += [a[dst] for a in mine[s]]
                    recvs += [(owner[t], a[dst].shape, a.dtype)
                              for a in mine[s]]
        for dst, got in zip(into, transport.swap(sends, recvs)):
            dst.copy_(got)

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
                 phases=(None, None, None), shards=None,
                 transport=None) -> None:
        """One halo exchange, in place: ``fields[i]`` lists the copies (one,
        or the two of a Bloch run) of brick ``shards[i]`` (default: every
        brick, in order) of the family whose planes are read, ``{comp:
        tensor}`` each; ``halos[i]`` the same copies' halo planes ``{axis:
        {comp: tensor}}`` on ``side`` (0 lo, 1 hi). Each halo takes the
        neighbour's core plane that touches it (the lo halo the
        neighbour's last plane, the hi halo its first). A halo across the
        global wall of an axis with a Bloch phase ``phases[a] = (c, s)``
        mixes the copies as ``_wrap_col`` does
        (``tidy3d_tpu/solver/fdtd.py:861-893``): ``F(-1) = e^{-i phi}
        F(N - 1)``, ``F(N) = e^{i phi} F(0)``, so copy 0 takes ``c F0 +- s
        F1`` and copy 1 ``c F1 -+ s F0`` (upper signs lo); the mix is
        computed in float32 and rounded once to the halo's type. This is
        the only place where a sharded run's copies mix. A plane keeps its
        array's storage type.

        Between bricks of this process the planes are copied
        (``copy_planes``; the y and z planes are strided views of the
        neighbour's arrays). In a process group a process passes its own
        bricks, and the halos it reads from another process's bricks come
        through ``transport``: the neighbour's planes of both copies, mixed
        on the receiving side as here."""
        shards = list(range(self.n)) if shards is None else list(shards)
        at_ = {s: i for i, s in enumerate(shards)}
        pairs, mixes = [], []
        for i, s in enumerate(shards):
            copies = halos[i]
            for a in copies[0]:
                t = self.neighbour(s, a, side)
                if t not in at_:
                    continue
                src = fields[at_[t]]
                at = self.extent(t)[a] - 1 if side == 0 else 0
                wall = self.crosses_wall(s, a, side) \
                    and phases[a] is not None
                for p, copy in enumerate(copies):
                    for comp, h in copy[a].items():
                        core = src[p][comp].narrow(a, at, 1)
                        if not wall:
                            pairs.append((h, core))
                            continue
                        c, sn = phases[a]
                        mixes.append((h, core,
                                      src[1 - p][comp].narrow(a, at, 1), c,
                                      self._mix_sign(p, side) * sn))
        copy_planes(pairs, mixes)
        if transport is not None:
            self._exchange_across(fields, halos, side, phases, at_,
                                  transport)

    @staticmethod
    def _mix_sign(p: int, side: int) -> float:
        return (1.0 if p == 0 else -1.0) * (1.0 if side == 0 else -1.0)

    def _exchange_across(self, fields, halos, side, phases, at_,
                         transport) -> None:
        """The halos of ``exchange`` whose brick and neighbour belong to
        two processes, one of them this one, listed in a global order
        (receiving brick, axis, copy, component in name order) that both
        sides build alike."""
        if not at_:
            return      # this process owns no brick: nothing to move
        me, owner = transport.me, transport.owner
        local = next(iter(at_.values()))
        names = sorted(fields[local][0])
        ncopies = len(fields[local])
        sends, recvs, into = [], [], []
        for s in range(self.n):
            for a in range(3):
                if not self.halo(s)[a][side]:
                    continue
                t = self.neighbour(s, a, side)
                if owner[s] == owner[t] or me not in (owner[s], owner[t]):
                    continue
                at = self.extent(t)[a] - 1 if side == 0 else 0
                comps = [c for c in names if c[1] != "xyz"[a]]
                for p in range(ncopies):
                    for comp in comps:
                        if owner[t] == me:
                            sends.append((owner[s], fields[at_[t]][p][
                                comp].narrow(a, at, 1)))
                        else:
                            h = halos[at_[s]][p][a][comp]
                            recvs.append((owner[t], h.shape, h.dtype))
                            into.append(((s, a, p, comp), h))
        got = dict(zip((key for key, _ in into),
                       transport.swap(sends, recvs)))
        for (s, a, p, comp), h in into:
            plane = got[(s, a, p, comp)]
            if self.crosses_wall(s, a, side) and phases[a] is not None:
                c, sn = phases[a]
                other = got[(s, a, 1 - p, comp)]
                h.copy_(plane.float() * c
                        + other.float() * (self._mix_sign(p, side) * sn))
            else:
                h.copy_(plane)


def copy_planes(pairs: list, mixes=()) -> None:
    """Copies each ``(dst, src)`` plane of ``pairs`` and sets each mix
    ``(dst, core, other, c, s)`` to ``c core + s other`` (float32, rounded
    once to ``dst``'s type), in place. When every plane lies on one device
    the copies go in one ``_foreach_copy_`` on its current stream. Across
    devices each destination's stream first waits for an event recorded on
    each source device's stream after its last launch, then pulls the
    planes with non-blocking peer copies."""
    devices = {t.device for pair in pairs for t in pair} | {
        t.device for m in mixes for t in m[:3]}
    if len(devices) <= 1:
        if pairs:
            torch._foreach_copy_([d for d, _ in pairs],
                                 [v for _, v in pairs])
        for h, core, other, c, sn in mixes:
            h.copy_(core.float() * c + other.float() * sn)
        return
    events = {}
    for dev in devices:
        events[dev] = torch.cuda.Event()
        events[dev].record(torch.cuda.current_stream(dev))
    waited = set()
    for d, *srcs in list(pairs) + [m[:3] for m in mixes]:
        for v in srcs:
            if (d.device, v.device) not in waited:
                torch.cuda.current_stream(d.device).wait_event(
                    events[v.device])
                waited.add((d.device, v.device))
    for d, v in pairs:
        with torch.cuda.device(d.device):
            d.copy_(v, non_blocking=True)
    for h, core, other, c, sn in mixes:
        with torch.cuda.device(h.device):
            h.copy_(core.to(h.device, non_blocking=True).float() * c
                    + other.to(h.device, non_blocking=True).float() * sn)


ALIGN = 16      # bytes: each plane of a transfer buffer starts on a multiple


def _padded(nbytes: int) -> int:
    return -(-nbytes // ALIGN) * ALIGN


class Transport:
    """Halo planes between the mesh entries of two processes, through the
    default process group (NCCL on a card, gloo on the CPU).

    ``owner[s]`` is the process of mesh entry s (``ShardingPlan.ranks``,
    row-major) and ``me`` this process. ``swap`` takes, per exchange, the
    planes this process sends and the ones it receives, each list in one
    global order that both sides of a pair build alike (the layouts list
    halos by receiving shard); per peer it packs the planes to send into
    one contiguous byte buffer on ``device`` (each plane at its own storage
    type, bf16 as bf16, at a 16-byte aligned offset; a strided y or z plane
    is gathered by the pack), runs one ``batch_isend_irecv`` of every
    peer's send and receive, waits, and unpacks views of the receive
    buffers. So a ring of two processes, whose left and right neighbours
    are one peer, still pairs each plane with its own place. On a card the
    buffers stay on the device: the group's stream waits for the launches
    that wrote the planes before it sends, and ``wait`` orders the current
    stream after the receive, before the next launch reads a halo. Nothing
    is staged through the host. ``sent`` counts the bytes sent, ``swaps``
    the calls that moved any."""

    def __init__(self, ranks, device):
        self.owner = [int(r) for r in np.asarray(ranks).reshape(-1)]
        self.me = dist.get_rank()
        self.device = torch.device(device)
        self.sent = 0
        self.swaps = 0

    def swap(self, sends: list, recvs: list) -> list:
        """``sends``: ``(peer, plane)``; ``recvs``: ``(peer, shape,
        dtype)``; returns the received planes in the order of ``recvs``."""
        ops, inbox = [], {}
        for peer in sorted({p for p, _ in sends} | {p for p, *_ in recvs}):
            planes = [t for p, t in sends if p == peer]
            if planes:
                buf = torch.cat([_as_bytes(t, self.device) for t in planes])
                ops.append(dist.P2POp(dist.isend, buf, peer))
                self.sent += buf.numel()
            size = sum(_padded(_nbytes(shape, dtype))
                       for p, shape, dtype in recvs if p == peer)
            if size:
                inbox[peer] = torch.empty(size, dtype=torch.uint8,
                                          device=self.device)
                ops.append(dist.P2POp(dist.irecv, inbox[peer], peer))
        if not ops:
            return []
        self.swaps += 1
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        out, offset = [], dict.fromkeys(inbox, 0)
        for peer, shape, dtype in recvs:
            n = _nbytes(shape, dtype)
            out.append(inbox[peer][offset[peer]:offset[peer] + n].view(
                dtype).view(tuple(shape)))
            offset[peer] += _padded(n)
        return out


def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()


def _as_bytes(t: torch.Tensor, device) -> torch.Tensor:
    """``t``'s values as one contiguous byte run on ``device``, zero-padded
    to the transfer's alignment."""
    flat = t.to(device).contiguous().view(-1).view(torch.uint8)
    pad = _padded(flat.numel()) - flat.numel()
    if not pad:
        return flat
    return torch.cat([flat, flat.new_zeros(pad)])
