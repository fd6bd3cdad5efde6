"""The half-step family update: the counterpart of ``pallas_step.py``.

``family_update(family, state, consts, src_fields, meta)`` computes one
half-step family, E from H or H from E^{n+1}, for all three components:
the curl with the boundary column of each axis, the CPML psi recursions of
all three axes, ``ca * old +- cb * rhs`` and the PEC lo-wall masks. It
returns ``(new_fields, new_psi)`` with the semantics of
``tidy3d_tpu.solver.fdtd.FDTDRunner._update_field_family`` (the XLA path,
with the ``-Re(Gc Q)`` term of every dispersive pole slot in the E update)
and ``PallasStepper.family_update``. ``family_update_copies`` updates the
family of every copy of a run: the two real copies of a Bloch (complex) run
in one launch of the kernel's two-copy instantiation, each copy with its own
pole currents (``Q1`` for copy 1), the other copy entering where a stencil
wraps across a Bloch wall.

A brick of a sharded ``pallas2`` run (``sharding.Bricks``) is updated in
its brick-local halo mode: ``meta.halo`` says which sides of each axis read
a halo plane, and ``halos`` passes those planes of the source components
(``{axis: {comp: (.., 1, ..) tensor}}``), which the stencil reads where it
crosses such a side (the kernel's ``WALL_HALO``); the other sides keep the
global wall, an axis that is not decomposed its wall or wrap.
``family_update_bricks`` updates the family of every brick of a run: on a
card, one call of the kernel per device (every brick and copy on it, two
launches) from a device table of ``BrickEntry`` that this module plans
(``plan_bricks``: each entry's tile grid, bulk box and first blocks; the
library checks the plan), kept by content (``BRICK_TABLE_BUILDS``). A
brick's halo sides are no walls there: its bulk tiles reach them and read
the halo planes (``bulk_box``). ``family_update_copies`` of one brick is
that call with one brick.

Pole slots: up to ``MAX_POLES`` ride in the kernel's parameter block; a
call with more of them, and every Bloch call, passes them in a device
table of ``PoleSlot`` (``pole_table``, built once per distinct content and
kept).

Storage: the fields, the psi slabs and the pole currents are float32 or
bfloat16 tensors (``STORAGE``), as the run stores them. Both versions load
them widened to float32, compute in float32 and round the new fields and
psi once, where they are stored, as ``PallasStepper.family_update`` does
(``pallas_step.py:65,363,400-411``); the kernel is built once per
combination of storage types (``storage_defines``).

Dispatch is by device: a CPU tensor goes to ``family_update_reference``,
the XLA body's arithmetic in whole-array operations; a CUDA tensor
launches the hand-written kernel in ``csrc/step.cu`` or raises.
``LAUNCHES`` counts the kernel calls, ``BLOCH_LAUNCHES`` those of the
two-copy instantiation, ``MANY_POLES_LAUNCHES`` those that read more than
``MAX_POLES`` slots from a table, ``BRICK_CALLS`` the calls over bricks
and ``BRICK_LAUNCHES`` the bricks (each with its copies) updated in halo
mode.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..lowering import E_COMPS, H_COMPS

LAUNCHES = 0
DEVICE_LAUNCHES = 0  # the bulk and the shell launch of each call
BLOCH_LAUNCHES = 0   # calls of the two-copy (Bloch) instantiation
MANY_POLES_LAUNCHES = 0  # calls with more than MAX_POLES pole slots
BRICK_LAUNCHES = 0  # bricks updated in the halo mode (a sharded run)
BRICK_CALLS = 0     # calls over the bricks of a device (t3d_family_update_bricks)
BRICK_TABLE_BUILDS = 0  # brick tables sent to a device
# the last call's blocks (bulk and shell launches) and device launches
LAST_BLOCKS = (0, 0, 0)
MAX_POLES = 8       # pole slots in the parameter block (csrc/*.cu MAX_POLES)
STORAGE = (torch.float32, torch.bfloat16)   # the storage types of the state

_WALL = {"pec": 0, "pmc": 1, "periodic": 2}
WALL_HALO = 3   # csrc/step.cu: the neighbour is the brick's halo plane
TILE = (16, 16, 32)   # csrc/step.cu BX, TY, TZ: a tile's cells per axis


@dataclass(frozen=True)
class StepMeta:
    """Static layout of a run: interior shape, per-axis ``(lo, hi)``
    boundary kinds (``"pec"``, ``"pmc"`` or ``"periodic"``), the psi slab
    widths ``pml_meta[(family, axis)] = (w_lo, w_hi)`` and, per periodic
    axis that carries a Bloch phase ``e^{i phi} = c + i s``, ``bloch[axis]
    = (c, s)`` (None elsewhere: a complex run steps two real copies, re and
    im, that mix only where a stencil wraps across such an axis).

    A shard of a sharded k-step run (``kernels.kstep``) steps ``shape[0]``
    owned x planes of arrays padded by ``xpad`` halo planes on each x side
    (``array_shape``); ``x_halo`` says which x sides read their halo (a
    neighbour shard) instead of meeting the global x wall, and ``pml_meta``
    holds the shard's own x psi slabs (the edge shards' only).

    A brick of a sharded one-step run (``sharding.Bricks``) steps the
    ``shape`` cells it owns, in arrays of that shape (no padding: its halo
    planes are tensors of their own). ``halo[axis]`` says which (lo, hi)
    sides read a halo plane; ``pml_meta`` holds the parts of the global psi
    slabs inside the brick, and ``bloch`` is None on a decomposed axis,
    whose halos carry the phase."""

    shape: Tuple[int, int, int]
    boundaries: Tuple[Tuple[str, str], ...]
    pml_meta: Dict[Tuple[str, int], Tuple[int, int]]
    bloch: Tuple[Optional[Tuple[float, float]], ...] = (None, None, None)
    xpad: int = 0
    x_halo: Tuple[bool, bool] = (False, False)
    halo: Tuple[Tuple[bool, bool], ...] = ((False, False),) * 3

    def halo_side(self, family: str, axis: int) -> bool:
        """Whether the ``family`` update reads a halo plane across its
        side of ``axis``: lo for E (backward differences), hi for H."""
        return self.halo[axis][0 if family == "E" else 1]

    @property
    def array_shape(self) -> Tuple[int, int, int]:
        """The shape of the x-spanning arrays: ``shape`` with the halo
        planes."""
        return (self.shape[0] + 2 * self.xpad,) + tuple(self.shape[1:])


# --------------------------------------------------------------------------- #
# the plain PyTorch version (the XLA body's arithmetic on whole arrays)
# --------------------------------------------------------------------------- #


def _is_trivial(sl) -> bool:
    return all(s == slice(None) for s in sl)


def _take(arr, sl):
    return arr if _is_trivial(sl) else arr[sl]


def _wrap_col(F, axis: int, side: str, boundaries, Fp=None, cs=None,
              part: int = 0):
    """Boundary column entering the stencil across the domain edge: the
    F(-1) column at ``lo`` (backward difference), the F(N) column at ``hi``
    (forward difference). PEC gives zero, PMC a mirror, periodic a wrap.

    On a Bloch axis (``cs = (c, s)`` of the phase ``e^{i phi}``) the wrapped
    column mixes copy ``part`` (``F``) with the other copy (``Fp``):
    ``F(-1) = e^{-i phi} F(N-1)``, ``F(N) = e^{+i phi} F(0)`` (the port of
    ``FDTDRunner._wrap_col``, ``tidy3d_tpu/solver/fdtd.py:861-893``)."""
    n = F.shape[axis]
    if side == "lo":
        kind = boundaries[axis][0]
        col = F.narrow(axis, n - 1, 1)
        if kind == "pec":
            return torch.zeros_like(col)
        if kind == "pmc":
            return F.narrow(axis, 0, 1)
        if Fp is not None and cs is not None:
            c, s = cs
            return c * col + (s if part == 0 else -s) * Fp.narrow(
                axis, n - 1, 1)
        return col
    kind = boundaries[axis][1]
    col = F.narrow(axis, 0, 1)
    if kind == "pec":
        return torch.zeros_like(col)
    if kind == "pmc":
        return F.narrow(axis, n - 1, 1)
    if Fp is not None and cs is not None:
        c, s = cs
        return c * col + (-s if part == 0 else s) * Fp.narrow(axis, 0, 1)
    return col


def _shift_take(F, sl, axis: int, dn: bool, boundaries, Fp=None, cs=None,
                part: int = 0, col=None):
    """The shifted operand F_{i-1} (dn) or F_{i+1} (up) restricted to the
    region slice ``sl`` (``Fp``, ``cs``, ``part``: the Bloch wrap of
    ``_wrap_col``; ``col``: a brick's halo plane, read across the edge in
    place of the wall column)."""
    n = F.shape[axis]
    s = sl[axis]
    start = 0 if s == slice(None) else (s.start or 0)
    stop = n if s == slice(None) or s.stop is None else s.stop
    oth = list(sl)
    oth[axis] = slice(None)
    if dn:
        if start > 0:
            sl2 = list(sl)
            sl2[axis] = slice(start - 1, stop - 1)
            return _take(F, tuple(sl2))
        col = _take(_wrap_col(F, axis, "lo", boundaries, Fp, cs, part)
                    if col is None else col, tuple(oth))
        if stop <= 1:
            return col
        rest = list(sl)
        rest[axis] = slice(0, stop - 1)
        return torch.cat([col, _take(F, tuple(rest))], dim=axis)
    if stop < n:
        sl2 = list(sl)
        sl2[axis] = slice(start + 1, stop + 1)
        return _take(F, tuple(sl2))
    col = _take(_wrap_col(F, axis, "hi", boundaries, Fp, cs, part)
                if col is None else col, tuple(oth))
    if start >= n - 1:
        return col
    rest = list(sl)
    rest[axis] = slice(start + 1, n)
    return torch.cat([_take(F, tuple(rest)), col], dim=axis)


def _slab_slices(shape, axis: int, side: str, width: int):
    sl = [slice(None)] * 3
    n = shape[axis]
    sl[axis] = slice(0, width) if side == "lo" else slice(n - width, n)
    return tuple(sl)


def f32(t):
    """A stored tensor widened to float32 (exact for bfloat16)."""
    return t if t.dtype == torch.float32 else t.float()


def storage_defines(field, psi, q) -> tuple:
    """The defines of the kernels' library for the storage types of the
    fields, the psi slabs and the pole currents (none for float32)."""
    for dt in (field, psi, q):
        if dt not in STORAGE:
            raise ValueError(f"storage type {dt}: the kernels store "
                             f"{', '.join(map(str, STORAGE))}")
    return tuple(name for name, dt in (("T3D_FIELD_BF16", field),
                                       ("T3D_PSI_BF16", psi),
                                       ("T3D_Q_BF16", q))
                 if dt == torch.bfloat16)


def storage_of(state: dict, copies=(("E", "H", "psi"),)) -> tuple:
    """``(field, psi, q)``: the storage types of a state's fields, psi
    slabs and pole currents; each kind must be of one type (a kind the
    state has none of takes the fields' type)."""
    kinds = {"field": [], "psi": [], "q": []}
    for e, h, p in copies:
        kinds["field"] += list(state[e].values()) + list(state[h].values())
        kinds["psi"] += list(state[p].values())
    for Qp in state.get("Q", []):
        for qr, qi in Qp.values():
            kinds["q"] += [qr, qi]
    out = []
    for kind, ts in kinds.items():
        dts = {t.dtype for t in ts}
        if len(dts) > 1:
            raise ValueError(f"{kind} tensors of several types: {dts}")
        out.append(dts.pop() if dts else out[0])
    return tuple(out)


def pole_terms(state: dict, consts: dict):
    """``[(Re Gc, Im Gc, Q_p)]`` per pole: the E update subtracts
    ``Re(Gc) qr - Im(Gc) qi`` of each pole (``fdtd.py:1089-1093``)."""
    scalars = consts["pole_scalars"]
    if not scalars:
        return []
    Q = state["Q"]
    if len(Q) != len(scalars):
        raise ValueError(f"state holds {len(Q)} pole currents, the plan "
                         f"{len(scalars)} poles")
    return [(Gc.real, Gc.imag, Qp) for (_, Gc), Qp in zip(scalars, Q)]


def family_update_reference(family: str, state: dict, consts: dict,
                            src_fields: dict, meta: StepMeta,
                            partner: dict = None, part: int = 0,
                            store: bool = True, halo: dict = None):
    """Plain PyTorch family update on any device, in whole-array
    operations: each derivative over the whole grid, each psi slab updated
    from its slice of the derivative, an axis's psi terms added as one
    array with zeros between its slabs (adding zero leaves a value as it
    is), and the E update subtracts the pole currents' term. It builds new
    tensors and leaves ``state`` as it is, so autograd goes through it (the
    differentiable run steps on it). In a complex run ``state`` and
    ``src_fields`` are copy ``part`` and ``partner`` holds the other copy's
    ``src_fields``, which enters where a stencil wraps across a Bloch
    axis. A brick (``meta.halo``) reads ``halo[axis][comp]``, the halo plane
    of a source component, where the stencil crosses a side that has one.

    Every input is widened to float32 and the update computed in float32;
    the new fields and psi are rounded to the types of ``state``'s fields
    and psi (its stores), or left in float32 with ``store=False`` (for a
    caller that goes on computing with them)."""
    is_e = family == "E"
    out_comps = E_COMPS if is_e else H_COMPS
    other = H_COMPS if is_e else E_COMPS
    coeffs = consts["coeffs_E"] if is_e else consts["coeffs_H"]
    inv = consts["inv_dual"] if is_e else consts["inv_primal"]
    fam = "dual" if is_e else "primal"
    sign_shift = 1.0 if is_e else -1.0  # backward vs forward difference
    shape, boundaries = meta.shape, meta.boundaries
    whole = (slice(None),) * 3
    poles = [(gr, gi, {c: (f32(qr), f32(qi)) for c, (qr, qi) in Qp.items()})
             for gr, gi, Qp in pole_terms(state, consts)] if is_e else []

    new_fields, new_psi = {}, {}
    for i, comp in enumerate(out_comps):
        j, k = (i + 1) % 3, (i + 2) % 3
        d, slab_terms = {}, {}
        for axis, name in ((j, other[k]), (k, other[j])):
            F = f32(src_fields[name])
            Fp = f32(partner[name]) if partner is not None else None
            col = f32(halo[axis][name]) if meta.halo_side(family, axis) \
                else None
            shifted = _shift_take(F, whole, axis, is_e, boundaries, Fp,
                                  meta.bloch[axis], part, col)
            d[axis] = sign_shift * (F - shifted) * inv[axis]
            pml = consts["pml"].get(f"{fam}{axis}")
            slabs = {}
            for side, width in zip(("lo", "hi"), meta.pml_meta[(fam, axis)]):
                key = f"{comp}|{axis}|{side}"
                if width and key in state["psi"]:
                    sl = _slab_slices(shape, axis, side, width)
                    new_psi[key] = pml[f"b_{side}"] * f32(state["psi"][key]) \
                        + pml[f"c_{side}"] * d[axis][sl]
                    slabs[side] = new_psi[key]
            if slabs:
                slab_terms[axis] = _slab_array(slabs, shape, axis)
        rhs = d[j] - d[k]
        if j in slab_terms:
            rhs = rhs + slab_terms[j]
        if k in slab_terms:
            rhs = rhs - slab_terms[k]
        for gc_re, gc_im, Qp in poles:
            qr, qi = Qp[comp]
            rhs = rhs - (gc_re * qr - gc_im * qi)
        ca, cb = coeffs[comp]
        old = f32(state[family][comp])
        if is_e:
            new = ca * old + cb * rhs
            for mask in consts["wall_masks"].get(comp, ()):
                new = new * mask
        else:
            new = ca * old - cb * rhs
        new_fields[comp] = new
    if store:
        new_fields = {c: v.to(state[family][c].dtype)
                      for c, v in new_fields.items()}
        new_psi = {key: v.to(state["psi"][key].dtype)
                   for key, v in new_psi.items()}
    return new_fields, new_psi


def _slab_array(slabs: dict, shape, axis: int) -> torch.Tensor:
    """The psi slabs of one axis (``{"lo": t, "hi": t}``, either or both)
    placed along ``axis`` in an array of ``shape``, zero between them."""
    some = next(iter(slabs.values()))
    w_lo = slabs["lo"].shape[axis] if "lo" in slabs else 0
    w_hi = slabs["hi"].shape[axis] if "hi" in slabs else 0
    mid = list(some.shape)
    mid[axis] = shape[axis] - w_lo - w_hi
    if mid[axis] < 0:
        raise ValueError(f"psi slabs of {w_lo} and {w_hi} cells overlap on "
                         f"an axis of {shape[axis]}")
    parts = [slabs.get("lo"), some.new_zeros(mid), slabs.get("hi")]
    return torch.cat([p for p in parts if p is not None], dim=axis)


# --------------------------------------------------------------------------- #
# the CUDA kernel (csrc/step.cu) through ctypes
# --------------------------------------------------------------------------- #

_P3 = ctypes.c_void_p * 3


class FamilyParams(ctypes.Structure):
    """Mirror of ``struct FamilyParams`` in ``csrc/step.cu``."""

    _fields_ = [
        ("src", _P3), ("old", _P3), ("out", _P3),
        ("ca", _P3), ("cb", _P3), ("inv", _P3),
        ("psi_in", ctypes.c_void_p * 12), ("psi_out", ctypes.c_void_p * 12),
        ("pml_b", ctypes.c_void_p * 6), ("pml_c", ctypes.c_void_p * 6),
        ("ca_s", ctypes.c_float * 3), ("cb_s", ctypes.c_float * 3),
        ("n", ctypes.c_int32 * 3),
        ("w", ctypes.c_int32 * 6),
        ("bkind", ctypes.c_int32 * 3),
        ("pec_lo", ctypes.c_int32 * 3),
        ("bulk_lo", ctypes.c_int32 * 3),
        ("bulk_hi", ctypes.c_int32 * 3),
        ("is_e", ctypes.c_int32),
        ("num_poles", ctypes.c_int32),
        ("vec", ctypes.c_int32),
        ("gc_re", ctypes.c_float * MAX_POLES),
        ("gc_im", ctypes.c_float * MAX_POLES),
        ("q", ctypes.c_void_p * (6 * MAX_POLES)),
        ("poles", ctypes.c_void_p),
        ("halo", ctypes.c_void_p * 9),
    ]


class PoleSlot(ctypes.Structure):
    """Mirror of ``struct PoleSlot`` in ``csrc/step.cu``: one slot of a
    device pole table."""

    _fields_ = [("q", ctypes.c_void_p * 6), ("gc_re", ctypes.c_float),
                ("gc_im", ctypes.c_float)]


class BlochPhase(ctypes.Structure):
    """Mirror of ``struct BlochPhase`` in ``csrc/step.cu``."""

    _fields_ = [("bc", ctypes.c_float * 3), ("bs", ctypes.c_float * 3),
                ("bloch", ctypes.c_int32 * 3)]


class BlochParams(ctypes.Structure):
    """Mirror of ``struct BlochParams`` in ``csrc/step.cu``."""

    _fields_ = [("c", FamilyParams * 2), ("ph", BlochPhase),
                ("nchunk", ctypes.c_int32)]


class BrickEntry(ctypes.Structure):
    """Mirror of ``struct BrickEntry`` in ``csrc/step.cu``: one brick (and
    copy) of a call over bricks."""

    _fields_ = [("p", FamilyParams), ("tiles", ctypes.c_int32 * 3),
                ("first", ctypes.c_int32 * 2), ("pad", ctypes.c_int32)]


class BrickCall(ctypes.Structure):
    """Mirror of ``struct BrickCall`` in ``csrc/step.cu``."""

    _fields_ = [("entries", ctypes.c_void_p), ("num", ctypes.c_int32),
                ("copies", ctypes.c_int32), ("blocks", ctypes.c_int32 * 2),
                ("ph", BlochPhase)]


# device copies of the pole tables, keyed by (device, content): a table
# depends only on the current tensors' addresses and the slots' constants,
# which stay put across a run's steps (a kernel still reading an evicted
# table is safe: the caching allocator reuses its memory in stream order)
_TABLES: Dict[tuple, torch.Tensor] = {}
_MAX_TABLES = 32


def pole_table(slots, device) -> torch.Tensor:
    """The device copy of a ``ctypes`` array of pole slots."""
    key = (str(device), bytes(slots))
    table = _TABLES.get(key)
    if table is None:
        if len(_TABLES) >= _MAX_TABLES:
            _TABLES.pop(next(iter(_TABLES)))
        table = torch.frombuffer(bytearray(key[1]), dtype=torch.uint8).to(
            device)
        _TABLES[key] = table
    return table


def check_pair_aligned(t: torch.Tensor, name: str) -> torch.Tensor:
    """A current read through a table: its pairs must be aligned, as the
    kernels' pair loads need (the library checks the rest)."""
    if t.data_ptr() % (2 * t.element_size()):
        raise ValueError(f"{name}: not aligned to a pair of values")
    return t


def check_storage(lib, fn_name: str, storage) -> None:
    """Raises unless the library's ``fn_name`` reports the element sizes
    of ``storage`` (field, psi, q), the types it was built for."""
    sizes = (ctypes.c_int32 * 3)()
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = None
    fn(sizes)
    want = tuple(torch.empty((), dtype=dt).element_size() for dt in storage)
    if tuple(sizes) != want:
        raise RuntimeError(f"{fn_name}: the library stores {tuple(sizes)} "
                           f"bytes a value, the storage types {want}")


def _library(storage=(torch.float32,) * 3):
    from ... import _build

    lib = _build.load("step", storage_defines(*storage))
    fn = lib.t3d_family_update
    if fn.argtypes is None:
        _build.check_struct(lib, "t3d_family_params_size", FamilyParams)
        _build.check_struct(lib, "t3d_family_bloch_params_size",
                            BlochParams)
        _build.check_struct(lib, "t3d_family_pole_slot_size", PoleSlot)
        _build.check_struct(lib, "t3d_family_brick_entry_size", BrickEntry)
        _build.check_struct(lib, "t3d_family_brick_call_size", BrickCall)
        check_storage(lib, "t3d_family_storage", storage)
        fn.argtypes = [ctypes.POINTER(FamilyParams), ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bloch = lib.t3d_family_update_bloch
        bloch.argtypes = [ctypes.POINTER(BlochParams), ctypes.c_void_p,
                          ctypes.c_void_p]
        bloch.restype = ctypes.c_int
        bricks = lib.t3d_family_update_bricks
        bricks.argtypes = [ctypes.POINTER(BrickCall),
                           ctypes.POINTER(BrickEntry), ctypes.c_void_p,
                           ctypes.c_void_p]
        bricks.restype = ctypes.c_int
    return fn


def _entry_point(storage, name: str):
    from ... import _build

    _library(storage)
    return getattr(_build.load("step", storage_defines(*storage)), name)


# t3d_family_info's mode: the unsharded calls, then the calls over bricks
MODES = {"real": 0, "many": 1, "bloch": 2, "bricks": 3, "bricks_many": 4,
         "bricks_bloch": 5}


def resources(family: str, bulk: bool, storage=(torch.float32,) * 3,
              mode: str = "real") -> dict:
    """Threads, shared bytes, blocks per SM and registers of the E or H,
    bulk or shell (pair-aligned arrays) instantiation of the kernel in the
    library of the storage types ``(field, psi, q)`` (the CUDA occupancy
    calculator), of a real run (``mode`` ``real``), a real run with the
    pole table (``many``) or a Bloch run (``bloch``), or of a call over
    bricks of each (``bricks``, ``bricks_many``, ``bricks_bloch``); needs
    the card."""
    from ... import _build

    _library(storage)
    fn = _build.load("step", storage_defines(*storage)).t3d_family_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int32 * 4)()
    err = fn(int(family == "E"), int(bulk), MODES[mode], out)
    if err:
        raise RuntimeError(f"family resources: CUDA error {err}")
    return dict(zip(("threads", "shared_bytes", "blocks_per_sm",
                     "registers"), out))


def occupancy(family: str, storage=(torch.float32,) * 3,
              bulk: bool = True) -> int:
    """Blocks per SM of one instantiation (``resources``)."""
    return resources(family, bulk, storage)["blocks_per_sm"]


def prepare(device, storage=(torch.float32,) * 3) -> None:
    """Build and load the kernel library of the storage types ``(field,
    psi, q)`` for ``device`` (a no-op on the CPU); the runner times this as
    its compile step."""
    if torch.device(device).type == "cuda":
        _library(storage)


def _check_field(t, shape, name, dtype=torch.float32):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t


def _vec(t, n, name):
    """A (1, n, 1)-style coefficient vector as a contiguous 1D tensor."""
    v = t.reshape(-1)
    if v.numel() != n or not v.is_contiguous() or v.dtype != torch.float32 \
            or v.device.type != "cuda":
        raise ValueError(f"{name}: expected {n} contiguous float32 CUDA "
                         "values")
    return v


def set_family_poles(p, state, consts, shape, dtype, device,
                     table: bool) -> list:
    """The pole slots of the family kernel's parameter struct: in the
    block (``set_pole_params``), or with ``table`` in a device table of
    ``PoleSlot`` (``p.poles``), which is returned to be kept alive."""
    if not table:
        set_pole_params(p, state, consts, shape, dtype)
        return []
    poles = pole_terms(state, consts)
    slots = (PoleSlot * max(len(poles), 1))()
    for pi, (gc_re, gc_im, Qp) in enumerate(poles):
        slots[pi].gc_re = gc_re
        slots[pi].gc_im = gc_im
        for ci, comp in enumerate(E_COMPS):
            for part in range(2):
                slots[pi].q[2 * ci + part] = check_pair_aligned(_check_field(
                    Qp[comp][part], shape, f"Q{pi}_{comp}", dtype),
                    f"Q{pi}_{comp}").data_ptr()
    p.num_poles = len(poles)
    tab = pole_table(slots, device)
    p.poles = tab.data_ptr()
    return [tab]


def set_pole_params(p, state, consts, shape, dtype=torch.float32) -> None:
    """Fills ``num_poles``, ``gc_re``/``gc_im`` and the pole-current
    pointers ``q[(pole * 3 + comp) * 2 + (0 re, 1 im)]`` of a kernel's
    parameter struct; the currents are of type ``dtype``."""
    poles = pole_terms(state, consts)
    if len(poles) > MAX_POLES:
        raise ValueError(f"{len(poles)} poles: the kernels take at most "
                         f"{MAX_POLES}")
    p.num_poles = len(poles)
    for pi, (gc_re, gc_im, Qp) in enumerate(poles):
        p.gc_re[pi] = gc_re
        p.gc_im[pi] = gc_im
        for ci, comp in enumerate(E_COMPS):
            for part in range(2):
                p.q[(pi * 3 + ci) * 2 + part] = _check_field(
                    Qp[comp][part], shape, f"Q{pi}_{comp}", dtype).data_ptr()


POLE_KIND = {"zero": 0, "mask": 1, "dense": 2}   # csrc/*.cu POLE_*


def set_pole_update_params(p, state, q_out, consts, shape,
                           dtype=torch.float32) -> None:
    """``set_pole_params`` and what a kernel that updates the poles reads
    besides: the output Q pointers (``q_out``, currents of type ``dtype``),
    ``a_re``/``a_im``, and per (pole, component) ``pole_kind``, the residue
    maps ``pole_b`` (the support mask, or the dense re/im maps) and the mask
    kind's ``pole_b0``."""
    set_pole_params(p, state, consts, shape, dtype)
    if len(q_out) != p.num_poles:
        raise ValueError(f"out holds {len(q_out)} pole currents, the "
                         f"plan {p.num_poles} poles")
    for pi, ((A, _), metas) in enumerate(zip(consts["pole_scalars"],
                                             consts["pole_B_meta"])):
        p.a_re[pi] = A.real
        p.a_im[pi] = A.imag
        for ci, comp in enumerate(E_COMPS):
            qx = (pi * 3 + ci) * 2
            for part in range(2):
                p.q_out[qx + part] = _check_field(
                    q_out[pi][comp][part], shape,
                    f"out Q{pi}_{comp}", dtype).data_ptr()
            m = metas[ci]
            p.pole_kind[pi * 3 + ci] = POLE_KIND[m["kind"]]
            if m["kind"] == "mask":
                p.pole_b[qx] = _check_field(
                    consts["pole_masks"][m["mask_id"]], shape,
                    f"pole mask {m['mask_id']}").data_ptr()
                p.pole_b0[qx], p.pole_b0[qx + 1] = m["B0"]
            elif m["kind"] == "dense":
                b_re, b_im = consts["pole_B_dense"][f"{pi}_{ci}"]
                p.pole_b[qx] = _check_field(b_re, shape, "B re").data_ptr()
                p.pole_b[qx + 1] = _check_field(b_im, shape,
                                                "B im").data_ptr()


# the per-family arrays of a kernel's parameter struct (the fused kernel's
# carry an _e or _h suffix)
FAMILY_FIELDS = ("ca", "cb", "ca_s", "cb_s", "inv", "w", "pml_b", "pml_c",
                 "psi_in", "psi_out")


def set_family_params(family: str, state: dict, consts: dict,
                      meta: StepMeta, arrays: dict,
                      psi_out: dict = None, psi_dtype=torch.float32) -> dict:
    """Fills the per-family fields of a kernel's parameter struct: the
    ca/cb pointers or scalars, the inverse steps, the psi slab widths,
    their CPML b/c vectors and the psi pointers (psi slabs of type
    ``psi_dtype``). ``arrays`` maps each name of ``FAMILY_FIELDS`` to the
    struct's array for this family. Returns the new psi buffers, keyed as
    the state's: those of ``psi_out`` where given, new ones otherwise."""
    is_e = family == "E"
    comps = E_COMPS if is_e else H_COMPS
    coeffs = consts["coeffs_E"] if is_e else consts["coeffs_H"]
    inv = consts["inv_dual"] if is_e else consts["inv_primal"]
    fam = "dual" if is_e else "primal"
    shape = meta.array_shape

    for i, comp in enumerate(comps):
        for name, val in zip(("ca", "cb"), coeffs[comp]):
            if isinstance(val, torch.Tensor):
                arrays[name][i] = _check_field(
                    val, shape, f"{name}_{comp}").data_ptr()
                arrays[f"{name}_s"][i] = 0.0
            else:
                arrays[name][i] = None
                arrays[f"{name}_s"][i] = float(val)
    widths = arrays["w"]
    for a in range(3):
        arrays["inv"][a] = _vec(inv[a], shape[a], f"inv[{a}]").data_ptr()
        w_lo, w_hi = meta.pml_meta[(fam, a)]
        if w_lo + w_hi > meta.shape[a]:
            raise ValueError(f"overlapping psi slabs on axis {a}")
        pml = consts["pml"].get(f"{fam}{a}")
        for s, (side, width) in enumerate((("lo", w_lo), ("hi", w_hi))):
            widths[2 * a + s] = width
            if width:
                for key in ("b", "c"):
                    arrays[f"pml_{key}"][2 * a + s] = _vec(
                        pml[f"{key}_{side}"], width,
                        f"{key}_{side}{a}").data_ptr()

    new_psi = {}
    for i, comp in enumerate(comps):
        j, k = (i + 1) % 3, (i + 2) % 3
        for slot, a in enumerate((j, k)):
            for s, side in enumerate(("lo", "hi")):
                width = widths[2 * a + s]
                if not width:
                    continue
                key = f"{comp}|{a}|{side}"
                if key not in state["psi"]:
                    raise ValueError(f"missing psi slab '{key}'")
                psi_shape = list(shape)
                psi_shape[a] = width
                psi = _check_field(state["psi"][key], psi_shape, key,
                                   psi_dtype)
                out = torch.empty_like(psi) if psi_out is None \
                    else _check_field(psi_out[key], psi_shape, key,
                                      psi_dtype)
                idx = (2 * i + slot) * 2 + s
                arrays["psi_in"][idx] = psi.data_ptr()
                arrays["psi_out"][idx] = out.data_ptr()
                new_psi[key] = out
    return new_psi


def launch(fn, params, device, what: str) -> None:
    """Calls a kernel library's C entry point on the current stream of
    ``device``; raises if the launch reports a CUDA error."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(ctypes.byref(params), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def launch_counted(fn, params, device, what: str) -> tuple:
    """``launch`` of an entry point that also reports its launches
    (parameters, stream, counts): returns ``(bulk blocks, shell blocks,
    device launches)``."""
    stream = torch.cuda.current_stream(device).cuda_stream
    counts = (ctypes.c_int32 * 3)()
    with torch.cuda.device(device):
        err = fn(ctypes.byref(params), ctypes.c_void_p(stream), counts)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    return tuple(counts)


def _family_params(family, state, consts, src_fields, meta, storage,
                   device, table: bool, halo: dict = None, out=None):
    """The parameter struct of one copy's family call: ``(p, new_fields,
    new_psi, keep)``, ``keep`` the device tables it points to. A brick's
    sides with a halo take ``WALL_HALO`` and the planes of ``halo``. The
    new fields and psi go to ``out`` (``(fields, psi)`` of the caller's
    buffers, keyed as the state's) where given, else to new tensors."""
    is_e = family == "E"
    out_comps = E_COMPS if is_e else H_COMPS
    src_comps = H_COMPS if is_e else E_COMPS
    shape = tuple(meta.shape)
    p = FamilyParams()
    for a in range(3):
        p.n[a] = shape[a]
        kind = meta.boundaries[a][0 if is_e else 1]
        if kind not in _WALL:
            raise ValueError(f"unsupported boundary kind '{kind}'")
        p.bkind[a] = _WALL[kind]
        p.pec_lo[a] = int(is_e and meta.boundaries[a][0] == "pec"
                          and not meta.halo[a][0])
        if meta.halo_side(family, a):
            p.bkind[a] = WALL_HALO
            plane = list(shape)
            plane[a] = 1
            for m, sc in enumerate(src_comps):
                if m != a:
                    p.halo[3 * a + m] = _check_field(
                        halo[a][sc], plane, f"halo {sc} axis {a}",
                        storage[0]).data_ptr()
    p.is_e = int(is_e)

    new_fields = {}
    for i, (sc, oc) in enumerate(zip(src_comps, out_comps)):
        p.src[i] = _check_field(src_fields[sc], shape, sc,
                                storage[0]).data_ptr()
        p.old[i] = _check_field(state[family][oc], shape, oc,
                                storage[0]).data_ptr()
        new_fields[oc] = torch.empty(shape, dtype=storage[0],
                                     device=device) if out is None else \
            _check_field(out[0][oc], shape, f"out {oc}", storage[0])
        p.out[i] = new_fields[oc].data_ptr()
    new_psi = set_family_params(family, state, consts, meta, {
        name: getattr(p, name) for name in FAMILY_FIELDS},
        None if out is None else out[1], psi_dtype=storage[1])
    keep = set_family_poles(p, state, consts, shape, storage[2], device,
                            table) if is_e else []
    return p, new_fields, new_psi, keep


def _count(blocks, bloch: bool, many: bool, bricks: int = 0) -> None:
    global LAUNCHES, DEVICE_LAUNCHES, LAST_BLOCKS, BLOCH_LAUNCHES, \
        MANY_POLES_LAUNCHES, BRICK_LAUNCHES
    LAUNCHES += 1
    BLOCH_LAUNCHES += bloch
    MANY_POLES_LAUNCHES += many
    BRICK_LAUNCHES += bricks
    DEVICE_LAUNCHES += blocks[2]
    LAST_BLOCKS = blocks


def set_phase(ph, bloch) -> None:
    """The ``BlochPhase`` of a layout's per-axis phases (``meta.bloch``)."""
    for a, cs in enumerate(bloch):
        ph.bloch[a] = int(cs is not None)
        ph.bc[a], ph.bs[a] = cs if cs is not None else (1.0, 0.0)


def _storage_and_device(family, states, srcs):
    """The storage types of the copies' arrays (one for all) and their
    device."""
    is_e = family == "E"
    storage = {storage_of({"E": st[family], "H": src, "psi": st["psi"],
                           "Q": st["Q"] if is_e else []})
               for st, src in zip(states, srcs)}
    if len(storage) > 1:
        raise ValueError(f"copies of several storage types: {storage}")
    return storage.pop(), next(iter(srcs[0].values())).device


def _check_cells(meta):
    shape = tuple(meta.shape)
    if shape[0] * shape[1] * shape[2] >= 2 ** 31:
        raise ValueError(f"grid {shape}: the family kernel takes fewer "
                         "than 2^31 cells")


def _many(state, consts, family) -> bool:
    return family == "E" and len(pole_terms(state, consts)) > MAX_POLES


def _family_update_cuda(family, state, consts, src_fields, meta):
    _check_cells(meta)
    storage, device = _storage_and_device(family, [state], [src_fields])
    many = _many(state, consts, family)
    p, new_fields, new_psi, keep = _family_params(
        family, state, consts, src_fields, meta, storage, device, many)
    blocks = launch_counted(_library(storage), p, device, "family_update")
    del keep
    _count(blocks, False, many)
    return new_fields, new_psi


def _family_update_bloch_cuda(family, states, consts, srcs, meta):
    """Both copies of a Bloch run in one call of the two-copy
    instantiation (each copy's pole slots from its table)."""
    _check_cells(meta)
    storage, device = _storage_and_device(family, states, srcs)
    b = BlochParams()
    outs, keep = [], []
    for part in range(2):
        p, nf, npsi, kp = _family_params(family, states[part], consts,
                                         srcs[part], meta, storage, device,
                                         True)
        b.c[part] = p
        outs.append((nf, npsi))
        keep += kp
    set_phase(b.ph, meta.bloch)
    blocks = launch_counted(_entry_point(storage, "t3d_family_update_bloch"),
                            b, device, "family_update (Bloch)")
    del keep
    _count(blocks, True, _many(states[0], consts, family))
    return outs


# --------------------------------------------------------------------------- #
# every brick of a device in one call (t3d_family_update_bricks)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class EntryPlan:
    """One entry of a call over bricks: the brick's tile grid (x chunks, y
    and z tiles), its bulk box ``[lo, hi)`` in tiles per axis (empty: all
    zero) and its first block in the bulk and in the shell launch."""

    tiles: Tuple[int, int, int]
    lo: Tuple[int, int, int]
    hi: Tuple[int, int, int]
    first: Tuple[int, int]

    @property
    def bulk_blocks(self) -> int:
        return int(np.prod(np.subtract(self.hi, self.lo)))

    @property
    def blocks(self) -> int:
        return int(np.prod(self.tiles))


def tile_grid(shape) -> Tuple[int, int, int]:
    """The tiles of a grid per axis: x chunks, y and z tiles."""
    return tuple(-(-n // t) for n, t in zip(shape, TILE))


def bulk_box(family: str, meta: StepMeta, vec: bool = True) -> tuple:
    """``(lo, hi)``: the box of tiles of ``meta``'s grid that the kernel's
    bulk instantiation takes in a call over bricks (``brick_box`` in
    ``csrc/step.cu``, which checks it): per axis the tiles whose cells lie
    outside both psi slabs of the family and whose stencil (x - 1 for E, x
    + 1 for H, the wall the family crosses) stays in the brick or crosses
    a side with a halo plane; y and z tiles whole, an x chunk whole or
    ending at the last plane. Pair-aligned arrays only (``vec``); an
    empty box is all zero."""
    is_e = family == "E"
    fam = "dual" if is_e else "primal"
    tiles = tile_grid(meta.shape)
    lo, hi = [0] * 3, [0] * 3
    for a, (n, length) in enumerate(zip(meta.shape, TILE)):
        w_lo, w_hi = meta.pml_meta[(fam, a)]
        halo = meta.halo_side(family, a)
        lo_cell = max(1, w_lo) if is_e and not halo else w_lo
        hi_cell = min(n - 1, n - w_hi) if not is_e and not halo \
            else n - w_hi
        lo[a] = hi[a] = -(-lo_cell // length)
        while hi[a] < tiles[a] and min((hi[a] + 1) * length,
                                       n if a == 0 else 2 ** 31) <= hi_cell:
            hi[a] += 1
    if not vec or any(h <= l for l, h in zip(lo, hi)):
        return (0, 0, 0), (0, 0, 0)
    return tuple(lo), tuple(hi)


def plan_bricks(family: str, metas: list, copies: int = 1,
                vecs: list = None) -> Tuple[list, Tuple[int, int]]:
    """The plan of one call over bricks: an ``EntryPlan`` per brick and
    copy (``copies`` consecutive entries of each brick's ``meta``; ``vecs``
    per brick whether its arrays are pair-aligned, default: z even), and
    the blocks of the bulk and of the shell launch. The shape alone
    decides it; no tensor is needed."""
    vecs = [m.shape[2] % 2 == 0 for m in metas] if vecs is None else vecs
    entries, blocks = [], [0, 0]
    for meta, vec in zip(metas, vecs):
        lo, hi = bulk_box(family, meta, vec)
        for _ in range(copies):
            e = EntryPlan(tile_grid(meta.shape), lo, hi, tuple(blocks))
            entries.append(e)
            blocks[0] += e.bulk_blocks
            blocks[1] += e.blocks
    return entries, tuple(blocks)


def pairs_aligned(p: FamilyParams, storage) -> bool:
    """``pair_aligned`` and ``halo_aligned`` of ``csrc/step.cu``: z even and
    every array the kernel loads or stores in pairs aligned to a pair (the
    fields, ca/cb, the inline pole currents, the x and y halo planes)."""
    fa, qa = (2 * torch.empty((), dtype=dt).element_size()
              for dt in (storage[0], storage[2]))
    ptrs = [(v, fa) for name in ("src", "old", "out")
            for v in getattr(p, name)]
    ptrs += [(v, 8) for name in ("ca", "cb") for v in getattr(p, name)]
    ptrs += [(v, fa) for v in p.halo[:6]]
    if not p.poles:
        ptrs += [(v, qa) for v in p.q[:6 * p.num_poles]]
    return p.n[2] % 2 == 0 and all((v or 0) % a == 0 for v, a in ptrs)


def brick_table(entries, device) -> torch.Tensor:
    """The device copy of a ``ctypes`` array of ``BrickEntry``, sent from
    a pinned host copy on the current stream."""
    global BRICK_TABLE_BUILDS
    raw = bytes(entries)
    host = torch.empty(len(raw), dtype=torch.uint8, pin_memory=True)
    host.numpy()[:] = np.frombuffer(raw, np.uint8)
    BRICK_TABLE_BUILDS += 1
    return host.to(device, non_blocking=True)


@dataclass
class PreparedCall:
    """One call over bricks, ready to launch: the host table
    (``entries``), its device copy, the call's parameters and what its
    launch counts; ``keep`` holds the pole tables the entries point to."""

    fn: object
    call: BrickCall
    entries: object
    table: torch.Tensor
    device: torch.device
    bloch: bool
    many: bool
    bricks: int
    keep: list

    def launch(self) -> None:
        global BRICK_CALLS
        stream = torch.cuda.current_stream(self.device).cuda_stream
        counts = (ctypes.c_int32 * 3)()
        with torch.cuda.device(self.device):
            err = self.fn(ctypes.byref(self.call), self.entries,
                          ctypes.c_void_p(stream), counts)
        if err != 0:
            raise RuntimeError(f"family_update (bricks) kernel launch "
                               f"failed: CUDA error {err}")
        BRICK_CALLS += 1
        _count(tuple(counts), self.bloch, self.many, self.bricks)


def _prepare_call(family, params, metas, storage, device, copies, many,
                  keep) -> PreparedCall:
    """The call of ``t3d_family_update_bricks`` over ``params`` (a
    ``FamilyParams`` per brick and copy, ``copies`` consecutive ones a
    brick, of one instantiation) for the bricks of ``metas``: its plan and
    its table on ``device``."""
    if any(m.bloch != metas[0].bloch for m in metas):
        raise ValueError("bricks of one call differ in their Bloch phases")
    plans, blocks = plan_bricks(family, metas, copies,
                                [bool(params[copies * b].vec)
                                 for b in range(len(metas))])
    entries = (BrickEntry * len(plans))()
    for en, p, plan in zip(entries, params, plans):
        en.p = p
        en.p.bulk_lo[:], en.p.bulk_hi[:] = plan.lo, plan.hi
        en.tiles[:] = plan.tiles
        en.first[:] = plan.first
    table = brick_table(entries, device)
    call = BrickCall(entries=table.data_ptr(), num=len(plans),
                     copies=copies)
    call.blocks[:] = blocks
    set_phase(call.ph, metas[0].bloch)
    return PreparedCall(_entry_point(storage, "t3d_family_update_bricks"),
                        call, entries, table, torch.device(device),
                        copies == 2, many,
                        sum(any(any(s) for s in m.halo) for m in metas), keep)


def _call_key(family, states, consts, srcs, halos, outs) -> tuple:
    """What a prepared call depends on: the addresses of every tensor its
    entries point to (sources, old fields and psi, outputs, halo planes,
    E's pole currents) and each brick's constants."""
    ptrs = [family]
    for sts, cs, src, hs, ob in zip(states, consts, srcs, halos, outs):
        ptrs.append(id(cs))
        for part, st in enumerate(sts):
            for d in (src[part], st[family], st["psi"], ob[part][0],
                      ob[part][1]):
                ptrs += [t.data_ptr() for t in d.values()]
            if hs and hs[part]:
                ptrs += [t.data_ptr() for planes in hs[part].values()
                         for t in planes.values()]
            if family == "E":
                ptrs += [t.data_ptr() for Qp in st["Q"]
                         for pair in Qp.values() for t in pair]
    return tuple(ptrs)


_MAX_CALLS = 8   # prepared calls a cache keeps (a run uses 4: E and H of
                 # each buffer set)


def _family_update_bricks_cuda(family, states, consts, srcs, metas, halos,
                               outs, cache):
    """Every brick in one call per device and instantiation (storage, pole
    table, pair alignment; today's plans share one): each brick's and
    copy's ``FamilyParams`` into the call's table, in brick order. With
    ``outs`` and a ``cache``, the prepared calls are kept under the
    addresses they point to and launched again as they are."""
    key = None if cache is None or outs is None else _call_key(
        family, states, consts, srcs, halos, outs)
    hit = None if key is None else cache.get(key)
    if hit is not None:
        calls, result = hit
        for call in calls:
            call.launch()
        return result
    groups: Dict[tuple, list] = {}
    params, result = [], []
    for b, (sts, cs, src, meta, hs) in enumerate(zip(states, consts, srcs,
                                                     metas, halos)):
        _check_cells(meta)
        storage, device = _storage_and_device(family, sts, src)
        copies = len(sts)
        many = _many(sts[0], consts=cs, family=family)
        ps, out = [], []
        for part in range(copies):
            p, nf, npsi, keep = _family_params(
                family, sts[part], cs, src[part], meta, storage, device,
                many or copies == 2, (hs or [None] * copies)[part],
                None if outs is None else outs[b][part])
            ps.append((p, keep))
            out.append((nf, npsi))
        vec = all(pairs_aligned(p, storage) for p, _ in ps)
        for p, _ in ps:
            p.vec = int(vec)
        groups.setdefault((device, storage, copies, many, vec),
                          []).append(b)
        params.append(ps)
        result.append(out)
    calls = [_prepare_call(family, [p for b in bricks for p, _ in params[b]],
                           [metas[b] for b in bricks], storage, device,
                           copies, many,
                           [k for b in bricks for _, k in params[b]])
             for (device, storage, copies, many, _), bricks in
             groups.items()]
    for call in calls:
        call.launch()
    if key is not None:
        if len(cache) >= _MAX_CALLS:
            cache.pop(next(iter(cache)))
        cache[key] = (calls, result)
    return result


def _into(out, got):
    """``got`` (new fields and psi) copied into the buffers ``out``."""
    fields, psi = out
    for d, src in ((fields, got[0]), (psi, got[1])):
        for k, v in src.items():
            d[k].copy_(v)
    return ({k: fields[k] for k in got[0]}, {k: psi[k] for k in got[1]})


def family_update_bricks(family: str, states: list, consts: list,
                         srcs: list, metas: list, halos: list,
                         outs: list = None, cache: dict = None) -> list:
    """``family`` of every brick (``states[b]``, ``srcs[b]``, ``halos[b]``:
    brick b's copies, ``consts[b]``, ``metas[b]`` its constants and
    layout): per brick ``[(new_fields, new_psi)]`` per copy, written to
    ``outs[b][copy]`` (``(fields, psi)`` buffers keyed as the state's)
    where given. CPU tensors: ``family_update_copies_reference`` brick by
    brick; CUDA tensors: one call of the kernel's halo mode per device
    (``BRICK_CALLS``; bricks of different instantiations in calls of their
    own; no brick, no call), its table built anew, or with ``outs`` kept
    in ``cache`` (a dict that serves one runner's layouts) and launched
    again when the same buffers come back."""
    if not states:
        return []
    device = next(iter(srcs[0][0].values())).device
    if device.type == "cpu":
        got = [family_update_copies_reference(family, st, cs, src, meta, hs)
               for st, cs, src, meta, hs in zip(states, consts, srcs, metas,
                                                halos)]
        return got if outs is None else [
            [_into(o, g) for o, g in zip(ob, gb)]
            for ob, gb in zip(outs, got)]
    if device.type != "cuda":
        raise ValueError(f"family_update: unsupported device '{device}'")
    return _family_update_bricks_cuda(family, states, consts, srcs, metas,
                                      halos, outs, cache)


def family_update_copies_reference(family: str, states: list, consts: dict,
                                   srcs: list, meta: StepMeta,
                                   halos: list = None) -> list:
    """``[(new_fields, new_psi)]`` of ``family`` for each copy (``states``,
    ``srcs``: one, or the two of a complex run), the plain version copy by
    copy, the other copy's sources as ``partner``; ``halos``: each copy's
    halo planes of a brick."""
    halos = halos or [None] * len(states)
    if len(states) == 1:
        return [family_update_reference(family, states[0], consts, srcs[0],
                                        meta, halo=halos[0])]
    return [family_update_reference(family, st, consts, src, meta,
                                    partner=srcs[1 - part], part=part,
                                    halo=halos[part])
            for part, (st, src) in enumerate(zip(states, srcs))]


def family_update_copies(family: str, states: list, consts: dict,
                         srcs: list, meta: StepMeta,
                         halos: list = None) -> list:
    """``family_update_copies_reference`` for CPU tensors; for CUDA tensors
    one call of the kernel (the two-copy instantiation for a complex run;
    a brick's, one with halo sides, ``family_update_bricks`` of that
    brick)."""
    device = next(iter(srcs[0].values())).device
    if device.type == "cpu":
        return family_update_copies_reference(family, states, consts, srcs,
                                              meta, halos)
    if device.type != "cuda":
        raise ValueError(f"family_update: unsupported device '{device}'")
    if any(any(sides) for sides in meta.halo):
        return family_update_bricks(family, [states], [consts], [srcs],
                                    [meta], [halos])[0]
    if len(states) == 1:
        return [_family_update_cuda(family, states[0], consts, srcs[0],
                                    meta)]
    return _family_update_bloch_cuda(family, states, consts, srcs, meta)


def family_update(family: str, state: dict, consts: dict, src_fields: dict,
                  meta: StepMeta):
    """One half-step family: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns ``(new_fields, new_psi)``."""
    device = next(iter(src_fields.values())).device
    if device.type == "cpu":
        return family_update_reference(family, state, consts, src_fields,
                                        meta)
    if device.type != "cuda":
        raise ValueError(f"family_update: unsupported device '{device}'")
    return _family_update_cuda(family, state, consts, src_fields, meta)
