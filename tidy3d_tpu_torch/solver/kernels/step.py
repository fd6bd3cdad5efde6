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
``MAX_POLES`` slots from a table and ``BRICK_LAUNCHES`` those of a brick in
its halo mode.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..lowering import E_COMPS, H_COMPS

LAUNCHES = 0
DEVICE_LAUNCHES = 0  # the bulk and the shell launch of each call
BLOCH_LAUNCHES = 0   # calls of the two-copy (Bloch) instantiation
MANY_POLES_LAUNCHES = 0  # calls with more than MAX_POLES pole slots
BRICK_LAUNCHES = 0  # calls in the brick-local halo mode (a sharded run)
# the last call's blocks (bulk and shell launches) and device launches
LAST_BLOCKS = (0, 0, 0)
MAX_POLES = 8       # pole slots in the parameter block (csrc/*.cu MAX_POLES)
STORAGE = (torch.float32, torch.bfloat16)   # the storage types of the state

_WALL = {"pec": 0, "pmc": 1, "periodic": 2}
WALL_HALO = 3   # csrc/step.cu: the neighbour is the brick's halo plane


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


class BlochParams(ctypes.Structure):
    """Mirror of ``struct BlochParams`` in ``csrc/step.cu``."""

    _fields_ = [("c", FamilyParams * 2), ("bc", ctypes.c_float * 3),
                ("bs", ctypes.c_float * 3), ("bloch", ctypes.c_int32 * 3),
                ("nchunk", ctypes.c_int32)]


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
        check_storage(lib, "t3d_family_storage", storage)
        fn.argtypes = [ctypes.POINTER(FamilyParams), ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bloch = lib.t3d_family_update_bloch
        bloch.argtypes = [ctypes.POINTER(BlochParams), ctypes.c_void_p,
                          ctypes.c_void_p]
        bloch.restype = ctypes.c_int
    return fn


def _bloch_library(storage):
    from ... import _build

    _library(storage)
    lib = _build.load("step", storage_defines(*storage))
    return lib.t3d_family_update_bloch


MODES = {"real": 0, "many": 1, "bloch": 2}   # t3d_family_info's mode


def resources(family: str, bulk: bool, storage=(torch.float32,) * 3,
              mode: str = "real") -> dict:
    """Threads, shared bytes, blocks per SM and registers of the E or H,
    bulk or shell (pair-aligned arrays) instantiation of the kernel in the
    library of the storage types ``(field, psi, q)`` (the CUDA occupancy
    calculator), of a real run (``mode`` ``real``), a real run with the
    pole table (``many``) or a Bloch run (``bloch``); needs the card."""
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
                   device, table: bool, halo: dict = None):
    """The parameter struct of one copy's family call: ``(p, new_fields,
    new_psi, keep)``, ``keep`` the device tables it points to. A brick's
    sides with a halo take ``WALL_HALO`` and the planes of ``halo``."""
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
        new_fields[oc] = torch.empty(shape, dtype=storage[0], device=device)
        p.out[i] = new_fields[oc].data_ptr()
    new_psi = set_family_params(family, state, consts, meta, {
        name: getattr(p, name) for name in FAMILY_FIELDS},
        psi_dtype=storage[1])
    keep = set_family_poles(p, state, consts, shape, storage[2], device,
                            table) if is_e else []
    return p, new_fields, new_psi, keep


def _count(blocks, bloch: bool, many: bool, meta: StepMeta) -> None:
    global LAUNCHES, DEVICE_LAUNCHES, LAST_BLOCKS, BLOCH_LAUNCHES, \
        MANY_POLES_LAUNCHES, BRICK_LAUNCHES
    LAUNCHES += 1
    BLOCH_LAUNCHES += bloch
    MANY_POLES_LAUNCHES += many
    BRICK_LAUNCHES += any(any(sides) for sides in meta.halo)
    DEVICE_LAUNCHES += blocks[2]
    LAST_BLOCKS = blocks


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


def _family_update_cuda(family, state, consts, src_fields, meta,
                        halo=None):
    _check_cells(meta)
    storage, device = _storage_and_device(family, [state], [src_fields])
    many = _many(state, consts, family)
    p, new_fields, new_psi, keep = _family_params(
        family, state, consts, src_fields, meta, storage, device, many, halo)
    blocks = launch_counted(_library(storage), p, device, "family_update")
    del keep
    _count(blocks, False, many, meta)
    return new_fields, new_psi


def _family_update_bloch_cuda(family, states, consts, srcs, meta,
                              halos=(None, None)):
    """Both copies of a Bloch run in one call of the two-copy
    instantiation (each copy's pole slots from its table)."""
    _check_cells(meta)
    storage, device = _storage_and_device(family, states, srcs)
    b = BlochParams()
    outs, keep = [], []
    for part in range(2):
        p, nf, npsi, kp = _family_params(family, states[part], consts,
                                         srcs[part], meta, storage, device,
                                         True, halos[part])
        b.c[part] = p
        outs.append((nf, npsi))
        keep += kp
    for a, cs in enumerate(meta.bloch):
        b.bloch[a] = int(cs is not None)
        b.bc[a], b.bs[a] = cs if cs is not None else (1.0, 0.0)
    blocks = launch_counted(_bloch_library(storage), b, device,
                            "family_update (Bloch)")
    del keep
    _count(blocks, True, _many(states[0], consts, family), meta)
    return outs


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
    a brick's in its halo mode, ``BRICK_LAUNCHES``)."""
    device = next(iter(srcs[0].values())).device
    if device.type == "cpu":
        return family_update_copies_reference(family, states, consts, srcs,
                                              meta, halos)
    if device.type != "cuda":
        raise ValueError(f"family_update: unsupported device '{device}'")
    halos = halos or [None] * len(states)
    if len(states) == 1:
        return [_family_update_cuda(family, states[0], consts, srcs[0],
                                    meta, halos[0])]
    return _family_update_bloch_cuda(family, states, consts, srcs, meta,
                                     halos)


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
