"""The pole-current update of the ``pallas2`` tier in one launch.

``update_poles_copies(new_es, old_es, Qs, consts, cache)`` updates the pole
currents of every copy of a run (or of one brick) in place, after the E
family, the J sources and the modulation and nonlinear passes of each copy:
the port of ``FDTDRunner._update_poles`` (``tidy3d_tpu/solver/fdtd.py:1145-
1184``, called at :1691), which in the JAX package is XLA code inside the
jitted step, no ``pallas_call``; here it is one hand-written kernel,
``csrc/poles.cu``, for every slot, component and copy. The copies never
read each other's currents, so one call after both copies' passes keeps
each copy's order (E family, J sources, passes, poles).

``update_poles`` is the plain version on one copy (eager PyTorch, in place;
with bfloat16 storage ``_update_poles_stored``), and ``pole_update`` the
out-of-place update of the differentiable run and the fused step's plain
version (autograd on plain PyTorch, as the reference's XLA route).

The kernel reads its slots from a device table of ``PoleSlot``, built from
``slot_records`` (a record per slot and copy: its currents, A, the residue's
kind, maps and B0 per component) by ``pack``, and sent from a pinned host
copy on the current stream ahead of the launch. A table holds pointers
only; it is built once per runner or brick and kept in the caller's
``cache`` under the ``data_ptr``s of the currents and constant maps it
points to, so that a resumed or re-cast state gets a fresh table and a
state allocated at the same addresses keeps its table. A launch stages at
most ``MAX_SLOTS`` records; a table of more is cut into consecutive
launches of at most that many (``split_records``), each with its own copy
ranges and the components its records read. A record reads only its own
currents and its copy's E^{n+1} and E^n, so the launches give what one
launch would, bit for bit.

Dispatch is by device: CPU tensors go to ``update_poles``, copy by copy;
CUDA tensors launch the kernel or raise. ``LAUNCHES`` counts the calls that
launched, ``DEVICE_LAUNCHES`` the launches, ``TABLE_BUILDS`` the tables
built.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..lowering import E_COMPS
from .step import POLE_KIND, STORAGE, launch_counted

LAUNCHES = 0
DEVICE_LAUNCHES = 0
TABLE_BUILDS = 0
VW = 4              # cells a thread takes a pass (csrc/poles.cu)
MAX_COPIES = 2      # the copies of a Bloch run (csrc/poles.cu MAX_COPIES)
MAX_SLOTS = 240     # records of one launch: the table staged in 48 KB

_P6 = ctypes.c_void_p * 6
_F6 = ctypes.c_float * 6


class PoleSlot(ctypes.Structure):
    """Mirror of ``struct PoleSlot`` in ``csrc/poles.cu`` (the layout of
    ``fused.PoleSlot``, its last word the copy)."""

    _fields_ = [
        ("q", _P6), ("q_out", _P6), ("b", _P6),
        ("gc_re", ctypes.c_float), ("gc_im", ctypes.c_float),
        ("a_re", ctypes.c_float), ("a_im", ctypes.c_float),
        ("b0", _F6), ("kind", ctypes.c_int32 * 3), ("copy", ctypes.c_int32),
    ]


class PoleParams(ctypes.Structure):
    """Mirror of ``struct PoleParams`` in ``csrc/poles.cu``."""

    _fields_ = [
        ("e_new", ctypes.c_void_p * (3 * MAX_COPIES)),
        ("e_old", ctypes.c_void_p * (3 * MAX_COPIES)),
        ("slots", ctypes.c_void_p),
        ("first", ctypes.c_int32 * (MAX_COPIES + 1)),
        ("num_copies", ctypes.c_int32), ("n", ctypes.c_int32),
        ("vec", ctypes.c_int32),
    ]


@dataclass(frozen=True)
class SlotRecord:
    """One pole slot of one copy, as the kernel's table carries it."""

    copy: int
    q: tuple        # (qr, qi) of each component in E_COMPS order: 6 tensors
    a: Tuple[float, float]        # A = (re, im)
    gc: Tuple[float, float]       # Gc = (re, im)
    kind: Tuple[int, int, int]    # POLE_KIND per component
    b: tuple        # per component the mask and None, the dense (re, im)
                    # maps, or two None: 6 entries
    b0: Tuple[float, ...]         # per component the mask kind's B0


def slot_records(Qs: list, consts: dict) -> list:
    """The records of every slot of every copy (``Qs[c]``: copy c's
    ``[{comp: (qr, qi)}]``), copy 0's first."""
    scalars, metas_all = consts["pole_scalars"], consts["pole_B_meta"]
    out = []
    for copy, Q in enumerate(Qs):
        if len(Q) != len(scalars):
            raise ValueError(f"copy {copy} holds {len(Q)} pole currents, "
                             f"the plan {len(scalars)} poles")
        for pi, ((A, Gc), metas, Qp) in enumerate(zip(scalars, metas_all,
                                                      Q)):
            q, kind, b, b0 = [], [], [], []
            for ci, comp in enumerate(E_COMPS):
                q += list(Qp[comp])
                m = metas[ci]
                kind.append(POLE_KIND[m["kind"]])
                if m["kind"] == "mask":
                    b += [consts["pole_masks"][m["mask_id"]], None]
                    b0 += [float(v) for v in m["B0"]]
                else:
                    b += list(consts["pole_B_dense"][f"{pi}_{ci}"]) \
                        if m["kind"] == "dense" else [None, None]
                    b0 += [0.0, 0.0]
            out.append(SlotRecord(copy, tuple(q), (A.real, A.imag),
                                  (Gc.real, Gc.imag), tuple(kind),
                                  tuple(b), tuple(b0)))
    return out


def pack(records: list):
    """The ``ctypes`` array of ``PoleSlot`` of ``records`` (``q_out`` =
    ``q``: the update is in place)."""
    slots = (PoleSlot * len(records))()
    for slot, rec in zip(slots, records):
        for j, t in enumerate(rec.q):
            slot.q[j] = slot.q_out[j] = t.data_ptr()
        for j, t in enumerate(rec.b):
            slot.b[j] = None if t is None else t.data_ptr()
        slot.a_re, slot.a_im = rec.a
        slot.gc_re, slot.gc_im = rec.gc
        slot.b0[:] = rec.b0
        slot.kind[:] = rec.kind
        slot.copy = rec.copy
    return slots


def _check(t, shape, name, dtype, device) -> torch.Tensor:
    if not isinstance(t, torch.Tensor) or t.device != torch.device(device):
        raise ValueError(f"{name}: expected a tensor on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t


def table_key(Qs: list, consts: dict) -> tuple:
    """The addresses a table of ``Qs`` points to: every current's and
    every constant map's ``data_ptr``."""
    return (tuple(t.data_ptr() for Q in Qs for Qp in Q for comp in E_COMPS
                  for t in Qp[comp]),
            tuple(m.data_ptr() for m in consts["pole_masks"]),
            tuple(t.data_ptr() for pair in consts["pole_B_dense"].values()
                  for t in pair))


@dataclass(frozen=True)
class Launch:
    """One launch of a table: its records ``start`` to ``stop - 1``, the
    range of each copy in it (``first``, ``MAX_COPIES + 1`` entries, from
    0) and per copy the components some record of it reads E on
    (``need``)."""

    start: int
    stop: int
    first: Tuple[int, ...]
    need: Tuple[Tuple[bool, bool, bool], ...]


def split_records(records: list, copies: int,
                  most: int = MAX_SLOTS) -> list:
    """The ``Launch``es of ``records`` (copy 0's first): consecutive runs
    of at most ``most`` records, in order."""
    out = []
    for start in range(0, len(records), most):
        part = records[start:start + most]
        first = [0] * (MAX_COPIES + 1)
        for c in range(copies):
            first[c + 1] = first[c] + sum(rec.copy == c for rec in part)
        first[copies + 1:] = [first[copies]] * (MAX_COPIES - copies)
        need = tuple(tuple(any(rec.kind[ci] and rec.copy == c
                               for rec in part) for ci in range(3))
                     for c in range(copies))
        out.append(Launch(start, start + len(part), tuple(first), need))
    return out


class PoleTable:
    """The device table of a runner's or brick's slots, with what its
    launches need besides: per launch its records, the slot range of each
    copy and the components some residue reads (``launches``; the whole
    table's in ``first`` and ``need``), and whether every array the table
    points to is aligned to ``VW`` values (``aligned``). It keeps no
    tensor but its own, so the currents it points to are freed with the
    state."""

    def __init__(self, key, Qs, consts, shape, q_dtype, device):
        records = slot_records(Qs, consts)
        width = VW * torch.empty((), dtype=q_dtype).element_size()
        aligned = True
        for rec in records:
            for j, t in enumerate(rec.q):
                _check(t, shape, f"slot {rec.copy}:{j}", q_dtype, device)
                aligned &= t.data_ptr() % width == 0
            for t in rec.b:
                if t is not None:
                    _check(t, shape, "pole residue", torch.float32, device)
                    aligned &= t.data_ptr() % (4 * VW) == 0
        self.key = key
        self.aligned = aligned
        whole = split_records(records, len(Qs), max(len(records), 1))[0]
        self.first = list(whole.first)
        self.need = [list(n) for n in whole.need]
        self.launches = split_records(records, len(Qs))
        raw = bytes(pack(records))
        host = torch.empty(len(raw), dtype=torch.uint8,
                           pin_memory=torch.device(device).type == "cuda")
        host.numpy()[:] = np.frombuffer(raw, np.uint8)
        self.tensor = host.to(device, non_blocking=True)


def _library(field=torch.float32, q=torch.float32):
    from ... import _build

    for dt in (field, q):
        if dt not in STORAGE:
            raise ValueError(f"storage type {dt}: the kernel stores "
                             f"{', '.join(map(str, STORAGE))}")
    lib = _build.load("poles", _defines(field, q))
    fn = lib.t3d_poles
    if fn.argtypes is None:
        _build.check_struct(lib, "t3d_poles_params_size", PoleParams)
        _build.check_struct(lib, "t3d_poles_slot_size", PoleSlot)
        sizes = (ctypes.c_int32 * 2)()
        lib.t3d_poles_storage.argtypes = [ctypes.c_void_p]
        lib.t3d_poles_storage.restype = None
        lib.t3d_poles_storage(sizes)
        want = tuple(torch.empty((), dtype=dt).element_size()
                     for dt in (field, q))
        if tuple(sizes) != want:
            raise RuntimeError(f"poles: the library stores {tuple(sizes)} "
                               f"bytes a value, the storage types {want}")
        fn.argtypes = [ctypes.POINTER(PoleParams), ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _defines(field, q) -> tuple:
    return tuple(name for name, dt in (("T3D_FIELD_BF16", field),
                                       ("T3D_Q_BF16", q))
                 if dt == torch.bfloat16)


def prepare(device, field=torch.float32, q=torch.float32) -> None:
    """Build and load the kernel library of the storage types of the
    fields and the currents for ``device`` (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        _library(field, q)


def resources(field=torch.float32, q=torch.float32, num_slots: int = 1,
              vec: bool = True) -> dict:
    """Threads, shared bytes, blocks per SM and registers of the aligned
    (``vec``) or cell-by-cell instantiation with ``num_slots`` slots
    staged; needs the card."""
    from ... import _build

    _library(field, q)
    fn = _build.load("poles", _defines(field, q)).t3d_poles_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int32 * 4)()
    err = fn(int(vec), num_slots, out)
    if err:
        raise RuntimeError(f"poles resources: CUDA error {err}")
    return dict(zip(("threads", "shared_bytes", "blocks_per_sm",
                     "registers"), out))


def _table(Qs, consts, shape, q_dtype, device, cache) -> PoleTable:
    global TABLE_BUILDS
    key = table_key(Qs, consts)
    table = cache.get("table")
    if table is None or table.key != key:
        table = PoleTable(key, Qs, consts, shape, q_dtype, device)
        cache["table"] = table
        TABLE_BUILDS += 1
    return table


def _update_poles_cuda(new_es, old_es, Qs, consts, cache):
    global LAUNCHES, DEVICE_LAUNCHES
    if len(Qs) > MAX_COPIES:
        raise ValueError(f"{len(Qs)} copies: the kernel takes at most "
                         f"{MAX_COPIES}")
    field = new_es[0][E_COMPS[0]].dtype
    q_dtype = Qs[0][0][E_COMPS[0]][0].dtype
    shape = tuple(new_es[0][E_COMPS[0]].shape)
    n = int(np.prod(shape))
    if n >= 2 ** 31:
        raise ValueError(f"grid {shape}: the pole kernel takes fewer than "
                         "2^31 cells")
    device = new_es[0][E_COMPS[0]].device
    table = _table(Qs, consts, shape, q_dtype, device, cache)
    fn = _library(field, q_dtype)
    width = VW * torch.empty((), dtype=field).element_size()
    for launch in table.launches:
        p = PoleParams()
        p.n = n
        p.num_copies = len(Qs)
        p.slots = table.tensor.data_ptr() + launch.start * ctypes.sizeof(
            PoleSlot)
        p.first[:] = launch.first
        vec = table.aligned and n % VW == 0
        for c, (ne, oe) in enumerate(zip(new_es, old_es)):
            for ci, comp in enumerate(E_COMPS):
                if not launch.need[c][ci]:
                    continue
                for arr, d, what in ((p.e_new, ne, comp),
                                     (p.e_old, oe, f"old {comp}")):
                    ptr = _check(d[comp], shape, what, field,
                                 device).data_ptr()
                    arr[3 * c + ci] = ptr
                    vec &= ptr % width == 0
        p.vec = int(vec)
        DEVICE_LAUNCHES += launch_counted(fn, p, device, "poles")[1]
    LAUNCHES += 1
    return Qs


def update_poles_copies(new_es: list, old_es: list, Qs: list, consts: dict,
                        cache: Optional[dict] = None) -> list:
    """The pole update of every copy (``new_es[c]``, ``old_es[c]``:
    E^{n+1} and E^n of copy c, ``Qs[c]`` its currents), in place; returns
    ``Qs``. CUDA tensors: one launch of the kernel, its table kept in
    ``cache`` (a dict a runner or brick keeps; none builds it anew); CPU
    tensors: ``update_poles`` on each copy."""
    if not Qs or not Qs[0]:
        return Qs
    device = new_es[0][E_COMPS[0]].device
    if device.type == "cpu":
        return [update_poles(ne, oe, Q, consts)
                for ne, oe, Q in zip(new_es, old_es, Qs)]
    if device.type != "cuda":
        raise ValueError(f"poles: unsupported device '{device}'")
    return _update_poles_cuda(new_es, old_es, Qs, consts,
                              {} if cache is None else cache)


def update_poles(new_e: dict, old_e: dict, Q: list, consts: dict) -> list:
    """The plain semi-implicit pole-current update of one copy (the port
    of ``FDTDRunner._update_poles``, ``fdtd.py:1145-1184``), in place on
    the ``(qr, qi)`` buffers of ``Q``, which it returns.

    ``Q' = A Q + B (E^{n+1} + E^n)`` per pole and component, with the
    complex products written out in real and imaginary parts as the
    reference writes them. ``E^{n+1} + E^n`` is formed once per component
    and its product with a support mask once per (mask, component), so the
    poles of one metal share them.

    Stored in bfloat16 (fields or currents), the update is
    ``_update_poles_stored``."""
    tensors = list(new_e.values()) + [t for Qp in Q for pair in Qp.values()
                                      for t in pair]
    if any(t.dtype != torch.float32 for t in tensors):
        return _update_poles_stored(new_e, old_e, Q, consts)
    cache = {}
    for pi, ((A, _), metas, Qp) in enumerate(zip(
            consts["pole_scalars"], consts["pole_B_meta"], Q)):
        for ci, comp in enumerate(E_COMPS):
            qr, qi = Qp[comp]
            # qr' = Re(A) qr - Im(A) qi, qi' = Im(A) qr + Re(A) qi
            im_qr = qr * A.imag
            qr.mul_(A.real).add_(qi, alpha=-A.imag)
            qi.mul_(A.real).add_(im_qr)
            del im_qr
            m = metas[ci]
            if m["kind"] == "zero":
                continue
            if ("e", ci) not in cache:
                cache[("e", ci)] = new_e[comp] + old_e[comp]
            esum = cache[("e", ci)]
            if m["kind"] == "mask":
                mkey = (m["mask_id"], ci)
                if mkey not in cache:
                    cache[mkey] = consts["pole_masks"][m["mask_id"]] * esum
                mes = cache[mkey]
                b_re, b_im = m["B0"]
                if b_re:
                    qr.add_(mes, alpha=b_re)
                if b_im:
                    qi.add_(mes, alpha=b_im)
            else:
                b_re, b_im = consts["pole_B_dense"][f"{pi}_{ci}"]
                qr.addcmul_(b_re, esum)
                qi.addcmul_(b_im, esum)
    return Q


def _pole_currents(new_e: dict, old_e: dict, Q: list, consts: dict):
    """Yields ``(p, comp, qr', qi')``, the new currents of pole p, one
    component at a time, with the arithmetic of the reference's
    ``_update_poles`` (``fdtd.py:1145-1184``) as new tensors: ``A Q`` and
    its sum, and ``E^{n+1} + E^n``, at the state's types (a Python scalar
    keeps a tensor's type under PyTorch's promotion rules, as under JAX's);
    the float32 masks and residues promote the residue term, and the sum,
    to float32. ``E^{n+1} + E^n`` is formed once per component and its
    product with a support mask once per (mask, component)."""
    cache = {}
    for pi, ((A, _), metas, Qp) in enumerate(zip(
            consts["pole_scalars"], consts["pole_B_meta"], Q)):
        for ci, comp in enumerate(E_COMPS):
            qr, qi = Qp[comp]
            nqr = qr * A.real - qi * A.imag
            nqi = qr * A.imag + qi * A.real
            m = metas[ci]
            if m["kind"] != "zero":
                if ("e", ci) not in cache:
                    cache[("e", ci)] = new_e[comp] + old_e[comp]
                esum = cache[("e", ci)]
                if m["kind"] == "mask":
                    mkey = (m["mask_id"], ci)
                    if mkey not in cache:
                        cache[mkey] = consts["pole_masks"][m["mask_id"]] \
                            * esum
                    b_re, b_im = m["B0"]
                    if b_re:
                        nqr = nqr + b_re * cache[mkey]
                    if b_im:
                        nqi = nqi + b_im * cache[mkey]
                else:
                    b_re, b_im = consts["pole_B_dense"][f"{pi}_{ci}"]
                    nqr = nqr + b_re * esum
                    nqi = nqi + b_im * esum
            yield pi, comp, nqr, nqi


def _update_poles_stored(new_e: dict, old_e: dict, Q: list,
                         consts: dict) -> list:
    """``update_poles`` on bfloat16 fields and currents: the currents of
    ``_pole_currents``, each written back as soon as it is formed, rounded
    once more to its type, as ``_cast_state`` casts the carry."""
    for pi, comp, nqr, nqi in _pole_currents(new_e, old_e, Q, consts):
        qr, qi = Q[pi][comp]
        qr.copy_(nqr)
        qi.copy_(nqi)
    return Q


def pole_update(new_e: dict, old_e: dict, Q: list, consts: dict) -> list:
    """The pole-current update out of place, for the differentiable run
    and the fused step's plain version (float32 currents there): the new
    ``[{comp: (qr, qi)}]`` of ``_pole_currents``, ``Q`` left as it is."""
    out = [{} for _ in Q]
    for pi, comp, nqr, nqi in _pole_currents(new_e, old_e, Q, consts):
        out[pi][comp] = (nqr, nqi)
    return out
