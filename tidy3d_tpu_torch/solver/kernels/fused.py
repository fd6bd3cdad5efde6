"""The fused one-step update: the counterpart of ``pallas_fused.py``.

``fused_step(state, consts, meta, sources)`` computes one whole leapfrog
step of the fields and the pole currents: the E half-step (curl H, CPML psi
of all three axes, the pole currents' term, the PEC lo-wall masks), the J
source terms of this step on E', the pole update ``Q' = A Q + B (E' + E)``
and the H half-step from E' (with its psi). It returns ``(new_E, new_H,
new_psi, new_Q)``, where ``new_psi`` holds every psi slab, and leaves
``state`` untouched. The semantics are those of the XLA step
``tidy3d_tpu.solver.fdtd.FDTDRunner._step`` up to the H-side sources, which
the runner adds afterwards, as ``_step_fused`` does.

``sources`` is a list of ``(comp, slices, term, w)``: ``E'_comp[slices] +=
term * w``, with ``term`` of the slice's shape and ``w`` this step's
waveform value.

Storage (``step.STORAGE``): the state's fields, psi and pole currents are
float32 or bfloat16. Both versions widen them to float32, compute E' with
its J terms in float32, take H' from that float32 E', take the pole
update's ``E' + E`` from E' rounded to the field type (the E' the next step
reads) and round E', H', psi' and Q' once where they are stored, as
``PallasFusedStepper.step_update`` computes H from its unrounded E
(``pallas_fused.py:487-551``).

Dispatch is by device: a CPU tensor goes to ``fused_step_reference`` (the
two family updates of ``step.py`` with the injection between them, and the
out-of-place pole update of ``fdtd.pole_update`` in float32); a CUDA tensor
launches the hand-written kernel in ``csrc/fused.cu`` or raises. The
kernel writes Q' to ``q_out`` where the caller gives it (the runner's
second pole-current set), else to new tensors. ``LAUNCHES`` counts the
calls; each makes two device launches (``DEVICE_LAUNCHES``): the bulk
tiles, on an instantiation without wall, psi slab and source code, then
every tile on the shell instantiation, whose blocks for bulk tiles
return at once.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from ..lowering import E_COMPS, H_COMPS

from . import step
from .step import MAX_POLES, StepMeta, _check_field, storage_of

LAUNCHES = 0
DEVICE_LAUNCHES = 0  # the bulk and the shell launch of each call
MANY_POLES_LAUNCHES = 0  # calls with more than MAX_POLES pole slots
MAX_SOURCES = 32    # J source boxes the kernel takes (csrc/fused.cu)

Source = Tuple[str, Tuple[slice, slice, slice], torch.Tensor, float]


def unsupported_reason(num_sources: int) -> Optional[str]:
    """Why the fused kernel does not take a run with ``num_sources``
    E-side source terms, or None if it does. (The runner's
    ``select_tier`` keeps complex, nonlinear and modulated runs off the
    fused tier; the kernel takes any number of pole slots, more than
    ``MAX_POLES`` from a device table.)"""
    if num_sources > MAX_SOURCES:
        return (f"{num_sources} E-side source terms (the kernel takes "
                f"{MAX_SOURCES})")
    return None


# --------------------------------------------------------------------------- #
# the plain PyTorch version
# --------------------------------------------------------------------------- #


def fused_step_reference(state: dict, consts: dict, meta: StepMeta,
                         sources: List[Source], store: bool = True):
    """Plain PyTorch step on any device: E family, J injection, H family,
    pole update, in float32, out of place; E', H', the new psi and Q'
    rounded to the state's types (or left in float32 with ``store=False``,
    and then ``E' + E`` takes the float32 E'). The pole update is
    ``fdtd.pole_update`` on float32 currents."""
    from ..fdtd import pole_update

    new_e, psi_e = step.family_update_reference("E", state, consts,
                                                state["H"], meta, store=False)
    for comp, sl, term, w in sources:
        new_e[comp][sl].add_(term * w)
    new_h, psi_h = step.family_update_reference("H", state, consts, new_e,
                                                meta, store=False)
    new_psi = dict(state["psi"])
    new_psi.update(psi_e)
    new_psi.update(psi_h)
    stored_e = {c: v.to(state["E"][c].dtype).float() if store else v
                for c, v in new_e.items()}
    new_q = pole_update(
        stored_e, {c: step.f32(v) for c, v in state["E"].items()},
        [{c: (step.f32(qr), step.f32(qi)) for c, (qr, qi) in Qp.items()}
         for Qp in state["Q"]], consts)
    if store:
        new_e = {c: v.to(state["E"][c].dtype) for c, v in new_e.items()}
        new_h = {c: v.to(state["H"][c].dtype) for c, v in new_h.items()}
        new_psi = {key: v.to(state["psi"][key].dtype)
                   for key, v in new_psi.items()}
        new_q = [{c: (qr.to(old[c][0].dtype), qi.to(old[c][1].dtype))
                  for c, (qr, qi) in Qp.items()}
                 for Qp, old in zip(new_q, state["Q"])]
    return new_e, new_h, new_psi, new_q


# --------------------------------------------------------------------------- #
# the CUDA kernel (csrc/fused.cu) through ctypes
# --------------------------------------------------------------------------- #

_P3 = ctypes.c_void_p * 3
_I3 = ctypes.c_int32 * 3


class SrcBox(ctypes.Structure):
    """Mirror of ``struct SrcBox`` in ``csrc/fused.cu``."""

    _fields_ = [("term", ctypes.c_void_p), ("comp", ctypes.c_int32),
                ("lo", _I3), ("hi", _I3), ("w", ctypes.c_float)]


class FusedParams(ctypes.Structure):
    """Mirror of ``struct FusedParams`` in ``csrc/fused.cu``."""

    _fields_ = [
        ("e_old", _P3), ("h_old", _P3), ("e_new", _P3), ("h_new", _P3),
        ("ca_e", _P3), ("cb_e", _P3), ("ca_h", _P3), ("cb_h", _P3),
        ("inv_e", _P3), ("inv_h", _P3),
        ("psi_in_e", ctypes.c_void_p * 12), ("psi_out_e", ctypes.c_void_p * 12),
        ("psi_in_h", ctypes.c_void_p * 12), ("psi_out_h", ctypes.c_void_p * 12),
        ("pml_b_e", ctypes.c_void_p * 6), ("pml_c_e", ctypes.c_void_p * 6),
        ("pml_b_h", ctypes.c_void_p * 6), ("pml_c_h", ctypes.c_void_p * 6),
        ("q", ctypes.c_void_p * (6 * MAX_POLES)),
        ("q_out", ctypes.c_void_p * (6 * MAX_POLES)),
        ("pole_b", ctypes.c_void_p * (6 * MAX_POLES)),
        ("src", SrcBox * MAX_SOURCES),
        ("ca_s_e", ctypes.c_float * 3), ("cb_s_e", ctypes.c_float * 3),
        ("ca_s_h", ctypes.c_float * 3), ("cb_s_h", ctypes.c_float * 3),
        ("gc_re", ctypes.c_float * MAX_POLES),
        ("gc_im", ctypes.c_float * MAX_POLES),
        ("a_re", ctypes.c_float * MAX_POLES),
        ("a_im", ctypes.c_float * MAX_POLES),
        ("pole_b0", ctypes.c_float * (6 * MAX_POLES)),
        ("pole_kind", ctypes.c_int32 * (3 * MAX_POLES)),
        ("n", _I3),
        ("w_e", ctypes.c_int32 * 6), ("w_h", ctypes.c_int32 * 6),
        ("bk_lo", _I3), ("bk_hi", _I3), ("pec_lo", _I3),
        ("bulk_lo", _I3), ("bulk_hi", _I3),
        ("num_poles", ctypes.c_int32), ("num_src", ctypes.c_int32),
        ("vec", ctypes.c_int32), ("poles", ctypes.c_void_p),
    ]


class PoleSlot(ctypes.Structure):
    """Mirror of ``struct PoleSlot`` in ``csrc/fused.cu``: one slot of the
    device table of a call with more than ``MAX_POLES`` slots."""

    _fields_ = [
        ("q", ctypes.c_void_p * 6), ("q_out", ctypes.c_void_p * 6),
        ("b", ctypes.c_void_p * 6),
        ("gc_re", ctypes.c_float), ("gc_im", ctypes.c_float),
        ("a_re", ctypes.c_float), ("a_im", ctypes.c_float),
        ("b0", ctypes.c_float * 6), ("kind", ctypes.c_int32 * 3),
        ("pad", ctypes.c_int32),
    ]


def pole_table(state, q_out, consts, shape, dtype, device) -> torch.Tensor:
    """The device table of every pole slot (``PoleSlot``): the slots' Gc and
    A, their currents and outputs (of type ``dtype``) and, per component,
    the residue's kind, maps and B0, as ``step.set_pole_update_params``
    fills the parameter block's."""
    poles = step.pole_terms(state, consts)
    if len(q_out) != len(poles):
        raise ValueError(f"out holds {len(q_out)} pole currents, the plan "
                         f"{len(poles)} poles")
    slots = (PoleSlot * len(poles))()
    for pi, ((gc_re, gc_im, Qp), (A, _), metas) in enumerate(zip(
            poles, consts["pole_scalars"], consts["pole_B_meta"])):
        slot = slots[pi]
        slot.gc_re, slot.gc_im = gc_re, gc_im
        slot.a_re, slot.a_im = A.real, A.imag
        for ci, comp in enumerate(E_COMPS):
            for part in range(2):
                for arr, tensors, what in ((slot.q, Qp, "Q"),
                                           (slot.q_out, q_out[pi], "out Q")):
                    arr[2 * ci + part] = step.check_pair_aligned(
                        _check_field(tensors[comp][part], shape,
                                     f"{what}{pi}_{comp}", dtype),
                        f"{what}{pi}_{comp}").data_ptr()
            m = metas[ci]
            slot.kind[ci] = step.POLE_KIND[m["kind"]]
            if m["kind"] == "mask":
                slot.b[2 * ci] = _check_field(
                    consts["pole_masks"][m["mask_id"]], shape,
                    f"pole mask {m['mask_id']}").data_ptr()
                slot.b0[2 * ci], slot.b0[2 * ci + 1] = m["B0"]
            elif m["kind"] == "dense":
                b_re, b_im = consts["pole_B_dense"][f"{pi}_{ci}"]
                slot.b[2 * ci] = _check_field(b_re, shape, "B re").data_ptr()
                slot.b[2 * ci + 1] = _check_field(b_im, shape,
                                                  "B im").data_ptr()
    return step.pole_table(slots, device)


def _library(storage=(torch.float32,) * 3):
    from ... import _build

    lib = _build.load("fused", step.storage_defines(*storage))
    fn = lib.t3d_fused_step
    if fn.argtypes is None:
        _build.check_struct(lib, "t3d_fused_params_size", FusedParams)
        _build.check_struct(lib, "t3d_fused_pole_slot_size", PoleSlot)
        step.check_storage(lib, "t3d_fused_storage", storage)
        fn.argtypes = [ctypes.POINTER(FusedParams), ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def resources(num_poles: int, bulk: bool,
              storage=(torch.float32,) * 3) -> dict:
    """Threads, shared bytes, blocks per SM and registers of the bulk or
    shell (pair-aligned arrays) instantiation for ``num_poles`` pole slots
    in the library of the storage types ``(field, psi, q)`` (the CUDA
    occupancy calculator); needs the card."""
    from ... import _build

    _library(storage)
    fn = _build.load("fused", step.storage_defines(*storage)).t3d_fused_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int32 * 4)()
    err = fn(num_poles, int(bulk), out)
    if err:
        raise RuntimeError(f"fused resources: CUDA error {err}")
    return dict(zip(("threads", "shared_bytes", "blocks_per_sm",
                     "registers"), out))


def occupancy(storage=(torch.float32,) * 3, num_poles: int = 1,
              bulk: bool = True) -> int:
    """Blocks per SM of one instantiation (``resources``)."""
    return resources(num_poles, bulk, storage)["blocks_per_sm"]


def prepare(device, storage=(torch.float32,) * 3) -> None:
    """Build and load the kernel library of the storage types ``(field,
    psi, q)`` for ``device`` (a no-op on the CPU); the runner times this as
    its compile step."""
    if torch.device(device).type == "cuda":
        _library(storage)


def _source_box(sl, shape):
    """``(lo, hi)`` of a unit-step slice triple inside ``shape``."""
    lo, hi = [], []
    for a, s in enumerate(sl):
        start, stop, stride = s.indices(shape[a])
        if stride != 1:
            raise ValueError(f"source slice {s} has a step")
        lo.append(start)
        hi.append(max(stop, start))
    return lo, hi


# the last call's blocks (bulk and shell launches) and device launches
LAST_BLOCKS = (0, 0, 0)


def _fused_step_cuda(state, consts, meta, sources, q_out=None):
    global LAUNCHES, DEVICE_LAUNCHES, LAST_BLOCKS, MANY_POLES_LAUNCHES
    shape = tuple(meta.shape)
    device = state["E"][E_COMPS[0]].device
    if len(sources) > MAX_SOURCES:
        raise ValueError(f"{len(sources)} source terms: the kernel takes at "
                         f"most {MAX_SOURCES}")
    if shape[0] * shape[1] * shape[2] >= 2 ** 31:
        raise ValueError(f"grid {shape}: the fused kernel takes fewer than "
                         "2^31 cells")
    storage = storage_of(state)
    p = FusedParams()
    for a in range(3):
        p.n[a] = shape[a]
        for arr, kind in ((p.bk_lo, meta.boundaries[a][0]),
                          (p.bk_hi, meta.boundaries[a][1])):
            if kind not in step._WALL:
                raise ValueError(f"unsupported boundary kind '{kind}'")
            arr[a] = step._WALL[kind]
        p.pec_lo[a] = int(meta.boundaries[a][0] == "pec")
        # the cells whose E and H updates meet no psi slab and no wall
        w_e, w_h = meta.pml_meta[("dual", a)], meta.pml_meta[("primal", a)]
        p.bulk_lo[a] = max(1, w_e[0], w_h[0])
        p.bulk_hi[a] = min(shape[a] - 1, shape[a] - w_e[1], shape[a] - w_h[1])

    new_e, new_h = {}, {}
    for fam, comps, old, new, out in (("E", E_COMPS, p.e_old, p.e_new, new_e),
                                      ("H", H_COMPS, p.h_old, p.h_new, new_h)):
        for i, comp in enumerate(comps):
            old[i] = _check_field(state[fam][comp], shape, comp,
                                  storage[0]).data_ptr()
            out[comp] = torch.empty(shape, dtype=storage[0], device=device)
            new[i] = out[comp].data_ptr()

    new_psi = dict(state["psi"])
    for fam in ("E", "H"):
        new_psi.update(step.set_family_params(fam, state, consts, meta, {
            name: getattr(p, f"{name}_{fam.lower()}")
            for name in step.FAMILY_FIELDS}, psi_dtype=storage[1]))
    if q_out is None:
        q_out = [{c: (torch.empty_like(qr), torch.empty_like(qi))
                  for c, (qr, qi) in Qp.items()} for Qp in state["Q"]]
    q_in = {t.data_ptr() for Qp in state["Q"] for pair in Qp.values()
            for t in pair}
    if any(t.data_ptr() in q_in for Qp in q_out for pair in Qp.values()
           for t in pair):
        raise ValueError("fused_step: q_out shares memory with the state's "
                         "pole currents (neighbouring blocks read Q while "
                         "Q' is stored)")
    table = None
    if len(state["Q"]) > MAX_POLES:
        # every slot from a device table (the MANY instantiations)
        table = pole_table(state, q_out, consts, shape, storage[2], device)
        p.num_poles = len(state["Q"])
        p.poles = table.data_ptr()
    else:
        step.set_pole_update_params(p, state, q_out, consts, shape,
                                    storage[2])

    p.num_src = len(sources)
    for s, (comp, sl, term, w) in enumerate(sources):
        lo, hi = _source_box(sl, shape)
        box = tuple(h - l for l, h in zip(lo, hi))
        box_src = p.src[s]
        box_src.term = _check_field(term, box, f"source {s}").data_ptr()
        box_src.comp = E_COMPS.index(comp)
        for a in range(3):
            box_src.lo[a] = lo[a]
            box_src.hi[a] = hi[a]
        box_src.w = float(w)

    blocks = step.launch_counted(_library(storage), p, device, "fused_step")
    del table
    LAUNCHES += 1
    MANY_POLES_LAUNCHES += len(state["Q"]) > MAX_POLES
    DEVICE_LAUNCHES += blocks[2]
    LAST_BLOCKS = blocks
    return new_e, new_h, new_psi, q_out


def fused_step(state: dict, consts: dict, meta: StepMeta,
               sources: List[Source], q_out: list = None):
    """One leapfrog step with the pole update: the CUDA kernel for CUDA
    tensors (Q' into ``q_out`` where given), the plain version for CPU
    tensors (new tensors). Returns ``(new_E, new_H, new_psi, new_Q)``."""
    device = state["E"][E_COMPS[0]].device
    if device.type == "cpu":
        return fused_step_reference(state, consts, meta, sources)
    if device.type != "cuda":
        raise ValueError(f"fused_step: unsupported device '{device}'")
    return _fused_step_cuda(state, consts, meta, sources, q_out)
