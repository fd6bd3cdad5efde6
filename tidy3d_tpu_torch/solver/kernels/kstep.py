"""The k-step (temporal-blocked) group update: the counterpart of
``pallas_kstep.py``.

``kstep_group(state, consts, meta, tables, t0, k, out)`` advances the
fields, the CPML psi and the pole currents by k whole leapfrog steps,
``t0`` to ``t0 + k - 1``. Each substep is what the XLA step
``tidy3d_tpu.solver.fdtd.FDTDRunner._step`` computes: the E half-step
(curl H, psi of all three axes, the pole term, the PEC lo walls), the J
sources, the pole update ``Q' = A Q + B (E' + E)``, the H half-step and
the M sources. It returns the new ``{"E", "H", "psi", "Q"}`` and leaves
``state`` untouched.

``tables`` (``SourceTables``) holds the source boxes of both families, with
``-cb * profile`` folded into each box's term, and the waveform table
padded to the run's length; a substep at step t adds ``term * w[key, t]``.

A complex (Bloch) run steps two real copies of the fields, re and im
(``E``, ``H``, ``psi`` and ``E1``, ``H1``, ``psi1``). They mix only where a
stencil wraps across an axis with a Bloch phase (``StepMeta.bloch``) and in
the sources: each term is complex, ``term + i term_im`` driven by ``w[key]
+ i w[key_im]`` (``SourceTerm``), and adds its real part to copy 0 and its
imaginary part to copy 1.

Storage (``step.STORAGE``): the fields, the psi slabs and the pole
currents are each float32 or bfloat16 (``FDTDRunner`` takes the JAX
package's knobs). Both versions widen them to float32, step the k substeps
in float32 and round the fields and the pole currents once, at the group's
store; the x and y psi round after every substep and the z psi at the
store, as the JAX package's single-region kernel holds them
(``pallas_kstep.py:1769,2100-2130,2386,2590-2620``). The kernel is built
once per combination (``step.storage_defines``), at its first use.

Dispatch is by device: a CPU tensor goes to ``kstep_group_reference``, the
k substeps written from the one-step functions the port already has; a
CUDA tensor launches the hand-written kernel in ``csrc/kstep.cu`` or
raises. The kernel reads the state set and writes the ``out`` set (the
runner's ping-pong buffers, allocated once), so nothing is updated in
place. ``LAUNCHES`` counts the groups the kernel stepped.

A group is up to two device launches (``DEVICE_LAUNCHES`` counts them),
one per non-empty block list: the *bulk* blocks, whose dependency cone
meets no psi slab, no wall and no wrap, run an instantiation without that
code; the *shell* blocks run the general one. The second launch is a
programmatic dependent launch on the same stream, which fills the SMs the
first one's last wave leaves idle; its blocks count themselves in a word
of device memory that each stream has to itself. ``block_lists``
classifies the blocks of a layout once (cached) and hands each launch its
list of block ids.

The kernel is built for k = 2 only (``KS``); the plain version takes any
k. The rule and its reason: the kernel recomputes a halo of k - 1 and k
cells around each block's owned core at every level, so its arithmetic
per cell-step grows with k (1.49x of one step at k = 2, 2.77x at k = 4)
and so does the per-thread state that limits its warps per SM, while the
device-memory bytes it saves are not what bounds it. On the H100 a k = 4
build was slower on every case measured: 384^3 broadband 8.2 against 2.8
ms per step at k = 2, 384^3 with one Lorentz pole 12.7 against 4.9
(PERF.md). The runner tries k as the JAX package does (4, then 2, under
``TIDY3D_TPU_KSTEP=auto``), so a k this kernel is not built for is
refused here and k = 2 runs. The JAX package's TPU kernel, bound by HBM,
takes k = 4.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..lowering import E_COMPS, H_COMPS

from . import fused, step
from .fused import _source_box
from .step import MAX_POLES, StepMeta, _check_field

LAUNCHES = 0                 # groups stepped by the kernel
SHARDED_LAUNCHES = 0         # the shard-local ones among LAUNCHES
DEVICE_LAUNCHES = 0          # kernel launches: bulk and shell, per group
KS = (2,)                    # group sizes the kernel is built for (K)
MAX_SOURCES = 64             # source boxes per family (a TFSF box: 12)
SRC_INTS = 12                # ints per box row (csrc/kstep.cu SRC_INTS)
COPIES = ("E", "H", "psi"), ("E1", "H1", "psi1")   # state keys per copy

# the kernel's geometry (csrc/kstep.cu TY, TZ, BX, HALO_LO, HALO_HI; all
# checked against the library's report when it loads): TILE_Y rows and
# TILE_Z columns of y-z columns, SLAB_X owned x planes per block, and a
# cone that reaches k - 1 cells past the owned box on the lo side of every
# axis and k on the hi side
TILE_Y, TILE_Z, SLAB_X = 16, 32, 32


def cone_halo(k: int) -> Tuple[int, int]:
    """The cells a block computes past its owned box on each axis, ``(lo,
    hi)``: E at level j needs H at level j - 1 one cell lower, H at level j
    needs E at level j one cell higher."""
    return k - 1, k


def unsupported_reason(k: int, num_sources: Dict[str, int]
                       ) -> Optional[str]:
    """Why the kernel does not take a run at group size ``k`` with
    ``num_sources[family]`` source terms, or None if it does (it takes up
    to ``MAX_POLES`` pole slots)."""
    if k not in KS:
        return f"group size {k} (the kernel is built for {KS})"
    for fam, n in num_sources.items():
        if n > MAX_SOURCES:
            return (f"{n} {fam}-side source terms (the table takes "
                    f"{MAX_SOURCES})")
    return None


class SourceTerm(NamedTuple):
    """One source box: ``term * w[key]``, plus ``i term_im`` and ``i
    w[key_im]`` in a complex run (None where absent)."""

    comp: str
    slices: Tuple[slice, slice, slice]
    term: torch.Tensor
    key: int
    term_im: Optional[torch.Tensor] = None
    key_im: Optional[int] = None


def group_source_plans(sources, is_complex: bool
                       ) -> List[Tuple[int, Optional[int]]]:
    """``(i_re, i_im)`` index pairs of the plan's source list (``i_im`` None
    for a single plan), as ``pallas_kstep.py:1050-1066`` groups them: in a
    complex run lowering splits a complex profile into a (re, im) plan pair
    that shares comp and slices, the im plan's ``waveform_key_im`` being the
    re plan's ``waveform_key``; such a pair becomes one complex term."""
    groups, si, n = [], 0, len(sources)
    while si < n:
        sp = sources[si]
        if is_complex and si + 1 < n:
            nxt = sources[si + 1]
            if nxt.comp == sp.comp and nxt.slices == sp.slices \
                    and nxt.waveform_key_im == sp.waveform_key:
                groups.append((si, si + 1))
                si += 2
                continue
        groups.append((si, None))
        si += 1
    return groups


class SourceTables:
    """The source terms of both families for a whole run, on ``device``.

    ``sources[family]`` lists the ``SourceTerm`` of each box as
    ``FDTDRunner._build_sources`` builds them. For the kernel: one int32
    row of ``SRC_INTS`` per box and family (component, lo, hi, offset of
    the term in the packed term buffer, waveform row, and the same two for
    the imaginary part or -1), the packed terms, and the waveform table
    (``set_waveforms``, re-set when the runner pads it), all built once.

    A shard's tables (``shard_sources``) hold slices in its padded x
    planes, ``shape`` being the padded shape; ``x_origin`` (its halo
    width) takes the kernel's boxes to local planes."""

    def __init__(self, sources: dict, waveforms: np.ndarray, shape,
                 device, x_origin: int = 0):
        self.device = torch.device(device)
        self.shape = tuple(shape)
        self.x_origin = x_origin
        self.sources = {fam: list(sources.get(fam, [])) for fam in "EH"}
        self._views = {}
        self.boxes, terms, off = {}, [], 0

        def pack(term):
            nonlocal off
            if term is None:
                return -1
            terms.append(term.reshape(-1).to(torch.float32))
            off += term.numel()
            return off - term.numel()

        for fam, comps in (("E", E_COMPS), ("H", H_COMPS)):
            rows = []
            for s in self.sources[fam]:
                lo, hi = _source_box(s.slices, self.shape)
                box = tuple(h - l for l, h in zip(lo, hi))
                for t in (s.term, s.term_im):
                    if t is not None and tuple(t.shape) != box:
                        raise ValueError(f"source term of {s.comp}: shape "
                                         f"{tuple(t.shape)} for box {lo}-{hi}")
                lo[0] -= x_origin
                hi[0] -= x_origin
                rows.append([comps.index(s.comp), *lo, *hi, pack(s.term),
                             int(s.key), pack(s.term_im),
                             -1 if s.key_im is None else int(s.key_im), 0])
            self.boxes[fam] = torch.tensor(
                rows, dtype=torch.int32, device=self.device).reshape(
                    -1, SRC_INTS)
        if off >= 2 ** 31:
            raise ValueError("source terms exceed 2^31 values")
        self.terms = torch.cat(terms).contiguous() if terms else \
            torch.zeros(1, dtype=torch.float32, device=self.device)
        self.set_waveforms(waveforms)

    def set_waveforms(self, waveforms: np.ndarray) -> None:
        """The (rows, steps) float32 waveform table, host and device."""
        self.waveforms = np.ascontiguousarray(waveforms, np.float32)
        self.wf = torch.from_numpy(self.waveforms).to(self.device)

    def view(self, start: int, stop: int) -> "SourceTables":
        """The tables of planes ``[start, stop)`` of a shard's padded x
        range, as an unsharded run of those planes sees them (cached)."""
        if (start, stop) not in self._views:
            shape = (stop - start,) + self.shape[1:]
            self._views[(start, stop)] = SourceTables(
                {fam: clip_sources_x(terms, self.shape, -start, shape[0])
                 for fam, terms in self.sources.items()},
                self.waveforms, shape, self.device)
        return self._views[(start, stop)]

    def _w(self, key, t) -> float:
        return 0.0 if key is None else float(self.waveforms[key, t])

    def at(self, family: str, t: int) -> list:
        """``(comp, slices, term, w)`` of each source term of a real run at
        step t."""
        return [(s.comp, s.slices, s.term, self._w(s.key, t))
                for s in self.sources[family]]

    def copy_adds(self, family: str, t: int) -> list:
        """``(comp, slices, add0, add1)`` of each source term of a complex
        run at step t: the real and imaginary parts of ``(term + i term_im)
        (w[key] + i w[key_im])``, which copies 0 and 1 add
        (``pallas_kstep.py:1047-1049``)."""
        out = []
        for s in self.sources[family]:
            wr, wi = self._w(s.key, t), self._w(s.key_im, t)
            add0, add1 = s.term * wr, s.term * wi
            if s.term_im is not None:
                add0 = add0 - s.term_im * wi
                add1 = add1 + s.term_im * wr
            out.append((s.comp, s.slices, add0, add1))
        return out


def clip_sources_x(sources: list, shape, shift: int, nx: int) -> list:
    """The ``SourceTerm`` boxes of a frame of ``shape`` moved by ``shift``
    planes along x and clipped to the new frame's ``[0, nx)``, their terms
    clipped with them; boxes left empty are dropped."""
    out = []
    for s in sources:
        lo, hi = _source_box(s.slices, shape)
        a, b = max(lo[0] + shift, 0), min(hi[0] + shift, nx)
        if a >= b:
            continue
        cut = slice(a - lo[0] - shift, b - lo[0] - shift)
        out.append(s._replace(
            slices=(slice(a, b),) + tuple(s.slices[1:]), term=s.term[cut],
            term_im=None if s.term_im is None else s.term_im[cut]))
    return out


def shard_sources(sources: list, shape, x0: int, padded: int, pad: int,
                  periodic: bool) -> list:
    """The ``SourceTerm`` boxes (global slices of a grid of ``shape``) that
    reach a shard owning global planes ``[x0, x0 + padded - 2 pad)``, in its
    padded x planes. Every shard whose padded range a box reaches gets it,
    not only its owner: halo cells are recomputed below level k and need
    the source terms too. On a periodic x the halo planes past an edge
    are those of the other side, so each box is also given shifted by one
    period each way."""
    out = []
    for m in ((-1, 0, 1) if periodic else (0,)):
        out += clip_sources_x(sources, shape, pad - x0 + m * shape[0],
                              padded)
    return out


# --------------------------------------------------------------------------- #
# the plain PyTorch version
# --------------------------------------------------------------------------- #


def kstep_group_reference(state: dict, consts: dict, meta: StepMeta,
                          tables: SourceTables, t0: int, k: int,
                          out: dict = None) -> dict:
    """Plain PyTorch group on any device: k substeps, each the fused
    step's plain version with the J sources and the pole update (on the
    float32 E'), then the M sources, in the order of the substep loop of
    ``pallas_kstep.py``, in float32; the x and y psi round to their
    storage type after each substep, and everything to its storage type at
    the end (``_stored``).
    A complex run (``"E1"`` in ``state``) takes the two-copy substep of
    ``_bloch_substep``. A shard of a sharded run (``meta.xpad``) takes
    ``_shard_group``. ``out`` is accepted for the kernel's signature and
    not used."""
    if meta.xpad:
        return _shard_group(state, consts, meta, tables, t0, k)
    copies = COPIES[:1 + ("E1" in state)]
    storage = step.storage_of(state, copies)
    cur = {key: {c: step.f32(v) for c, v in state[key].items()}
           for pair in copies for key in pair}
    cur["Q"] = [{c: (step.f32(qr).clone(), step.f32(qi).clone())
                 for c, (qr, qi) in Qp.items()} for Qp in state["Q"]]
    for t in range(t0, t0 + k):
        if len(copies) == 2:
            cur = dict(_bloch_substep(cur, consts, meta, tables, t), Q=[])
        else:
            new_e, new_h, psi, new_q = fused.fused_step_reference(
                cur, consts, meta, tables.at("E", t), store=False)
            for comp, sl, term, w in tables.at("H", t):
                new_h[comp][sl].add_(term * w)
            cur = {"E": new_e, "H": new_h, "psi": psi, "Q": new_q}
        for _, _, p in copies:
            cur[p] = {key: v if key.split("|")[1] == "2" else
                      v.to(storage[1]).float() for key, v in cur[p].items()}
    return _stored(cur, storage, copies)


def _stored(cur: dict, storage, copies) -> dict:
    """A group's float32 state rounded to the storage types ``(field, psi,
    q)``."""
    out = {"Q": [{c: (qr.to(storage[2]), qi.to(storage[2]))
                  for c, (qr, qi) in Qp.items()} for Qp in cur["Q"]]}
    for e, h, p in copies:
        out[e] = {c: v.to(storage[0]) for c, v in cur[e].items()}
        out[h] = {c: v.to(storage[0]) for c, v in cur[h].items()}
        out[p] = {key: v.to(storage[1]) for key, v in cur[p].items()}
    return out


def _x_cut(v, start: int, stop: int, nx: int):
    """Planes ``[start, stop)`` of a tensor that spans the ``nx`` padded x
    planes (a view); anything else (a scalar, a vector along y or z, an x
    psi slab) as it is."""
    if isinstance(v, torch.Tensor) and v.dim() == 3 and v.shape[0] == nx:
        return v[start:stop]
    return v


def _shard_group(state: dict, consts: dict, meta: StepMeta,
                 tables: SourceTables, t0: int, k: int) -> dict:
    """A shard's group, from the XLA semantics on its padded view: the
    unsharded plain group on the planes the shard sees, which are its
    owned planes plus the halo planes of each side that reads its halo.
    There the view's edge is no wall and is given a periodic column: its
    errors travel one plane per half-step, so after k steps they stay
    inside the k halo planes. A side without halo is the global x edge,
    with its wall and its CPML. The owned planes of the result replace
    those of a copy of the input; its halo planes keep the input's."""
    K, nl = meta.xpad, meta.shape[0]
    if k > K:
        raise ValueError(f"a shard with {K} halo planes per side steps at "
                         f"most {K} steps per group, not {k}")
    nx = nl + 2 * K
    start = 0 if meta.x_halo[0] else K
    stop = nx if meta.x_halo[1] else K + nl

    def cut(v):
        return _x_cut(v, start, stop, nx)

    view = {fam: {c: cut(v) for c, v in state[fam].items()}
            for fam in ("E", "H", "psi")}
    view["Q"] = [{c: (cut(qr), cut(qi)) for c, (qr, qi) in Qp.items()}
                 for Qp in state["Q"]]
    vconsts = dict(consts)
    for key in ("coeffs_E", "coeffs_H"):
        vconsts[key] = {c: (cut(a), cut(b)) for c, (a, b) in
                        consts[key].items()}
    for key in ("inv_dual", "inv_primal"):
        vconsts[key] = [cut(consts[key][0])] + list(consts[key][1:])
    vconsts["wall_masks"] = {c: [cut(m) for m in ms]
                             for c, ms in consts["wall_masks"].items()}
    vconsts["pole_masks"] = [cut(m) for m in consts["pole_masks"]]
    vconsts["pole_B_dense"] = {key: (cut(re), cut(im)) for key, (re, im)
                               in consts["pole_B_dense"].items()}
    (lo, hi), rest = meta.boundaries[0], tuple(meta.boundaries[1:])
    vmeta = StepMeta(
        shape=(stop - start,) + tuple(meta.shape[1:]),
        boundaries=(("periodic" if meta.x_halo[0] else lo,
                     "periodic" if meta.x_halo[1] else hi),) + rest,
        pml_meta=meta.pml_meta, bloch=meta.bloch)
    new = kstep_group_reference(view, vconsts, vmeta,
                                tables.view(start, stop), t0, k)

    def owned(old, v):
        if not (v.dim() == 3 and old.shape[0] == nx):
            return v
        out = old.clone()
        out[K:K + nl] = v[K - start:K - start + nl]
        return out

    return {
        **{fam: {c: owned(state[fam][c], v) for c, v in new[fam].items()}
           for fam in ("E", "H", "psi")},
        "Q": [{c: (owned(qo[0], qr), owned(qo[1], qi))
               for (c, (qr, qi)), qo in zip(Qp.items(), Qo.values())}
              for Qp, Qo in zip(new["Q"], state["Q"])]}


def _bloch_substep(cur: dict, consts: dict, meta: StepMeta,
                   tables: SourceTables, t: int) -> dict:
    """One step of both copies of a complex run, as the XLA step
    ``FDTDRunner._step`` takes it (``tidy3d_tpu/solver/fdtd.py:1614-1723``):
    each copy's E from its own H and, across a Bloch wrap, the other copy's
    H; the J sources; each copy's H from its E' and the other copy's E';
    the M sources; in float32 (nothing is rounded to a storage type)."""
    views = [{"E": cur[e], "H": cur[h], "psi": cur[p], "Q": []}
             for e, h, p in COPIES]
    new_e, psi = [], [dict(v["psi"]) for v in views]
    for c, view in enumerate(views):
        ne, pe = step.family_update_reference(
            "E", view, consts, view["H"], meta, partner=views[1 - c]["H"],
            part=c, store=False)
        new_e.append(ne)
        psi[c].update(pe)
    for comp, sl, *adds in tables.copy_adds("E", t):
        for c in range(2):
            new_e[c][comp][sl].add_(adds[c])
    new_h = []
    for c, view in enumerate(views):
        nh, ph = step.family_update_reference(
            "H", view, consts, new_e[c], meta, partner=new_e[1 - c], part=c,
            store=False)
        new_h.append(nh)
        psi[c].update(ph)
    for comp, sl, *adds in tables.copy_adds("H", t):
        for c in range(2):
            new_h[c][comp][sl].add_(adds[c])
    return {key: val for c, (e, h, p) in enumerate(COPIES)
            for key, val in ((e, new_e[c]), (h, new_h[c]), (p, psi[c]))}


# --------------------------------------------------------------------------- #
# bulk and shell blocks
# --------------------------------------------------------------------------- #


def bulk_bounds(meta: StepMeta, k: int):
    """``(lo, hi)`` per axis: the cells in ``[lo, hi)`` on every axis are
    the bulk, whose E and H updates meet no psi slab and no wall (so no
    wrap either). A shard's x side that reads its halo has no wall: its k
    halo planes count."""
    lo, hi = [], []
    for a in range(3):
        n = meta.shape[a]
        halo = meta.x_halo if a == 0 else (False, False)
        w_e, w_h = meta.pml_meta[("dual", a)], meta.pml_meta[("primal", a)]
        lo.append(-k if halo[0] else max(1, w_e[0], w_h[0]))
        hi.append(n + k if halo[1] else min(n - 1, n - w_e[1], n - w_h[1]))
    return lo, hi


def owned_widths(k: int) -> Tuple[int, int, int]:
    """The owned box of a block: ``SLAB_X`` planes, and the tile less its
    cone's halo in y and z."""
    halo = sum(cone_halo(k))
    return SLAB_X, TILE_Y - halo, TILE_Z - halo


def grid_blocks(shape, k: int, ncopy: int = 1):
    """The kernel's grid of blocks for an interior ``shape``: ``(gx, gy,
    gz)`` owned boxes (``owned_widths``; x slabs times ``ncopy``: a complex
    run's copies each get their own blocks). A block's id is its index in
    that grid, z fastest."""
    ox, oy, oz = owned_widths(k)
    return (-(-shape[0] // ox) * ncopy, -(-shape[1] // oy),
            -(-shape[2] // oz))


def block_cones(shape, k: int):
    """Each block's dependency cone per axis, ``[lo, hi)`` arrays over its
    slab, row and column index: the owned box grown by ``cone_halo(k)``
    (in y and z the whole tile, which the kernel computes even past the
    domain's hi end)."""
    h_lo, h_hi = cone_halo(k)
    cones = []
    for a, (g, o) in enumerate(zip(grid_blocks(shape, k), owned_widths(k))):
        lo = np.arange(g) * o
        hi = np.minimum(lo + o, shape[0]) if a == 0 else lo + o
        cones.append((lo - h_lo, hi + h_hi))
    return cones


def classify_blocks(meta: StepMeta, k: int, ncopy: int = 1):
    """``(bulk, shell)``: int32 arrays of the block ids of a layout, bulk
    where the whole cone lies in the bulk (``bulk_bounds``) on every axis,
    shell elsewhere. Each block is in exactly one."""
    lo, hi = bulk_bounds(meta, k)
    inside = [(c_lo >= lo[a]) & (c_hi <= hi[a])
              for a, (c_lo, c_hi) in enumerate(block_cones(meta.shape, k))]
    bulk = inside[0][:, None, None] & inside[1][None, :, None] \
        & inside[2][None, None, :]
    bulk = np.concatenate([bulk] * ncopy).reshape(-1)
    ids = np.arange(bulk.size, dtype=np.int32)
    return ids[bulk], ids[~bulk]


_BLOCK_LISTS: dict = {}
_DONE_WORDS: dict = {}


def block_lists(meta: StepMeta, k: int, ncopy: int, device):
    """``classify_blocks`` as int32 tensors on ``device``, built once per
    layout (shape, walls, psi slabs, halo sides, copies) and device."""
    key = (tuple(meta.shape), tuple(map(tuple, meta.boundaries)),
           tuple(sorted(meta.pml_meta.items())), tuple(meta.x_halo), k,
           ncopy, str(device))
    if key not in _BLOCK_LISTS:
        _BLOCK_LISTS[key] = tuple(
            torch.from_numpy(ids).to(device)
            for ids in classify_blocks(meta, k, ncopy))
    return _BLOCK_LISTS[key]


def done_word(stream: torch.cuda.Stream) -> torch.Tensor:
    """The zeroed int32 word in which the second launch of a group counts
    its finished blocks, one per stream: a stream's groups run one after
    another and the launch's last block zeroes it again, while groups on
    two streams may run at once."""
    key = (stream.device, stream.cuda_stream)
    if key not in _DONE_WORDS:
        with torch.cuda.stream(stream):
            _DONE_WORDS[key] = torch.zeros(1, dtype=torch.int32,
                                           device=stream.device)
    return _DONE_WORDS[key]


# --------------------------------------------------------------------------- #
# the CUDA kernel (csrc/kstep.cu) through ctypes
# --------------------------------------------------------------------------- #

_P3 = ctypes.c_void_p * 3
_P3x2 = _P3 * 2                      # [copy][comp]
_P12x2 = (ctypes.c_void_p * 12) * 2  # [copy][psi slot]
_I3 = ctypes.c_int32 * 3
_F3 = ctypes.c_float * 3
_NQ = 6 * MAX_POLES


class KStepParams(ctypes.Structure):
    """Mirror of ``struct KStepParams`` in ``csrc/kstep.cu``."""

    _fields_ = [
        ("e_old", _P3x2), ("h_old", _P3x2), ("e_new", _P3x2),
        ("h_new", _P3x2),
        ("ca_e", _P3), ("cb_e", _P3), ("ca_h", _P3), ("cb_h", _P3),
        ("inv_e", _P3), ("inv_h", _P3),
        ("psi_in_e", _P12x2), ("psi_out_e", _P12x2),
        ("psi_in_h", _P12x2), ("psi_out_h", _P12x2),
        ("pml_b_e", ctypes.c_void_p * 6), ("pml_c_e", ctypes.c_void_p * 6),
        ("pml_b_h", ctypes.c_void_p * 6), ("pml_c_h", ctypes.c_void_p * 6),
        ("q", ctypes.c_void_p * _NQ), ("q_out", ctypes.c_void_p * _NQ),
        ("pole_b", ctypes.c_void_p * _NQ),
        ("src_box", ctypes.c_void_p * 2), ("src_term", ctypes.c_void_p),
        ("wf", ctypes.c_void_p),
        ("ca_s_e", ctypes.c_float * 3), ("cb_s_e", ctypes.c_float * 3),
        ("ca_s_h", ctypes.c_float * 3), ("cb_s_h", ctypes.c_float * 3),
        ("a_re", ctypes.c_float * MAX_POLES),
        ("a_im", ctypes.c_float * MAX_POLES),
        ("gc_re", ctypes.c_float * MAX_POLES),
        ("gc_im", ctypes.c_float * MAX_POLES),
        ("pole_b0", ctypes.c_float * _NQ),
        ("bloch_c", _F3), ("bloch_s", _F3),
        ("pole_kind", ctypes.c_int32 * (3 * MAX_POLES)),
        ("n", _I3),
        ("w_e", ctypes.c_int32 * 6), ("w_h", ctypes.c_int32 * 6),
        ("bk_lo", _I3), ("bk_hi", _I3), ("pec_lo", _I3),
        ("bulk_lo", _I3), ("bulk_hi", _I3),
        ("num_poles", ctypes.c_int32), ("num_src", ctypes.c_int32 * 2),
        ("wf_len", ctypes.c_int32), ("t0", ctypes.c_int32),
        ("k", ctypes.c_int32), ("ncopy", ctypes.c_int32),
        ("xpad", ctypes.c_int32), ("x_halo", ctypes.c_int32 * 2),
        ("pair_async", ctypes.c_int32),
    ]


def _library(storage=(torch.float32,) * 3):
    from ... import _build

    lib = _build.load("kstep", step.storage_defines(*storage))
    fn = lib.t3d_kstep_group
    if fn.argtypes is None:
        _build.check_struct(lib, "t3d_kstep_params_size", KStepParams)
        step.check_storage(lib, "t3d_kstep_storage", storage)
        tile = (ctypes.c_int32 * 7)()
        lib.t3d_kstep_tile.argtypes = [ctypes.c_void_p]
        lib.t3d_kstep_tile.restype = None
        lib.t3d_kstep_tile(tile)
        ox, oy, oz = owned_widths(KS[0])
        want = (TILE_Y, TILE_Z, ox, oy, oz) + cone_halo(KS[0])
        if tuple(tile) != want:
            raise RuntimeError(f"csrc/kstep.cu geometry {tuple(tile)}, "
                               f"kstep.py {want} (tile, owned box, halo)")
        lib.t3d_kstep_occupancy.argtypes = [ctypes.c_int] * 3
        lib.t3d_kstep_occupancy.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(KStepParams), ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def occupancy(num_poles: int, bloch: bool, bulk: bool,
              storage=(torch.float32,) * 3) -> int:
    """Blocks per SM of one instantiation of the kernel, in the library of
    the storage types ``(field, psi, q)`` (the CUDA occupancy calculator);
    needs the card."""
    blocks = _library(storage).t3d_kstep_occupancy(num_poles, int(bloch),
                                                   int(bulk))
    if blocks < 0:
        raise RuntimeError(f"kstep occupancy: CUDA error {-blocks}")
    return blocks


def prepare(device, storage=(torch.float32,) * 3) -> None:
    """Build and load the kernel library of the storage types ``(field,
    psi, q)`` for ``device`` (a no-op on the CPU); the runner times this as
    its compile step."""
    if torch.device(device).type == "cuda":
        _library(storage)


def _kstep_group_cuda(state, consts, meta, tables, t0, k, out):
    global LAUNCHES, SHARDED_LAUNCHES, DEVICE_LAUNCHES
    shape = meta.array_shape
    device = state["E"][E_COMPS[0]].device
    copies = COPIES[:1 + ("E1" in state)]
    storage = step.storage_of(state, copies)
    reason = unsupported_reason(k, {
        fam: int(boxes.shape[0]) for fam, boxes in tables.boxes.items()})
    if reason is not None:
        raise ValueError(f"kstep_group: the kernel does not take {reason}")
    if len(copies) == 2 and state["Q"]:
        raise ValueError("kstep_group: the kernel takes no pole currents in "
                         "a complex (Bloch) run")
    if meta.xpad not in (0, k) or (any(meta.x_halo) and not meta.xpad):
        raise ValueError(f"kstep_group: {meta.xpad} halo planes for k = {k}")
    if meta.xpad and len(copies) == 2:
        raise ValueError("kstep_group: a complex (Bloch) run is not "
                         "sharded")
    if shape[0] * shape[1] * shape[2] >= 2 ** 31:
        raise ValueError(f"grid {shape}: the k-step kernel takes fewer "
                         "than 2^31 cells")
    if not 0 <= t0 or t0 + k > tables.wf.shape[1]:
        raise ValueError(f"steps {t0}..{t0 + k - 1} lie past the waveform "
                         f"table ({tables.wf.shape[1]} steps)")
    if out is None:
        out = {key: {c: torch.empty_like(v) for c, v in state[key].items()}
               for pair in copies for key in pair}
        out["Q"] = [{c: (torch.empty_like(qr), torch.empty_like(qi))
                     for c, (qr, qi) in Qp.items()} for Qp in state["Q"]]
    p = KStepParams()
    p.ncopy = len(copies)
    p.xpad = meta.xpad
    p.x_halo[0], p.x_halo[1] = (int(h) for h in meta.x_halo)
    bulk_lo, bulk_hi = bulk_bounds(meta, k)
    for a in range(3):
        n = meta.shape[a]
        p.n[a] = n
        lo, hi = meta.boundaries[a]
        for arr, kind in ((p.bk_lo, lo), (p.bk_hi, hi)):
            if kind not in step._WALL:
                raise ValueError(f"unsupported boundary kind '{kind}'")
            arr[a] = step._WALL[kind]
        if (lo == "periodic") != (hi == "periodic"):
            raise ValueError(f"axis {a}: periodic on one side only")
        # a shard's x side that reads its halo meets no wall
        halo = meta.x_halo if a == 0 else (False, False)
        p.pec_lo[a] = int(lo == "pec" and not halo[0])
        # the cells whose E and H updates meet no psi slab and no wall
        p.bulk_lo[a], p.bulk_hi[a] = bulk_lo[a], bulk_hi[a]
        w_e, w_h = meta.pml_meta[("dual", a)], meta.pml_meta[("primal", a)]
        # a virtual cell past a Bloch wall is the rotated real cell only
        # where every coefficient is periodic along the axis
        cs = meta.bloch[a] if len(copies) == 2 else None
        if cs is not None and (lo != "periodic" or any(w_e + w_h)):
            raise ValueError(f"axis {a}: a Bloch phase needs a periodic "
                             "axis without psi slabs")
        p.bloch_c[a], p.bloch_s[a] = cs if cs is not None else (1.0, 0.0)

    new_psi = []
    for c, (e, h, pk) in enumerate(copies):
        for fam, comps, old, new in ((e, E_COMPS, p.e_old, p.e_new),
                                     (h, H_COMPS, p.h_old, p.h_new)):
            for i, comp in enumerate(comps):
                src = _check_field(state[fam][comp], shape, f"{fam} {comp}",
                                   storage[0])
                dst = _check_field(out[fam][comp], shape,
                                   f"out {fam} {comp}", storage[0])
                if src.data_ptr() == dst.data_ptr():
                    raise ValueError(f"{fam} {comp}: the output set aliases "
                                     "the input")
                old[c][i] = src.data_ptr()
                new[c][i] = dst.data_ptr()
        psi = {}
        for fam in ("E", "H"):
            arrays = {name: getattr(p, f"{name}_{fam.lower()}")
                      for name in step.FAMILY_FIELDS}
            arrays["psi_in"] = arrays["psi_in"][c]
            arrays["psi_out"] = arrays["psi_out"][c]
            psi.update(step.set_family_params(
                fam, {"psi": state[pk]}, consts, meta, arrays,
                psi_out=out[pk], psi_dtype=storage[1]))
        new_psi.append(psi)
    step.set_pole_update_params(p, state, out["Q"], consts, shape,
                                storage[2])

    for f, fam in enumerate("EH"):
        boxes = tables.boxes[fam]
        if boxes.device != device or tables.terms.device != device:
            raise ValueError("source tables on another device")
        p.num_src[f] = boxes.shape[0]
        p.src_box[f] = boxes.data_ptr() if boxes.shape[0] else None
    # bf16 level 0 is staged in 4-byte pairs along z (bulk blocks): by
    # cp.async where every pair is 4-byte aligned
    p.pair_async = int(shape[2] % 2 == 0 and all(
        ptr % 4 == 0 for arr in (p.e_old, p.h_old) for c in range(len(copies))
        for ptr in arr[c]))
    p.src_term = tables.terms.data_ptr()
    p.wf = tables.wf.data_ptr()
    p.wf_len = tables.wf.shape[1]
    p.t0 = t0
    p.k = k

    bulk, shell = block_lists(meta, k, len(copies), device)
    stream = torch.cuda.current_stream(device)
    with torch.cuda.device(device):
        err = _library(storage).t3d_kstep_group(
            ctypes.byref(p), bulk.data_ptr(), bulk.numel(),
            shell.data_ptr(), shell.numel(), done_word(stream).data_ptr(),
            ctypes.c_void_p(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(f"kstep_group kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    SHARDED_LAUNCHES += bool(meta.xpad)
    DEVICE_LAUNCHES += bool(bulk.numel()) + bool(shell.numel())
    new = {"Q": list(out["Q"])}
    for (e, h, pk), psi in zip(copies, new_psi):
        new.update({e: dict(out[e]), h: dict(out[h]), pk: psi})
    return new


def kstep_group(state: dict, consts: dict, meta: StepMeta,
                tables: SourceTables, t0: int, k: int,
                out: dict = None) -> dict:
    """k leapfrog steps from step ``t0``: the CUDA kernel for CUDA tensors
    (results written into ``out``'s buffers, allocated when None), the
    plain version for CPU tensors. Returns the new ``{"E", "H", "psi",
    "Q"}``, with ``"E1"``, ``"H1"``, ``"psi1"`` in a complex run."""
    device = state["E"][E_COMPS[0]].device
    if device.type == "cpu":
        return kstep_group_reference(state, consts, meta, tables, t0, k)
    if device.type != "cuda":
        raise ValueError(f"kstep_group: unsupported device '{device}'")
    return _kstep_group_cuda(state, consts, meta, tables, t0, k, out)
