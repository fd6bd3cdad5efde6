"""The work of a solve, counted from the simulation's shapes alone.

The roofline readers (``metrics/roofline_pct.*.py``) count each kernel's
bytes and operations from what this returns: the grid, the CPML slabs, the
copies of a Bloch run and the cells of each dispersive medium with its pole
slots, all from the plain reference's problem, never from the sizes of the
tensors the solver under test allocates. Storage is float32 in every cell.
"""

from __future__ import annotations

import numpy as np

from ..reference import yee

F32 = 4
# operations per cell and step: per component two differences, two
# scalings, one subtraction and the update (ca E + cb curl)
OPS_YEE_COMP = 8
OPS_PSI = 4        # b psi + c d, and its add to the curl
OPS_POLE = 11      # Q' = A Q + B (E' + E), complex A and B
OPS_POLE_TERM = 2  # Re(G Q) subtracted in the E update


def describe(pb: "yee.Problem") -> dict:
    """The shapes a solve of ``pb`` works on: ``cells``, ``copies`` (2 for
    a Bloch run), ``psi_cells`` (cells of the CPML slabs, the layers plus
    one plane, summed over the slabs), ``lossy`` (a medium with
    conductivity or poles: ca varies too), ``media``: ``[(slots,
    cells)]`` per dispersive structure, and ``num_steps``."""
    grid = yee.Grid(pb)
    shape = grid.shape
    cells = int(np.prod(shape))
    psi_cells = 0
    for axis in range(3):
        for n in pb.absorb[axis]:
            if n:
                psi_cells += (n + 1) * cells // shape[axis]
    media, lossy = [], False
    for box, mat in pb.structures:
        _, sigma, poles = mat.static()
        lossy |= bool(sigma) or bool(poles)
        if poles:
            lo, hi = box.bounds
            inside = [int(np.count_nonzero((c >= lo[a]) & (c <= hi[a])))
                      for a, c in enumerate(grid.centers)]
            media.append((len(poles), int(np.prod(inside))))
    copies = 2 if any(v is not None and v % 1.0 != 0 for v in pb.bloch) \
        else 1
    return dict(shape=shape, cells=cells, copies=copies, psi_cells=psi_cells,
                lossy=lossy, media=media, num_steps=len(grid.tmesh))


def coef_bytes(w) -> int:
    """The E update's coefficients: cb per E component, ca too where
    media are lossy; the H update's are scalars."""
    return w["cells"] * F32 * (6 if w["lossy"] else 3)


def pole_values(w) -> int:
    """Pole-current values of one copy: slots x cells x 3 components."""
    return sum(slots * cells * 3 for slots, cells in w["media"])


def whole_step(w) -> tuple:
    """``(bytes, ops)`` of one whole step of every copy (both half-steps,
    the CPML, the poles), reading each input and writing each output
    once."""
    c = w["copies"]
    nbytes = (c * w["cells"] * 12 * F32 + coef_bytes(w)
              + c * w["psi_cells"] * 4 * 2 * F32
              + c * pole_values(w) * 2 * 2 * F32)
    ops = c * (6 * OPS_YEE_COMP * w["cells"]
               + 4 * OPS_PSI * w["psi_cells"]
               + (OPS_POLE + OPS_POLE_TERM) * pole_values(w))
    return nbytes, ops


def least_seconds(nbytes, ops, peaks) -> float:
    """The least time the card could take: bytes at its bandwidth or
    operations at its float32 rate, whichever is longer."""
    return max(nbytes / peaks["bytes_per_s"], ops / peaks["f32_ops_per_s"])
