"""Shared helpers for lowering: Yee coordinate/slice bookkeeping."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def yee_coords(grid, comp: str) -> Dict[str, np.ndarray]:
    """1D coordinate arrays of a Yee component over the full grid, with the
    array-shape convention (Nx, Ny, Nz) = num_cells.

    Convention (reference grid.py:465-492): E_w sits at cell centers along w
    and lower cell boundaries transverse; H_w is dual."""
    bounds = {d: np.asarray(v) for d, v in grid.boundaries.to_dict.items()}
    centers = {d: 0.5 * (v[1:] + v[:-1]) for d, v in bounds.items()}
    field = comp[0]
    comp_axis = "xyz".index(comp[1])
    out = {}
    for axis, dim in enumerate("xyz"):
        if (field == "E") == (axis == comp_axis):
            out[dim] = centers[dim]          # E along own axis / H transverse
        else:
            out[dim] = bounds[dim][:-1]      # boundary-located (first N)
    return out


def slices_for_box(grid, box, comp: str, extend: bool = True
                   ) -> Tuple[Tuple[slice, slice, slice], Dict[str, np.ndarray]]:
    """Static slices + coords of a Yee component covering a box."""
    span = grid.discretize_inds(box, extend=extend)
    coords_all = yee_coords(grid, comp)
    slices = []
    coords = {}
    for axis, dim in enumerate("xyz"):
        beg, end = span[axis]
        n = grid.num_cells[axis]
        beg = max(beg, 0)
        end = min(end, n)
        if end <= beg:
            end = beg + 1
        slices.append(slice(beg, end))
        coords[dim] = coords_all[dim][beg:end]
    return tuple(slices), coords
