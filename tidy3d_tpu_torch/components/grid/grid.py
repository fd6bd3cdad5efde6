"""Yee grid containers: Coords, FieldGrid, YeeGrid, Grid.

Behavioral model: /root/reference/tidy3d/components/grid/grid.py (Grid:301,
Coords:21, YeeGrid:262). Staggering convention (grid.py:465-492): the E_w
component sits at cell centers along w and cell-min boundaries along the other
axes; H_w is dual (centers transverse, boundary along w).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import pydantic

from ...exceptions import SetupError
from ..base import Tidy3dBaseModel, cached_property
from ..types import ArrayFloat1D, Axis

# (imported lazily to avoid cycles) Box type used in discretize_inds


class Coords(Tidy3dBaseModel):
    """Holds 1D coordinate arrays along x, y, z."""

    x: ArrayFloat1D = pydantic.Field(..., title="X Coords")
    y: ArrayFloat1D = pydantic.Field(..., title="Y Coords")
    z: ArrayFloat1D = pydantic.Field(..., title="Z Coords")

    @property
    def to_dict(self):
        return {"x": np.asarray(self.x), "y": np.asarray(self.y), "z": np.asarray(self.z)}

    @property
    def to_list(self):
        return [np.asarray(self.x), np.asarray(self.y), np.asarray(self.z)]

    def spatial_interp(self, array, interp_method: str = "linear", fill_value=None):
        """Interpolate a SpatialDataArray-like onto these coords."""
        return array.interp(
            x=np.asarray(self.x), y=np.asarray(self.y), z=np.asarray(self.z),
            method=interp_method, kwargs=dict(fill_value=fill_value),
        )


class FieldGrid(Tidy3dBaseModel):
    """Coordinates of a single vector field's components."""

    x: Coords = pydantic.Field(..., title="X Positions")
    y: Coords = pydantic.Field(..., title="Y Positions")
    z: Coords = pydantic.Field(..., title="Z Positions")


class YeeGrid(Tidy3dBaseModel):
    """Coordinates of all E and H components on the Yee lattice."""

    E: FieldGrid = pydantic.Field(..., title="E Field Grid")
    H: FieldGrid = pydantic.Field(..., title="H Field Grid")

    @property
    def grid_dict(self):
        return {
            "Ex": self.E.x, "Ey": self.E.y, "Ez": self.E.z,
            "Hx": self.H.x, "Hy": self.H.y, "Hz": self.H.z,
        }


class Grid(Tidy3dBaseModel):
    """The FDTD Yee grid defined by cell boundary coordinates per axis."""

    boundaries: Coords = pydantic.Field(
        ..., title="Boundary Coords", description="Cell boundary coordinates along x, y, z."
    )

    @staticmethod
    def _avg(coords1d: np.ndarray) -> np.ndarray:
        return (np.asarray(coords1d)[1:] + np.asarray(coords1d)[:-1]) / 2.0

    @staticmethod
    def _min(coords1d: np.ndarray) -> np.ndarray:
        return np.asarray(coords1d)[:-1]

    @cached_property
    def centers(self) -> Coords:
        return Coords(**{k: self._avg(v) for k, v in self.boundaries.to_dict.items()})

    @cached_property
    def sizes(self) -> Coords:
        return Coords(**{k: np.diff(np.asarray(v)) for k, v in self.boundaries.to_dict.items()})

    @cached_property
    def num_cells(self) -> Tuple[int, int, int]:
        return tuple(len(np.asarray(v)) - 1 for v in self.boundaries.to_list)

    @property
    def info(self) -> str:
        nx, ny, nz = self.num_cells
        return f"Grid({nx} x {ny} x {nz} = {nx * ny * nz} cells)"

    @cached_property
    def yee(self) -> YeeGrid:
        yee_e = FieldGrid(**{key: self._yee_e(axis) for axis, key in enumerate("xyz")})
        yee_h = FieldGrid(**{key: self._yee_h(axis) for axis, key in enumerate("xyz")})
        return YeeGrid(E=yee_e, H=yee_h)

    def _yee_e(self, axis: Axis) -> Coords:
        coords = {k: self._min(v) for k, v in self.boundaries.to_dict.items()}
        key = "xyz"[axis]
        coords[key] = self._avg(self.boundaries.to_dict[key])
        return Coords(**coords)

    def _yee_h(self, axis: Axis) -> Coords:
        coords = {k: self._avg(v) for k, v in self.boundaries.to_dict.items()}
        key = "xyz"[axis]
        coords[key] = self._min(self.boundaries.to_dict[key])
        return Coords(**coords)

    def __getitem__(self, coord_key: str) -> Coords:
        coord_dict = {
            "centers": self.centers,
            "sizes": self.sizes,
            "boundaries": self.boundaries,
            **self.yee.grid_dict,
        }
        if coord_key not in coord_dict:
            raise SetupError(f"key {coord_key} not found in grid keys {list(coord_dict)}")
        return coord_dict[coord_key]

    def discretize_inds(self, box, extend: bool = False) -> List[Tuple[int, int]]:
        """(start, stop) cell index ranges intersecting a Box, per axis.

        With ``extend=True``, one extra cell is included on each side (used to
        capture fields needed for interpolation/colocation at box edges)."""
        pts_min, pts_max = box.bounds
        inds = []
        for axis, (pt_min, pt_max) in enumerate(zip(pts_min, pts_max)):
            bound_coords = np.asarray(self.boundaries.to_list[axis])
            n_cells = len(bound_coords) - 1
            # index of first boundary strictly greater than pt_min, minus one
            ind_min = int(np.searchsorted(bound_coords, pt_min, side="right") - 1)
            ind_max = int(np.searchsorted(bound_coords, pt_max, side="left"))
            ind_min = max(ind_min, 0)
            ind_max = min(ind_max, n_cells)
            if ind_max <= ind_min:
                ind_max = ind_min + 1
            if extend:
                ind_min = max(ind_min - 1, 0)
                ind_max = min(ind_max + 1, n_cells)
            inds.append((ind_min, ind_max))
        return inds

    def extended_subspace(self, axis: Axis, ind_beg: int = 0, ind_end: int = 0,
                          periodic: bool = True) -> np.ndarray:
        """Boundary coords along axis extended (periodically or uniformly) to
        the index range [ind_beg, ind_end)."""
        coords = np.asarray(self.boundaries.to_list[axis])
        n = len(coords) - 1
        span = coords[-1] - coords[0]
        out = []
        for ind in range(ind_beg, ind_end):
            if 0 <= ind <= n:
                out.append(coords[ind])
            elif ind < 0:
                if periodic:
                    k = int(np.ceil(-ind / n))
                    out.append(coords[(ind + k * n) % (n + 1)] - k * span)
                else:
                    out.append(coords[0] + ind * (coords[1] - coords[0]))
            else:
                if periodic:
                    k = (ind - 1) // n
                    out.append(coords[ind - k * n] + k * span)
                else:
                    out.append(coords[-1] + (ind - n) * (coords[-1] - coords[-2]))
        return np.asarray(out)

    def snap_to_box_zero_dim(self, box) -> "Grid":
        """For size-zero dims of box, collapse the grid to two boundaries
        snapped around the box position."""
        boundaries = self.boundaries.to_dict
        new = {}
        for axis, dim in enumerate("xyz"):
            if box.size[axis] == 0.0:
                center = box.center[axis]
                new[dim] = np.array([center, center])
            else:
                new[dim] = boundaries[dim]
        return Grid(boundaries=Coords(**new))

    @cached_property
    def _primal_steps(self) -> Coords:
        """Cell sizes (primal grid steps)."""
        return self.sizes

    @cached_property
    def _dual_steps(self) -> Coords:
        """Distances between cell centers, with the boundary steps wrapping."""
        out = {}
        for dim, bounds in self.boundaries.to_dict.items():
            centers = self._avg(bounds)
            if len(centers) > 1:
                dual = np.diff(centers)
                dual = np.concatenate([[dual[0]], dual, [dual[-1]]])
            else:
                dual = np.array([bounds[-1] - bounds[0]] * 2)
            out[dim] = dual
        return Coords(**out)
