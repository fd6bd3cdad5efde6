"""Unstructured grid datasets (triangular / tetrahedral).

Behavioral model: /root/reference/tidy3d/components/data/dataset.py
(UnstructuredGridDataset:524, TriangularGridDataset:1986,
TetrahedralGridDataset:2568). The reference leans on vtk for slicing and
interpolation; here the operations are implemented directly in numpy
(matplotlib trifinder for 2D point location, centroid-KD-tree + barycentric
test for 3D), so the datasets work without optional native dependencies.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import pydantic

from ...exceptions import DataError, ValidationError
from ..base import Tidy3dBaseModel, cached_property
from ..types import Axis
# the registered DataArray zoo provides the point/cell/value array types
# (shared with reference-file HDF5 decoding, which resolves the type-name
# tags through DATA_ARRAY_MAP — duplicating the classes here would make
# decoded arrays fail the pydantic instance checks)
from .data_array import (  # noqa: F401  (re-exported)
    CellDataArray,
    DataArray,
    IndexedDataArray,
    PointDataArray,
    SpatialDataArray,
)


class UnstructuredGridDataset(Tidy3dBaseModel):
    """Base for unstructured grid data: points, cells, point values."""

    points: PointDataArray = pydantic.Field(..., title="Grid points")
    values: IndexedDataArray = pydantic.Field(..., title="Point values")
    cells: CellDataArray = pydantic.Field(..., title="Cell connectivity")

    @pydantic.model_validator(mode="after")
    def _counts_match(self):
        if len(self.values.values) != self.points.values.shape[0]:
            raise ValidationError(
                f"number of values ({len(self.values.values)}) does not match "
                f"number of points ({self.points.values.shape[0]})")
        if np.any(np.asarray(self.cells.values) >= self.points.values.shape[0]):
            raise ValidationError("cell connectivity references missing points")
        return self

    @property
    def name(self) -> str:
        return getattr(self.values, "name", None)

    @property
    def is_complex(self) -> bool:
        return np.iscomplexobj(self.values.values)

    def __add__(self, other):
        return self._with_values(self.values.values + self._vals_of(other))

    def __sub__(self, other):
        return self._with_values(self.values.values - self._vals_of(other))

    def __mul__(self, other):
        return self._with_values(self.values.values * self._vals_of(other))

    __rmul__ = __mul__

    def _vals_of(self, other):
        if isinstance(other, UnstructuredGridDataset):
            return other.values.values
        return other

    def _with_values(self, new_vals: np.ndarray):
        return self.copy(update=dict(values=IndexedDataArray(
            new_vals, coords=dict(index=np.arange(len(new_vals))))))

    @property
    def bounds(self) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
        pts = np.asarray(self.points.values)
        return tuple(pts.min(axis=0)), tuple(pts.max(axis=0))


class TriangularGridDataset(UnstructuredGridDataset):
    """2D triangular grid in a plane normal to `normal_axis`."""

    normal_axis: Axis = pydantic.Field(..., title="Normal axis")
    normal_pos: float = pydantic.Field(..., title="Plane position")

    @cached_property
    def _triangulation(self):
        from matplotlib.tri import Triangulation

        pts = np.asarray(self.points.values, dtype=float)
        cells = np.asarray(self.cells.values, dtype=int)
        return Triangulation(pts[:, 0], pts[:, 1], triangles=cells)

    def interp(self, x=None, y=None, z=None, fill_value: float = 0.0
               ) -> SpatialDataArray:
        """Interpolate onto a Cartesian grid (linear barycentric)."""
        from matplotlib.tri import LinearTriInterpolator

        coords = {"x": x, "y": y, "z": z}
        dims_plane = [d for i, d in enumerate("xyz") if i != self.normal_axis]
        u = np.atleast_1d(np.asarray(coords[dims_plane[0]], dtype=float))
        v = np.atleast_1d(np.asarray(coords[dims_plane[1]], dtype=float))
        uu, vv = np.meshgrid(u, v, indexing="ij")
        vals = np.asarray(self.values.values)

        def interp_real(comp):
            f = LinearTriInterpolator(self._triangulation, comp)
            out = np.asarray(f(uu, vv))
            return np.where(np.isfinite(out), out, fill_value)

        if self.is_complex:
            data2d = interp_real(vals.real) + 1j * interp_real(vals.imag)
        else:
            data2d = interp_real(vals.astype(float))

        n_dim = "xyz"[self.normal_axis]
        n_vals = np.atleast_1d(np.asarray(
            coords[n_dim] if coords[n_dim] is not None else [self.normal_pos],
            dtype=float))
        shape = [0, 0, 0]
        shape["xyz".index(dims_plane[0])] = len(u)
        shape["xyz".index(dims_plane[1])] = len(v)
        shape[self.normal_axis] = len(n_vals)
        data = np.broadcast_to(
            np.expand_dims(data2d, self.normal_axis), shape).copy()
        out_coords = {dims_plane[0]: u, dims_plane[1]: v, n_dim: n_vals}
        return SpatialDataArray(
            data, coords={d: out_coords[d] for d in "xyz"})

    def sel(self, **kwargs):
        return self.interp(**kwargs)

    @property
    def _values_coordinate_shape(self):
        return (self.points.values.shape[0],)

    def plot(self, ax=None, **kwargs):
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        vals = np.real(np.asarray(self.values.values))
        tpc = ax.tripcolor(self._triangulation, vals, **kwargs)
        plt.colorbar(tpc, ax=ax)
        dims_plane = [d for i, d in enumerate("xyz") if i != self.normal_axis]
        ax.set_xlabel(dims_plane[0])
        ax.set_ylabel(dims_plane[1])
        return ax


class TetrahedralGridDataset(UnstructuredGridDataset):
    """3D tetrahedral grid dataset."""

    @cached_property
    def _centroid_tree(self):
        from scipy.spatial import cKDTree

        pts = np.asarray(self.points.values, dtype=float)
        cells = np.asarray(self.cells.values, dtype=int)
        centroids = pts[cells].mean(axis=1)
        return cKDTree(centroids)

    def _locate(self, query: np.ndarray, k: int = 16):
        """(cell_index, barycentric) for each query point; -1 if outside."""
        pts = np.asarray(self.points.values, dtype=float)
        cells = np.asarray(self.cells.values, dtype=int)
        k = min(k, len(cells))
        _, cand = self._centroid_tree.query(query, k=k)
        cand = np.atleast_2d(cand)
        nq = len(query)
        found = -np.ones(nq, dtype=int)
        bary = np.zeros((nq, 4))
        remaining = np.arange(nq)
        for ki in range(cand.shape[1]):
            if len(remaining) == 0:
                break
            ci = cand[remaining, ki]
            tets = pts[cells[ci]]  # (nr, 4, 3)
            v0 = tets[:, 0]
            T = np.stack([tets[:, 1] - v0, tets[:, 2] - v0, tets[:, 3] - v0],
                         axis=-1)  # (nr, 3, 3)
            rhs = query[remaining] - v0
            det = np.linalg.det(T)
            ok = np.abs(det) > 1e-300
            lam = np.zeros((len(remaining), 3))
            lam[ok] = np.linalg.solve(T[ok], rhs[ok][..., None])[..., 0]
            l0 = 1.0 - lam.sum(axis=1)
            all_bary = np.column_stack([l0, lam])
            inside = ok & np.all(all_bary > -1e-9, axis=1)
            hit = remaining[inside]
            found[hit] = ci[inside]
            bary[hit] = all_bary[inside]
            remaining = remaining[~inside]
        return found, bary

    def interp(self, x=None, y=None, z=None, fill_value: float = 0.0
               ) -> SpatialDataArray:
        xs = np.atleast_1d(np.asarray(x, dtype=float))
        ys = np.atleast_1d(np.asarray(y, dtype=float))
        zs = np.atleast_1d(np.asarray(z, dtype=float))
        xg, yg, zg = np.meshgrid(xs, ys, zs, indexing="ij")
        query = np.column_stack([xg.ravel(), yg.ravel(), zg.ravel()])
        cells = np.asarray(self.cells.values, dtype=int)
        vals = np.asarray(self.values.values)
        ci, bary = self._locate(query)
        out = np.full(len(query), fill_value, dtype=vals.dtype)
        hit = ci >= 0
        if np.any(hit):
            vert_vals = vals[cells[ci[hit]]]  # (nh, 4)
            out[hit] = np.einsum("nk,nk->n", bary[hit], vert_vals)
        return SpatialDataArray(out.reshape(len(xs), len(ys), len(zs)),
                                coords=dict(x=xs, y=ys, z=zs))

    def plane_slice(self, axis: Axis, pos: float) -> TriangularGridDataset:
        """Slice with an axis-aligned plane -> triangular dataset.

        Each tetrahedron crossing the plane contributes its polygonal
        cross-section (triangle or quad, fan-triangulated); values are
        linearly interpolated onto the new points."""
        pts = np.asarray(self.points.values, dtype=float)
        cells = np.asarray(self.cells.values, dtype=int)
        vals = np.asarray(self.values.values)
        d = pts[:, axis] - pos
        new_pts = []
        new_vals = []
        new_cells = []
        edge_cache = {}
        b_ax, c_ax = [i for i in range(3) if i != axis]

        def edge_point(i, j):
            key = (min(i, j), max(i, j))
            if key in edge_cache:
                return edge_cache[key]
            t = d[i] / (d[i] - d[j])
            p = pts[i] + t * (pts[j] - pts[i])
            v = vals[i] + t * (vals[j] - vals[i])
            idx = len(new_pts)
            new_pts.append([p[b_ax], p[c_ax]])
            new_vals.append(v)
            edge_cache[key] = idx
            return idx

        for cell in cells:
            below = [i for i in cell if d[i] < 0]
            above = [i for i in cell if d[i] >= 0]
            if not below or not above:
                continue
            poly = [edge_point(i, j) for i in below for j in above]
            if len(poly) < 3:
                continue
            # order the polygon points by angle around their centroid
            pp = np.asarray([new_pts[i] for i in poly])
            ctr = pp.mean(axis=0)
            order = np.argsort(np.arctan2(pp[:, 1] - ctr[1], pp[:, 0] - ctr[0]))
            poly = [poly[int(o)] for o in order]
            for t_i in range(1, len(poly) - 1):
                new_cells.append([poly[0], poly[t_i], poly[t_i + 1]])

        if not new_cells:
            raise DataError("plane does not intersect the tetrahedral grid")
        new_pts = np.asarray(new_pts)
        new_vals = np.asarray(new_vals)
        return TriangularGridDataset(
            normal_axis=axis, normal_pos=pos,
            points=PointDataArray(new_pts, coords=dict(
                index=np.arange(len(new_pts)), axis=np.arange(2))),
            values=IndexedDataArray(new_vals, coords=dict(
                index=np.arange(len(new_vals)))),
            cells=CellDataArray(np.asarray(new_cells), coords=dict(
                cell_index=np.arange(len(new_cells)),
                vertex_index=np.arange(3))),
        )

    def sel(self, x=None, y=None, z=None):
        """Select a plane (one of x/y/z fixed) -> TriangularGridDataset."""
        fixed = [(i, v) for i, v in enumerate((x, y, z)) if v is not None
                 and np.ndim(v) == 0]
        if len(fixed) != 1:
            raise DataError("sel on a tetrahedral dataset needs exactly one "
                            "scalar coordinate")
        axis, pos = fixed[0]
        return self.plane_slice(axis, float(pos))
