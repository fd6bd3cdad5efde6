"""Triangle-mesh (STL) geometry.

Behavioral model: /root/reference/tidy3d/components/geometry/mesh.py
(TriangleMesh:26, trimesh-backed). trimesh is unavailable here, so this module
implements native STL parsing (binary + ascii) and a vectorized ray-casting
``inside`` predicate, which is all the rasterizer needs.
"""

from __future__ import annotations

import struct
from typing import Any, List, Optional, Tuple

import numpy as np
import pydantic

from ...exceptions import FileError, ValidationError
from ...log import log
from ..base import Tidy3dBaseModel, cached_property
from ..types import ArrayFloat2D, ArrayFloat3D, Bound
from . import base

# chunk size (in query points) for the point-in-mesh test to bound memory
_RAYCAST_CHUNK = 4096


class TriangleMesh(base.Geometry):
    """Surface mesh geometry defined by triangles (N, 3, 3)."""

    triangles: Optional[ArrayFloat3D] = pydantic.Field(
        None, title="Triangles",
        description="(N, 3, 3) array: N triangles x 3 vertices x (x, y, z).",
    )
    mesh_dataset: Optional[Any] = pydantic.Field(
        None, title="Surface mesh data (reference-compat)",
        description="Reference serialization layout (mesh.py:36): a "
        "TriangleMeshDataset dict whose 'surface_mesh' is a "
        "TriangleMeshDataArray with dims (face_index, vertex_index, axis). "
        "Converted to 'triangles' on load; a data-less placeholder loads "
        "as an empty mesh with a warning (reference mesh.py:50-57).",
    )

    @pydantic.model_validator(mode="before")
    @classmethod
    def _from_mesh_dataset(cls, values):
        if not isinstance(values, dict):
            return values
        md = values.get("mesh_dataset")
        if values.get("triangles") is None and md is not None:
            sm = md.get("surface_mesh") if isinstance(md, dict) \
                else getattr(md, "surface_mesh", None)
            if isinstance(sm, str):
                log.warning("Loading 'mesh_dataset' without data.")
                values = dict(values, mesh_dataset=None)
            elif sm is not None:
                vals = np.asarray(getattr(sm, "values", sm), dtype=float)
                values = dict(values, triangles=vals, mesh_dataset=None)
        return values

    @pydantic.field_validator("triangles")
    @classmethod
    def _check_triangles(cls, val):
        if val is None:
            return val
        arr = np.asarray(val, dtype=float)
        if arr.ndim != 3 or arr.shape[1:] != (3, 3):
            raise ValidationError("triangles must be an (N, 3, 3) array")
        return arr

    def _require_triangles(self) -> np.ndarray:
        if self.triangles is None:
            raise ValidationError(
                "This TriangleMesh was loaded without mesh data "
                "(reference files store mesh data only in '.hdf5'); "
                "geometry operations are unavailable.")
        return np.asarray(self.triangles)

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #

    @classmethod
    def from_vertices_faces(cls, vertices: np.ndarray, faces: np.ndarray) -> "TriangleMesh":
        vertices = np.asarray(vertices, dtype=float)
        faces = np.asarray(faces, dtype=int)
        return cls(triangles=vertices[faces])

    @classmethod
    def from_stl(cls, filename: str, scale: float = 1.0,
                 origin: Tuple[float, float, float] = (0, 0, 0),
                 solid_index: int = None, **kwargs) -> "TriangleMesh":
        """Load from an STL file (binary or ascii)."""
        tris = _read_stl(filename)
        tris = tris * scale + np.asarray(origin)
        return cls(triangles=tris, **kwargs)

    # ------------------------------------------------------------------ #
    # geometry interface
    # ------------------------------------------------------------------ #

    @cached_property
    def bounds(self) -> Bound:
        if self.triangles is None:
            # reference mesh.py:324: a data-less mesh is unbounded
            big = 1e30
            return (-big, -big, -big), (big, big, big)
        arr = np.asarray(self.triangles)
        mins = arr.reshape(-1, 3).min(axis=0)
        maxs = arr.reshape(-1, 3).max(axis=0)
        return tuple(mins), tuple(maxs)

    def inside(self, x, y, z) -> np.ndarray:
        """Ray casting along +z with even-odd counting (watertight assumed)."""
        x, y, z = np.broadcast_arrays(np.asarray(x, float), np.asarray(y, float),
                                      np.asarray(z, float))
        shape = x.shape
        pts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=-1)
        out = np.zeros(len(pts), dtype=bool)
        if self.triangles is None:
            return out.reshape(shape)
        tris = np.asarray(self.triangles)
        v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
        for start in range(0, len(pts), _RAYCAST_CHUNK):
            chunk = pts[start:start + _RAYCAST_CHUNK]
            out[start:start + _RAYCAST_CHUNK] = _points_in_mesh_z(chunk, v0, v1, v2)
        return out.reshape(shape)

    def volume(self, bounds: Bound = None) -> float:
        if bounds is not None:
            return super().volume(bounds)
        tris = self._require_triangles()
        v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
        return float(abs(np.sum(np.einsum("ij,ij->i", v0, np.cross(v1, v2))) / 6.0))

    def surface_area(self, bounds: Bound = None) -> float:
        tris = self._require_triangles()
        cross = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        return float(0.5 * np.sum(np.linalg.norm(cross, axis=-1)))

    def _intersections_normal_axis(self, axis: int, position: float):
        """Mesh-plane cross-section: triangle/plane segments stitched
        into closed loops (reference uses trimesh.section, mesh.py:377;
        a data-less mesh has no cross-sections, :377-378)."""
        from .utils import PlanarPolygon

        if self.triangles is None:
            return []
        tris = np.asarray(self.triangles)
        d = tris[..., axis] - position  # (N, 3) signed vertex distances
        plane_dims = [i for i in range(3) if i != axis]
        segs: List[Tuple[Tuple[float, float], Tuple[float, float]]] = []
        crossing = (d.min(axis=1) < 0) & (d.max(axis=1) > 0)
        for tri, dv in zip(tris[crossing], d[crossing]):
            pts = []
            for i in range(3):
                j = (i + 1) % 3
                di, dj = dv[i], dv[j]
                if (di < 0) != (dj < 0):
                    t = di / (di - dj)
                    p = tri[i] + t * (tri[j] - tri[i])
                    pts.append((p[plane_dims[0]], p[plane_dims[1]]))
            if len(pts) == 2:
                segs.append((pts[0], pts[1]))
        if not segs:
            return []
        # stitch segments into loops by snapped-endpoint adjacency
        scale = max(np.ptp([p for s in segs for p in s], axis=0).max(), 1.0)
        tol = 1e-9 * scale

        def key(p):
            return (round(p[0] / tol), round(p[1] / tol))

        adj: dict = {}
        for si, (a, b) in enumerate(segs):
            adj.setdefault(key(a), []).append((si, b))
            adj.setdefault(key(b), []).append((si, a))
        used = set()
        loops = []
        for si, (a, b) in enumerate(segs):
            if si in used:
                continue
            used.add(si)
            loop = [a, b]
            while True:
                cur = loop[-1]
                nxt = None
                for sj, other in adj.get(key(cur), ()):
                    if sj not in used:
                        used.add(sj)
                        nxt = other
                        break
                if nxt is None or key(nxt) == key(loop[0]):
                    break
                loop.append(nxt)
            if len(loop) >= 3:
                loops.append(np.asarray(loop, dtype=float))
        return [PlanarPolygon(loop) for loop in loops]

    @cached_property
    def trimesh(self):
        raise ImportError("trimesh is not available in tidy3d_tpu; TriangleMesh "
                          "is backed by a native ray-casting implementation.")


# --------------------------------------------------------------------------- #
# STL parsing and ray casting
# --------------------------------------------------------------------------- #


def _read_stl(filename: str) -> np.ndarray:
    with open(filename, "rb") as f:
        header = f.read(84)
        if len(header) < 84:
            return _read_stl_ascii(filename)
        # ascii files start with 'solid'; binary ones usually don't but can —
        # verify via the triangle count implied file size
        n_tri = struct.unpack("<I", header[80:84])[0]
        f.seek(0, 2)
        fsize = f.tell()
        if fsize == 84 + n_tri * 50:
            f.seek(84)
            data = np.frombuffer(f.read(n_tri * 50), dtype=np.uint8)
            rec = data.reshape(n_tri, 50)
            floats = rec[:, :48].copy().view(np.float32).reshape(n_tri, 12)
            return floats[:, 3:12].reshape(n_tri, 3, 3).astype(float)
    return _read_stl_ascii(filename)


def _read_stl_ascii(filename: str) -> np.ndarray:
    verts: List[List[float]] = []
    with open(filename, encoding="utf-8", errors="ignore") as f:
        for line in f:
            parts = line.split()
            if len(parts) == 4 and parts[0].lower() == "vertex":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    if len(verts) == 0 or len(verts) % 3:
        raise FileError(f"Could not parse STL file {filename}")
    arr = np.asarray(verts, dtype=float)
    return arr.reshape(-1, 3, 3)


def _points_in_mesh_z(pts: np.ndarray, v0, v1, v2) -> np.ndarray:
    """Even-odd test casting rays along +z. pts: (P, 3); v*: (T, 3).

    Query points are nudged by a tiny irrational offset so rays avoid hitting
    shared triangle edges exactly (grid points regularly align with mesh
    edges during rasterization, which would double-count crossings)."""
    scale = max(float(np.max(np.abs(pts))) if pts.size else 1.0, 1.0)
    px = pts[:, 0:1] + 1.3721e-9 * scale
    py = pts[:, 1:2] + 2.7183e-9 * scale
    pz = pts[:, 2:3]
    # 2D barycentric test in (x, y)
    x0, y0 = v0[:, 0], v0[:, 1]
    x1, y1 = v1[:, 0], v1[:, 1]
    x2, y2 = v2[:, 0], v2[:, 1]
    denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    denom = np.where(np.abs(denom) < 1e-300, 1e-300, denom)
    w0 = ((y1 - y2) * (px - x2) + (x2 - x1) * (py - y2)) / denom
    w1 = ((y2 - y0) * (px - x2) + (x0 - x2) * (py - y2)) / denom
    w2 = 1.0 - w0 - w1
    hits = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    # z of the triangle plane at the (x, y) of the point
    tz = w0 * v0[:, 2] + w1 * v1[:, 2] + w2 * v2[:, 2]
    above = hits & (tz >= pz)
    return np.sum(above, axis=-1) % 2 == 1
