"""Geometry core: abstract base + Box, Transformed, ClipOperation, GeometryGroup.

Behavioral model: /root/reference/tidy3d/components/geometry/base.py
(Geometry:74, Box:1799, Transformed:2496, ClipOperation:2772,
GeometryGroup:3013). Re-designed without shapely/trimesh: every geometry
exposes a vectorized ``inside`` predicate and an (approximate) signed distance
``sdf``; plane cross-sections return native ``PlanarPolygon`` objects. The SDF
is the TPU-native enabler for subpixel permittivity averaging (volume
fractions + interface normals from one function evaluation).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import pydantic

from ...constants import fp_eps, inf
from ...exceptions import SetupError, ValidationError
from ...log import log
from ..base import Tidy3dBaseModel, cached_property
from ..types import (
    ArrayFloat2D,
    Axis,
    Bound,
    ClipOperationType,
    Coordinate,
    MatrixReal4x4,
    PlanePosition,
    Shapely,
    Size,
    annotate_type,
)
from . import utils as geo_utils
from .utils import PlanarPolygon, pop_axis, unpop_axis
from ..autograd.derivative_utils import quad_weights

E_COMPS_ADJ = ("Ex", "Ey", "Ez")

POLY_GRID_SIZE = 1e-12
# number of sample points per cell side for Monte-Carlo-free volume estimates
_N_SAMPLE_VOLUME = 30


class Geometry(Tidy3dBaseModel, ABC):
    """Abstract base for all geometries."""

    # ------------------------------------------------------------------ #
    # predicates
    # ------------------------------------------------------------------ #

    @abstractmethod
    def inside(self, x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
        """Boolean array: which points (broadcastable x, y, z) are inside."""

    def sdf(self, x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
        """Approximate signed distance (negative inside). Default: derived
        from ``inside`` with zero magnitude (staircase fallback)."""
        ins = self.inside(x, y, z)
        return np.where(ins, -1.0, 1.0)

    def inside_meshgrid(self, x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
        """``inside`` evaluated on the outer product of 1D arrays x, y, z."""
        xs, ys, zs = np.meshgrid(x, y, z, indexing="ij", sparse=True)
        return self.inside(xs, ys, zs)

    # ------------------------------------------------------------------ #
    # bounds
    # ------------------------------------------------------------------ #

    @cached_property
    @abstractmethod
    def bounds(self) -> Bound:
        """((xmin, ymin, zmin), (xmax, ymax, zmax))."""

    @cached_property
    def bounding_box(self) -> "Box":
        return Box.from_bounds(*self.bounds)

    @property
    def zero_dims(self) -> List[Axis]:
        """Axes along which the geometry is flat (zero extent)."""
        rmin, rmax = self.bounds
        return [dim for dim in range(3) if rmax[dim] - rmin[dim] <= fp_eps]

    def intersects(self, other: "Geometry") -> bool:
        """Conservative bounding-box intersection check."""
        s_min, s_max = self.bounds
        o_min, o_max = other.bounds
        return all(s_min[d] <= o_max[d] and s_max[d] >= o_min[d] for d in range(3))

    def intersects_axis_position(self, axis: int, position: float) -> bool:
        return self.bounds[0][axis] <= position <= self.bounds[1][axis]

    def intersects_plane(self, x: float = None, y: float = None, z: float = None) -> bool:
        axis, position = geo_utils.parse_xyz_kwargs(x=x, y=y, z=z)
        return self.intersects_axis_position(axis, position)

    # ------------------------------------------------------------------ #
    # cross sections
    # ------------------------------------------------------------------ #

    def intersections_plane(
        self, x: float = None, y: float = None, z: float = None
    ) -> List[PlanarPolygon]:
        """Cross-section polygons in the plane normal to the given axis. The
        in-plane coordinates are ordered by popping the plane axis."""
        axis, position = geo_utils.parse_xyz_kwargs(x=x, y=y, z=z)
        return self._intersections_normal_axis(axis, position)

    def _intersections_normal_axis(self, axis: int, position: float) -> List[PlanarPolygon]:
        """Default implementation: marching-squares-free polygon approximation
        by sampling ``inside`` on a fine grid and tracing the boundary. Concrete
        primitives override with analytic sections."""
        if not self.intersects_axis_position(axis, position):
            return []
        raise NotImplementedError(
            f"intersections_plane not implemented for {type(self).__name__}"
        )

    # ------------------------------------------------------------------ #
    # measures
    # ------------------------------------------------------------------ #

    def volume(self, bounds: Bound = None) -> float:
        """Volume (clipped to optional bounds), via dense sampling fallback."""
        rmin, rmax = self.bounds
        if bounds is not None:
            rmin = tuple(max(a, b) for a, b in zip(rmin, bounds[0]))
            rmax = tuple(min(a, b) for a, b in zip(rmax, bounds[1]))
        sizes = [max(hi - lo, 0.0) for lo, hi in zip(rmin, rmax)]
        if any(s == 0 for s in sizes):
            return 0.0
        axes = [
            np.linspace(lo + s / (2 * _N_SAMPLE_VOLUME), hi - s / (2 * _N_SAMPLE_VOLUME),
                        _N_SAMPLE_VOLUME)
            for lo, hi, s in zip(rmin, rmax, sizes)
        ]
        frac = float(np.mean(self.inside_meshgrid(*axes)))
        return frac * sizes[0] * sizes[1] * sizes[2]

    def surface_area(self, bounds: Bound = None) -> float:
        raise NotImplementedError(
            f"surface_area not implemented for {type(self).__name__}"
        )

    # ------------------------------------------------------------------ #
    # transforms (return Transformed wrappers)
    # ------------------------------------------------------------------ #

    def translated(self, x: float = 0.0, y: float = 0.0, z: float = 0.0) -> "Transformed":
        return Transformed(geometry=self, transform=Transformed.translation(x, y, z))

    def rotated(self, angle: float, axis: Union[Axis, Coordinate]) -> "Transformed":
        return Transformed(geometry=self, transform=Transformed.rotation(angle, axis))

    def scaled(self, x: float = 1.0, y: float = 1.0, z: float = 1.0) -> "Transformed":
        return Transformed(geometry=self, transform=Transformed.scaling(x, y, z))

    # group algebra
    def __add__(self, other: "Geometry") -> "GeometryGroup":
        mine = list(self.geometries) if isinstance(self, GeometryGroup) else [self]
        theirs = list(other.geometries) if isinstance(other, GeometryGroup) else [other]
        return GeometryGroup(geometries=tuple(mine + theirs))

    __radd__ = __add__

    def __invert__(self) -> "ClipOperation":
        return ClipOperation(
            operation="difference",
            geometry_a=Box(size=(inf, inf, inf)),
            geometry_b=self,
        )

    def __or__(self, other: "Geometry") -> "ClipOperation":
        return ClipOperation(operation="union", geometry_a=self, geometry_b=other)

    def __and__(self, other: "Geometry") -> "ClipOperation":
        return ClipOperation(operation="intersection", geometry_a=self, geometry_b=other)

    def __sub__(self, other: "Geometry") -> "ClipOperation":
        return ClipOperation(operation="difference", geometry_a=self, geometry_b=other)

    def __xor__(self, other: "Geometry") -> "ClipOperation":
        return ClipOperation(
            operation="symmetric_difference", geometry_a=self, geometry_b=other
        )

    # --- helpers re-exported (reference exposes these as staticmethods) ---
    pop_axis = staticmethod(pop_axis)
    unpop_axis = staticmethod(unpop_axis)
    parse_xyz_kwargs = staticmethod(geo_utils.parse_xyz_kwargs)
    car_2_sph = staticmethod(geo_utils.car_2_sph)
    sph_2_car = staticmethod(geo_utils.sph_2_car)
    sph_2_car_field = staticmethod(geo_utils.sph_2_car_field)
    car_2_sph_field = staticmethod(geo_utils.car_2_sph_field)
    kspace_2_sph = staticmethod(geo_utils.kspace_2_sph)

    # plotting (minimal)
    def plot(self, x: float = None, y: float = None, z: float = None, ax=None, **patch_kwargs):
        """Plot cross section of geometry on a matplotlib axis."""
        import matplotlib.pyplot as plt
        from matplotlib.patches import Polygon as MplPolygon

        axis, position = geo_utils.parse_xyz_kwargs(x=x, y=y, z=z)
        if ax is None:
            _, ax = plt.subplots()
        for poly in self.intersections_plane(x=x, y=y, z=z):
            patch = MplPolygon(poly.exterior, closed=True, **{"facecolor": "gray",
                                                              "edgecolor": "k", **patch_kwargs})
            ax.add_patch(patch)
        ax.autoscale_view()
        _, (label1, label2) = pop_axis("xyz", axis)
        ax.set_xlabel(label1)
        ax.set_ylabel(label2)
        ax.set_aspect("equal")
        return ax


class Centered(Geometry, ABC):
    """Geometry with a well-defined center."""

    center: Coordinate = pydantic.Field(
        (0.0, 0.0, 0.0), title="Center", description="Center of object in x, y, z."
    )

    @pydantic.field_validator("center")
    @classmethod
    def _center_not_inf(cls, val):
        if any(np.isinf(v) for v in val):
            raise ValidationError("center can not contain td.inf terms")
        return val


class SimplePlaneIntersection(Geometry, ABC):
    """Mixin marker matching reference hierarchy."""


class Planar(Geometry, ABC):
    """Geometry with a planar cross section extruded along an axis."""

    axis: Axis = pydantic.Field(
        2, title="Axis", description="Axis of extrusion (0=x, 1=y, 2=z)."
    )

    @property
    @abstractmethod
    def center_axis(self) -> float:
        """Position of the center along the extrusion axis."""

    @property
    @abstractmethod
    def length_axis(self) -> float:
        """Extent along the extrusion axis."""


class Circular(Geometry, ABC):
    """Geometry with a radius."""

    radius: pydantic.NonNegativeFloat = pydantic.Field(
        ..., title="Radius", description="Radius of geometry."
    )

    @pydantic.field_validator("radius")
    @classmethod
    def _radius_not_inf(cls, val):
        if np.isinf(val):
            raise ValidationError("radius can not be td.inf")
        return val


class Box(Centered):
    """Rectangular prism (also used for monitor/source/simulation extents).

    Reference: geometry/base.py:1799.
    """

    size: Size = pydantic.Field(
        ..., title="Size", description="Size in x, y, and z directions."
    )

    @classmethod
    def from_bounds(cls, rmin: Coordinate, rmax: Coordinate, **kwargs) -> "Box":
        center = tuple(float(np.mean([lo, hi])) if not (np.isinf(lo) and np.isinf(hi))
                       else 0.0 for lo, hi in zip(rmin, rmax))
        size = tuple(float(hi - lo) for lo, hi in zip(rmin, rmax))
        return cls(center=center, size=size, **kwargs)

    @classmethod
    def surfaces(cls, size: Size, center: Coordinate, **kwargs) -> List["Box"]:
        """The six surface Boxes of a box, named ``{name}_{x,y,z}{-,+}``."""
        if any(s == 0.0 for s in size):
            raise SetupError("Can't generate surfaces for the given object because it has "
                             "zero volume.")
        name = kwargs.pop("name", "")
        surfaces = []
        for axis in range(3):
            if size[axis] >= inf:
                # surfaces infinitely far away are skipped (reference
                # geometry/base.py:1894 "ignore surfaces that are
                # infinitely far away")
                continue
            for sign, tag in zip((-1, 1), ("-", "+")):
                s_center = list(center)
                s_center[axis] += sign * size[axis] / 2
                s_size = list(size)
                s_size[axis] = 0.0
                surf_kwargs = dict(kwargs)
                if name:
                    surf_kwargs["name"] = f"{name}_{'xyz'[axis]}{tag}"
                surfaces.append(cls(center=tuple(s_center), size=tuple(s_size), **surf_kwargs))
        return surfaces

    @classmethod
    def surfaces_with_exclusion(cls, size: Size, center: Coordinate, **kwargs) -> List["Box"]:
        exclude_surfaces = kwargs.pop("exclude_surfaces", None) or []
        surfaces = cls.surfaces(size=size, center=center, **kwargs)
        if exclude_surfaces and "name" in kwargs:
            # match by trailing "x-"/"y+"/... tag (reference
            # geometry/base.py:1949 matches surf.name[-2:])
            surfaces = [s for s in surfaces
                        if s.name[-2:] not in exclude_surfaces]
        return surfaces

    @cached_property
    def bounds(self) -> Bound:
        size = [s if not np.isinf(s) else 2 * inf for s in self.size]
        rmin = tuple(c - s / 2 for c, s in zip(self.center, size))
        rmax = tuple(c + s / 2 for c, s in zip(self.center, size))
        return rmin, rmax

    def inside(self, x, y, z) -> np.ndarray:
        x, y, z = np.asarray(x), np.asarray(y), np.asarray(z)
        x0, y0, z0 = self.center
        sx, sy, sz = self.size
        dist_x = np.abs(x - x0)
        dist_y = np.abs(y - y0)
        dist_z = np.abs(z - z0)
        return (dist_x <= sx / 2) & (dist_y <= sy / 2) & (dist_z <= sz / 2)

    def sdf(self, x, y, z) -> np.ndarray:
        x, y, z = np.asarray(x, dtype=float), np.asarray(y, dtype=float), np.asarray(z, dtype=float)
        qs = []
        for p, c, s in zip((x, y, z), self.center, self.size):
            half = min(s / 2, inf)
            qs.append(np.abs(p - c) - half)
        qx, qy, qz = np.broadcast_arrays(*qs)
        outside = np.sqrt(
            np.maximum(qx, 0) ** 2 + np.maximum(qy, 0) ** 2 + np.maximum(qz, 0) ** 2
        )
        max_q = np.maximum(qx, np.maximum(qy, qz))
        return outside + np.minimum(max_q, 0.0)

    def _intersections_normal_axis(self, axis: int, position: float) -> List[PlanarPolygon]:
        if not self.intersects_axis_position(axis, position):
            return []
        _, (c1, c2) = pop_axis(self.center, axis)
        _, (s1, s2) = pop_axis(self.size, axis)
        s1, s2 = min(s1, 2 * inf), min(s2, 2 * inf)
        verts = np.array([
            [c1 - s1 / 2, c2 - s2 / 2],
            [c1 + s1 / 2, c2 - s2 / 2],
            [c1 + s1 / 2, c2 + s2 / 2],
            [c1 - s1 / 2, c2 + s2 / 2],
        ])
        return [PlanarPolygon(verts)]

    def volume(self, bounds: Bound = None) -> float:
        rmin, rmax = self.bounds
        if bounds is not None:
            rmin = tuple(max(a, b) for a, b in zip(rmin, bounds[0]))
            rmax = tuple(min(a, b) for a, b in zip(rmax, bounds[1]))
        sizes = [max(hi - lo, 0.0) for lo, hi in zip(rmin, rmax)]
        return sizes[0] * sizes[1] * sizes[2]

    def surface_area(self, bounds: Bound = None) -> float:
        sx, sy, sz = self.size
        return 2 * (sx * sy + sy * sz + sz * sx)

    @cached_property
    def geometry(self) -> "Box":
        """A box identical to self (monitors/sources use this accessor)."""
        return Box(center=self.center, size=self.size)

    @property
    def zero_dims(self) -> List[Axis]:
        return [dim for dim in range(3) if self.size[dim] == 0.0]

    @cached_property
    def size_in_name(self) -> str:
        return "x".join(f"{s:.2g}" for s in self.size)

    def _plane_axis(self) -> Axis:
        """For planar (one zero-size dim) boxes: the normal axis."""
        zero_dims = self.zero_dims
        if len(zero_dims) != 1:
            raise ValidationError(
                f"Expected exactly one zero dimension, got size {self.size}."
            )
        return zero_dims[0]

    @cached_property
    def frame(self):
        return None

    # ------------------------------------------------------------------ #
    # shape-derivative adjoint VJPs
    # ------------------------------------------------------------------ #

    def _face_gradients(self, derivative_info) -> dict:
        """dJ/d(face position) per (axis, side) via face surface integrals.

        Reference behavior: Box.compute_derivatives face integrals
        (/root/reference/tidy3d/components/geometry/base.py:2333-2494).
        Sign convention: the returned value is dJ/d(coordinate of that
        face), so moving the hi face in +axis grows the box (+integral)
        and moving the lo face in +axis shrinks it (-integral).
        """
        info = derivative_info
        rmin, rmax = self.bounds
        grads = {}
        for axis in range(3):
            if self.size[axis] == 0.0:
                grads[(axis, "lo")] = 0.0
                grads[(axis, "hi")] = 0.0
                continue
            b_ax, c_ax = (axis + 1) % 3, (axis + 2) % 3
            # quadrature grids along the two tangential axes from the
            # gradient monitor's sample coords, clipped to the face extent
            normal = np.zeros(3)
            normal[axis] = 1.0
            ref_coords = info.sample_coords(E_COMPS_ADJ[b_ax])
            cb = ref_coords["xyz"[b_ax]]
            cc = ref_coords["xyz"[c_ax]]
            sel_b = (cb >= rmin[b_ax] - 1e-9) & (cb <= rmax[b_ax] + 1e-9)
            sel_c = (cc >= rmin[c_ax] - 1e-9) & (cc <= rmax[c_ax] + 1e-9)
            cb, cc = cb[sel_b], cc[sel_c]
            if len(cb) == 0 or len(cc) == 0:
                grads[(axis, "lo")] = 0.0
                grads[(axis, "hi")] = 0.0
                continue
            wb = quad_weights(cb, rmin[b_ax], rmax[b_ax])
            wc = quad_weights(cc, rmin[c_ax], rmax[c_ax])
            w2d = wb[:, None] * wc[None, :]
            for side, pos in (("lo", rmin[axis]), ("hi", rmax[axis])):
                pts = [None, None, None]
                pts[axis] = np.full((len(cb), len(cc)), pos)
                pts[b_ax] = np.broadcast_to(cb[:, None], (len(cb), len(cc)))
                pts[c_ax] = np.broadcast_to(cc[None, :], (len(cb), len(cc)))
                integrand = info.surface_integrand(normal, *pts)
                integral = np.sum(integrand * w2d)
                sign = 1.0 if side == "hi" else -1.0
                grads[(axis, side)] = sign * info.real_grad(integral)
        return grads

    def compute_derivatives(self, paths, derivative_info) -> dict:
        """Adjoint gradients for requested paths ('center', 'size') as the
        exact discrete adjoint of the SDF subpixel rasterizer
        (``sdf_chain_grad``); the reference instead evaluates continuum
        face integrals (geometry/base.py:2333-2494) — same continuum
        limit, but this matches the solver's own discretization, which is
        what finite differences of the objective measure."""
        from ..autograd.derivative_utils import raster_grad

        info = derivative_info
        h = 1e-3 * info.dl_loc
        geos = {}
        for ax in range(3):
            if self.size[ax] == 0.0:
                continue
            for which in ("center", "size"):
                def perturbed(sign, ax=ax, which=which):
                    vals = list(getattr(self, which))
                    vals[ax] += sign * h
                    return self.copy(update={which: tuple(vals)})
                geos[(which, ax)] = (perturbed(+1), perturbed(-1), 2 * h)
        grads = raster_grad(info, geos, info.dl_loc)
        out = {}
        for path in paths:
            if path in ("center", "size"):
                out[path] = np.array([grads.get((path, a), 0.0)
                                      for a in range(3)])
            else:
                raise NotImplementedError(
                    f"Box derivative for path {path!r} not supported")
        return out


class Transformed(Geometry):
    """Geometry transformed by a 4x4 homogeneous matrix.

    Reference: geometry/base.py:2496.
    """

    geometry: "GeometryType" = pydantic.Field(
        ..., title="Geometry", description="Base geometry to be transformed."
    )
    transform: MatrixReal4x4 = pydantic.Field(
        default_factory=lambda: np.eye(4).tolist(),
        title="Transform", description="4x4 homogeneous transformation matrix.",
    )

    @pydantic.field_validator("transform")
    @classmethod
    def _check_transform(cls, val):
        arr = np.asarray(val, dtype=float)
        if arr.shape != (4, 4):
            raise ValidationError("transform must be a 4x4 matrix")
        if not np.allclose(arr[3], [0, 0, 0, 1]):
            raise ValidationError("transform must keep the last row as [0, 0, 0, 1]")
        if abs(np.linalg.det(arr[:3, :3])) < fp_eps:
            raise ValidationError("transform must be invertible")
        return arr

    @staticmethod
    def translation(x: float, y: float, z: float) -> np.ndarray:
        m = np.eye(4)
        m[:3, 3] = (x, y, z)
        return m

    @staticmethod
    def rotation(angle: float, axis) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = geo_utils.rotation_matrix(axis, angle)
        return m

    @staticmethod
    def scaling(x: float = 1.0, y: float = 1.0, z: float = 1.0) -> np.ndarray:
        if x == 0 or y == 0 or z == 0:
            raise ValidationError("scaling factors cannot be zero")
        return np.diag([x, y, z, 1.0])

    @staticmethod
    def preserves_axis(transform: np.ndarray, axis: int) -> bool:
        """Whether the transform maps the given axis direction to itself."""
        vec = np.zeros(3)
        vec[axis] = 1.0
        out = np.asarray(transform)[:3, :3] @ vec
        out = out / np.linalg.norm(out)
        return bool(np.allclose(out, vec))

    @cached_property
    def inverse(self) -> np.ndarray:
        return np.linalg.inv(np.asarray(self.transform, dtype=float))

    def _map_points_inverse(self, x, y, z):
        inv = self.inverse
        x, y, z = np.broadcast_arrays(np.asarray(x, float), np.asarray(y, float),
                                      np.asarray(z, float))
        xi = inv[0, 0] * x + inv[0, 1] * y + inv[0, 2] * z + inv[0, 3]
        yi = inv[1, 0] * x + inv[1, 1] * y + inv[1, 2] * z + inv[1, 3]
        zi = inv[2, 0] * x + inv[2, 1] * y + inv[2, 2] * z + inv[2, 3]
        return xi, yi, zi

    def inside(self, x, y, z) -> np.ndarray:
        return self.geometry.inside(*self._map_points_inverse(x, y, z))

    def sdf(self, x, y, z) -> np.ndarray:
        # correct for rigid transforms; scaled by min singular value otherwise
        child = self.geometry.sdf(*self._map_points_inverse(x, y, z))
        scale = np.linalg.svd(np.asarray(self.transform)[:3, :3], compute_uv=False)
        return child * float(np.min(scale))

    @cached_property
    def bounds(self) -> Bound:
        rmin, rmax = self.geometry.bounds
        corners = np.array([[x, y, z, 1.0] for x in (rmin[0], rmax[0])
                            for y in (rmin[1], rmax[1]) for z in (rmin[2], rmax[2])])
        # clip infinities to keep arithmetic finite
        corners[:, :3] = np.clip(corners[:, :3], -inf, inf)
        moved = corners @ np.asarray(self.transform, dtype=float).T
        return tuple(moved[:, :3].min(axis=0)), tuple(moved[:, :3].max(axis=0))

    def _intersections_normal_axis(self, axis, position):
        # sample-based fallback is expensive; only supported for axis-preserving
        # rigid transforms where the plane maps to a plane of the child
        raise NotImplementedError(
            "intersections_plane for Transformed geometries is not yet implemented; "
            "rasterization uses `inside`/`sdf` directly."
        )


class ClipOperation(Geometry):
    """Boolean combination of two geometries.

    Reference: geometry/base.py:2772.
    """

    operation: ClipOperationType = pydantic.Field(
        ..., title="Operation Type",
        description="Operation to apply: union | intersection | difference | symmetric_difference.",
    )
    geometry_a: "GeometryType" = pydantic.Field(..., title="Geometry A")
    geometry_b: "GeometryType" = pydantic.Field(..., title="Geometry B")

    def inside(self, x, y, z) -> np.ndarray:
        in_a = self.geometry_a.inside(x, y, z)
        in_b = self.geometry_b.inside(x, y, z)
        if self.operation == "union":
            return in_a | in_b
        if self.operation == "intersection":
            return in_a & in_b
        if self.operation == "difference":
            return in_a & ~in_b
        return in_a ^ in_b

    def sdf(self, x, y, z) -> np.ndarray:
        sdf_a = self.geometry_a.sdf(x, y, z)
        sdf_b = self.geometry_b.sdf(x, y, z)
        if self.operation == "union":
            return np.minimum(sdf_a, sdf_b)
        if self.operation == "intersection":
            return np.maximum(sdf_a, sdf_b)
        if self.operation == "difference":
            return np.maximum(sdf_a, -sdf_b)
        # symmetric difference: union minus intersection
        return np.maximum(np.minimum(sdf_a, sdf_b), -np.maximum(sdf_a, sdf_b))

    @cached_property
    def bounds(self) -> Bound:
        a_min, a_max = self.geometry_a.bounds
        b_min, b_max = self.geometry_b.bounds
        if self.operation == "intersection":
            return (
                tuple(max(a, b) for a, b in zip(a_min, b_min)),
                tuple(min(a, b) for a, b in zip(a_max, b_max)),
            )
        if self.operation == "difference":
            return a_min, a_max
        return (
            tuple(min(a, b) for a, b in zip(a_min, b_min)),
            tuple(max(a, b) for a, b in zip(a_max, b_max)),
        )


class GeometryGroup(Geometry):
    """Collection of geometries treated as one (union).

    Reference: geometry/base.py:3013.
    """

    geometries: Tuple["GeometryType", ...] = pydantic.Field(
        ..., title="Geometries", description="Geometries in the group."
    )

    @pydantic.field_validator("geometries")
    @classmethod
    def _not_empty(cls, val):
        if not val:
            raise ValidationError("GeometryGroup.geometries must not be empty")
        return val

    def inside(self, x, y, z) -> np.ndarray:
        result = self.geometries[0].inside(x, y, z)
        for geometry in self.geometries[1:]:
            result = result | geometry.inside(x, y, z)
        return result

    def sdf(self, x, y, z) -> np.ndarray:
        result = self.geometries[0].sdf(x, y, z)
        for geometry in self.geometries[1:]:
            result = np.minimum(result, geometry.sdf(x, y, z))
        return result

    @cached_property
    def bounds(self) -> Bound:
        bounds = [g.bounds for g in self.geometries]
        rmin = tuple(min(b[0][d] for b in bounds) for d in range(3))
        rmax = tuple(max(b[1][d] for b in bounds) for d in range(3))
        return rmin, rmax

    def _intersections_normal_axis(self, axis, position):
        polys = []
        for geometry in self.geometries:
            if geometry.intersects_axis_position(axis, position):
                polys.extend(geometry._intersections_normal_axis(axis, position))
        return polys

    def volume(self, bounds: Bound = None) -> float:
        # exact only for disjoint members; overlaps double-counted (same caveat
        # applies to the reference's shapely-free quick path)
        return sum(g.volume(bounds) for g in self.geometries)


from .primitives import Cylinder, Sphere  # noqa: E402
from .polyslab import ComplexPolySlabBase, PolySlab  # noqa: E402
from .mesh import TriangleMesh  # noqa: E402

GeometryType = Union[
    Box, Sphere, Cylinder, PolySlab, TriangleMesh, ClipOperation, GeometryGroup, Transformed
]

from ..types import annotate_type as _annotate  # noqa: E402

for _model in (Transformed, ClipOperation, GeometryGroup):
    _model.model_rebuild()
