"""Geometry utilities: axis bookkeeping, coordinate transforms, and polygon
math (point-in-polygon, signed distance) implemented natively with numpy —
the reference delegates 2D boolean/polygon ops to shapely
(/root/reference/tidy3d/components/geometry/base.py, utils.py); here we keep a
minimal vectorized polygon toolkit so rasterization needs no external deps.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np

from ...constants import fp_eps


# --------------------------------------------------------------------------- #
# axis bookkeeping (reference: Geometry.pop_axis / unpop_axis)
# --------------------------------------------------------------------------- #


def pop_axis(coord: Tuple[Any, Any, Any], axis: int) -> Tuple[Any, Tuple[Any, Any]]:
    """Separate the coordinate along ``axis`` from the plane coordinates."""
    plane_vals = list(coord)
    axis_val = plane_vals.pop(axis)
    return axis_val, tuple(plane_vals)


def unpop_axis(ax_coord: Any, plane_coords: Tuple[Any, Any], axis: int) -> Tuple[Any, Any, Any]:
    """Re-combine an axis coordinate and plane coordinates into an xyz triple."""
    coords = list(plane_coords)
    coords.insert(axis, ax_coord)
    return tuple(coords)


def parse_xyz_kwargs(**xyz) -> Tuple[int, float]:
    """Given one of x=..., y=..., z=..., return (axis, position)."""
    xyz_filtered = {k: v for k, v in xyz.items() if v is not None}
    if len(xyz_filtered) != 1:
        raise ValueError("exactly one of x, y, z must be specified")
    axis_label, position = list(xyz_filtered.items())[0]
    return "xyz".index(axis_label), position


# --------------------------------------------------------------------------- #
# rotations / spherical transforms
# --------------------------------------------------------------------------- #


def rotation_matrix(axis, angle: float) -> np.ndarray:
    """3x3 rotation matrix about a (3,) axis vector by angle [rad]."""
    if isinstance(axis, int):
        vec = np.zeros(3)
        vec[axis] = 1.0
        axis = vec
    axis = np.asarray(axis, dtype=float)
    axis = axis / np.linalg.norm(axis)
    ux, uy, uz = axis
    c, s = np.cos(angle), np.sin(angle)
    mc = 1 - c
    return np.array([
        [c + ux * ux * mc, ux * uy * mc - uz * s, ux * uz * mc + uy * s],
        [uy * ux * mc + uz * s, c + uy * uy * mc, uy * uz * mc - ux * s],
        [uz * ux * mc - uy * s, uz * uy * mc + ux * s, c + uz * uz * mc],
    ])


def sph_2_car(r, theta, phi):
    """Spherical (r, polar theta from +z, azimuth phi from +x) to cartesian."""
    sin_t = np.sin(theta)
    return r * sin_t * np.cos(phi), r * sin_t * np.sin(phi), r * np.cos(theta)


def car_2_sph(x, y, z):
    r = np.sqrt(x**2 + y**2 + z**2)
    theta = np.arccos(np.clip(np.divide(z, np.where(r == 0, 1.0, r)), -1, 1))
    phi = np.arctan2(y, x)
    return r, theta, phi


def sph_2_car_field(f_r, f_theta, f_phi, theta, phi):
    """Convert vector field components from spherical to cartesian basis."""
    sin_t, cos_t = np.sin(theta), np.cos(theta)
    sin_p, cos_p = np.sin(phi), np.cos(phi)
    f_x = f_r * sin_t * cos_p + f_theta * cos_t * cos_p - f_phi * sin_p
    f_y = f_r * sin_t * sin_p + f_theta * cos_t * sin_p + f_phi * cos_p
    f_z = f_r * cos_t - f_theta * sin_t
    return f_x, f_y, f_z


def car_2_sph_field(f_x, f_y, f_z, theta, phi):
    """Convert vector field components from cartesian to spherical basis."""
    sin_t, cos_t = np.sin(theta), np.cos(theta)
    sin_p, cos_p = np.sin(phi), np.cos(phi)
    f_r = f_x * sin_t * cos_p + f_y * sin_t * sin_p + f_z * cos_t
    f_theta = f_x * cos_t * cos_p + f_y * cos_t * sin_p - f_z * sin_t
    f_phi = -f_x * sin_p + f_y * cos_p
    return f_r, f_theta, f_phi


def kspace_2_sph(ux, uy, axis: int):
    """Convert normalized k-space coordinates to (theta, phi) angles, for a
    projection plane normal to ``axis`` (reference: base.py kspace_2_sph)."""
    phi_local = np.arctan2(uy, ux)
    with np.errstate(invalid="ignore"):
        theta_local = np.arcsin(np.sqrt(ux**2 + uy**2))
    if axis == 2:
        return theta_local, phi_local
    x = np.cos(theta_local)
    y = np.sin(theta_local) * np.sin(phi_local)
    z = -np.sin(theta_local) * np.cos(phi_local)
    if axis == 1:
        x, y, z = -z, x, -y
    theta = np.arccos(np.clip(z, -1, 1))
    phi = np.arctan2(y, x)
    return theta, phi


# --------------------------------------------------------------------------- #
# polygon math (shapely replacement, vectorized over query points)
# --------------------------------------------------------------------------- #


def polygon_area(vertices: np.ndarray) -> float:
    """Signed area of a polygon given (N, 2) vertices (CCW positive)."""
    v = np.asarray(vertices, dtype=float)
    x, y = v[:, 0], v[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def polygon_perimeter(vertices: np.ndarray) -> float:
    v = np.asarray(vertices, dtype=float)
    d = np.roll(v, -1, axis=0) - v
    return float(np.sum(np.sqrt(np.sum(d**2, axis=-1))))


def points_in_polygon(xs, ys, vertices: np.ndarray) -> np.ndarray:
    """Vectorized even-odd point-in-polygon test.

    xs, ys : broadcastable arrays of query coordinates.
    vertices : (N, 2) polygon vertices.

    Large batches route through the native OpenMP kernel
    (tidy3d_tpu/native/geometry_core.cpp) when available: one pass, no
    (npts x nv) numpy temporaries."""
    xs = np.asarray(xs, dtype=float)
    ys = np.asarray(ys, dtype=float)
    v = np.asarray(vertices, dtype=float)

    if xs.shape == ys.shape and xs.size * len(v) > 1_000_000:
        from ... import native

        out = native.points_in_polygon(xs, ys, v)
        if out is not None:
            return out
    x1, y1 = v[:, 0], v[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)

    # broadcast: query shape (...) against edges (N,)
    xq = xs[..., None]
    yq = ys[..., None]
    cond = (y1 > yq) != (y2 > yq)
    with np.errstate(divide="ignore", invalid="ignore"):
        x_int = x1 + (yq - y1) * (x2 - x1) / np.where(y2 == y1, np.inf, (y2 - y1))
    crossings = cond & (xq < x_int)
    return np.sum(crossings, axis=-1) % 2 == 1


def polygon_sdf(xs, ys, vertices: np.ndarray) -> np.ndarray:
    """Vectorized signed distance to a polygon boundary (negative inside).

    O(n_points * n_vertices); callers should pre-crop query points to the
    polygon bounding box for performance.
    """
    xs = np.asarray(xs, dtype=float)
    ys = np.asarray(ys, dtype=float)
    v = np.asarray(vertices, dtype=float)

    if xs.shape == ys.shape and xs.size * len(v) > 1_000_000:
        from ... import native

        out = native.polygon_sdf(xs, ys, v)
        if out is not None:
            return out

    a = v
    b = np.roll(v, -1, axis=0)
    ab = b - a  # (N, 2)
    ab_len2 = np.maximum(np.sum(ab**2, axis=-1), fp_eps**2)

    px = xs[..., None] - a[:, 0]
    py = ys[..., None] - a[:, 1]
    t = np.clip((px * ab[:, 0] + py * ab[:, 1]) / ab_len2, 0.0, 1.0)
    dx = px - t * ab[:, 0]
    dy = py - t * ab[:, 1]
    dist2 = dx**2 + dy**2
    dist = np.sqrt(np.min(dist2, axis=-1))

    inside = points_in_polygon(xs, ys, v)
    return np.where(inside, -dist, dist)


def offset_polygon_approx(vertices: np.ndarray, distance: float,
                          n_samples_per_edge: int = 1) -> np.ndarray:
    """Approximate polygon offset (dilation > 0 / erosion < 0) by moving each
    vertex along its angle-bisector normal. Adequate for small offsets such as
    per-z-slice sidewall corrections; exact boolean offsetting is not needed
    for rasterization (which uses polygon_sdf with a distance offset)."""
    v = np.asarray(vertices, dtype=float)
    if abs(distance) < fp_eps:
        return v.copy()
    prev = np.roll(v, 1, axis=0)
    nxt = np.roll(v, -1, axis=0)
    d1 = v - prev
    d2 = nxt - v
    d1 /= np.maximum(np.linalg.norm(d1, axis=-1, keepdims=True), fp_eps)
    d2 /= np.maximum(np.linalg.norm(d2, axis=-1, keepdims=True), fp_eps)
    # outward normal assuming CCW orientation
    sign = 1.0 if polygon_area(v) > 0 else -1.0
    n1 = sign * np.stack([d1[:, 1], -d1[:, 0]], axis=-1)
    n2 = sign * np.stack([d2[:, 1], -d2[:, 0]], axis=-1)
    bisector = n1 + n2
    norm = np.maximum(np.linalg.norm(bisector, axis=-1, keepdims=True), fp_eps)
    bisector /= norm
    # scale so that edges move by `distance`
    cos_half = np.maximum(np.sum(bisector * n1, axis=-1, keepdims=True), 0.1)
    return v + distance * bisector / cos_half


class PlanarPolygon:
    """Minimal polygon object returned by ``intersections_plane`` (the
    reference returns shapely polygons). Supports exterior + holes."""

    __slots__ = ("exterior", "holes")

    def __init__(self, exterior: np.ndarray, holes: List[np.ndarray] = None):
        self.exterior = np.asarray(exterior, dtype=float)
        self.holes = [np.asarray(h, dtype=float) for h in (holes or [])]

    @property
    def area(self) -> float:
        area = abs(polygon_area(self.exterior))
        for hole in self.holes:
            area -= abs(polygon_area(hole))
        return area

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        mins = self.exterior.min(axis=0)
        maxs = self.exterior.max(axis=0)
        return (mins[0], mins[1], maxs[0], maxs[1])

    def contains_points(self, xs, ys) -> np.ndarray:
        inside = points_in_polygon(xs, ys, self.exterior)
        for hole in self.holes:
            inside &= ~points_in_polygon(xs, ys, hole)
        return inside

    def __repr__(self):
        return f"PlanarPolygon({len(self.exterior)} vertices, {len(self.holes)} holes)"


def regular_polygon_approx(radius: float, num_pts: int = 64,
                           center: Tuple[float, float] = (0.0, 0.0)) -> np.ndarray:
    """Vertices approximating a circle (used for cylinder/sphere cross sections)."""
    angles = np.linspace(0, 2 * np.pi, num_pts, endpoint=False)
    return np.stack(
        [center[0] + radius * np.cos(angles), center[1] + radius * np.sin(angles)], axis=-1
    )
