"""Sphere and Cylinder primitives.

Behavioral model: /root/reference/tidy3d/components/geometry/primitives.py
(Sphere:36, Cylinder:179 — incl. sidewall-angle cone frustum support).
"""

from __future__ import annotations

from typing import List

import numpy as np
import pydantic

from ...constants import fp_eps, inf
from ...exceptions import SetupError
from ..base import cached_property
from ..types import Bound, PlanePosition
from . import base
from .utils import PlanarPolygon, pop_axis, regular_polygon_approx

_N_PTS_CIRCLE = 96


class Sphere(base.Centered, base.Circular):
    """Sphere: center + radius."""

    def inside(self, x, y, z) -> np.ndarray:
        x0, y0, z0 = self.center
        dist2 = (np.asarray(x) - x0) ** 2 + (np.asarray(y) - y0) ** 2 + (np.asarray(z) - z0) ** 2
        return dist2 <= self.radius**2

    def sdf(self, x, y, z) -> np.ndarray:
        x0, y0, z0 = self.center
        dist = np.sqrt(
            (np.asarray(x, float) - x0) ** 2
            + (np.asarray(y, float) - y0) ** 2
            + (np.asarray(z, float) - z0) ** 2
        )
        return dist - self.radius

    @cached_property
    def bounds(self) -> Bound:
        return (
            tuple(c - self.radius for c in self.center),
            tuple(c + self.radius for c in self.center),
        )

    def _intersections_normal_axis(self, axis: int, position: float) -> List[PlanarPolygon]:
        ax_pos, (c1, c2) = pop_axis(self.center, axis)
        dist = abs(position - ax_pos)
        if dist >= self.radius:
            return []
        r_section = np.sqrt(self.radius**2 - dist**2)
        return [PlanarPolygon(regular_polygon_approx(r_section, _N_PTS_CIRCLE, (c1, c2)))]

    def volume(self, bounds: Bound = None) -> float:
        if bounds is None:
            return 4 / 3 * np.pi * self.radius**3
        return super().volume(bounds)

    def surface_area(self, bounds: Bound = None) -> float:
        return 4 * np.pi * self.radius**2


class Cylinder(base.Centered, base.Circular, base.Planar):
    """Cylinder (optionally a cone frustum via ``sidewall_angle``)."""

    length: pydantic.NonNegativeFloat = pydantic.Field(
        ..., title="Length", description="Length of the cylinder along its axis."
    )
    sidewall_angle: float = pydantic.Field(
        0.0,
        title="Sidewall angle",
        description="Angle of the sidewall [rad]; positive shrinks the cross "
        "section away from the reference plane.",
        ge=-np.pi / 2,
        le=np.pi / 2,
    )
    reference_plane: PlanePosition = pydantic.Field(
        "middle", title="Reference plane",
        description="Where the given radius is defined along the axis.",
    )

    @property
    def center_axis(self) -> float:
        return self.center[self.axis]

    @property
    def length_axis(self) -> float:
        return self.length

    @cached_property
    def _tanq(self) -> float:
        return float(np.tan(self.sidewall_angle))

    def radius_at_axis_position(self, ax_pos) -> np.ndarray:
        """Radius of the cross-section as function of position along axis."""
        offsets = {"bottom": -self.length / 2, "middle": 0.0, "top": self.length / 2}
        z_ref = self.center_axis + offsets[self.reference_plane]
        return self.radius - (np.asarray(ax_pos) - z_ref) * self._tanq

    @property
    def radius_bottom(self) -> float:
        return float(self.radius_at_axis_position(self.center_axis - self.length / 2))

    @property
    def radius_top(self) -> float:
        return float(self.radius_at_axis_position(self.center_axis + self.length / 2))

    @property
    def radius_max(self) -> float:
        return max(self.radius_bottom, self.radius_top)

    def inside(self, x, y, z) -> np.ndarray:
        ax_p, (p1, p2) = pop_axis((np.asarray(x), np.asarray(y), np.asarray(z)), self.axis)
        _, (c1, c2) = pop_axis(self.center, self.axis)
        in_axis = np.abs(ax_p - self.center_axis) <= self.length / 2
        r_local = np.maximum(self.radius_at_axis_position(ax_p), 0.0)
        dist2 = (p1 - c1) ** 2 + (p2 - c2) ** 2
        return in_axis & (dist2 <= r_local**2)

    def sdf(self, x, y, z) -> np.ndarray:
        ax_p, (p1, p2) = pop_axis(
            (np.asarray(x, float), np.asarray(y, float), np.asarray(z, float)), self.axis
        )
        _, (c1, c2) = pop_axis(self.center, self.axis)
        r_local = self.radius_at_axis_position(ax_p)
        d_radial = np.sqrt((p1 - c1) ** 2 + (p2 - c2) ** 2) - r_local
        # correct radial distance for the wall slant
        d_radial = d_radial * float(np.cos(self.sidewall_angle))
        d_axial = np.abs(ax_p - self.center_axis) - self.length / 2
        d_radial, d_axial = np.broadcast_arrays(d_radial, d_axial)
        outside = np.sqrt(np.maximum(d_radial, 0) ** 2 + np.maximum(d_axial, 0) ** 2)
        return outside + np.minimum(np.maximum(d_radial, d_axial), 0.0)

    @cached_property
    def bounds(self) -> Bound:
        r_max = self.radius_max
        _, (c1, c2) = pop_axis(self.center, self.axis)
        mins = base.unpop_axis(self.center_axis - self.length / 2, (c1 - r_max, c2 - r_max), self.axis)
        maxs = base.unpop_axis(self.center_axis + self.length / 2, (c1 + r_max, c2 + r_max), self.axis)
        return tuple(mins), tuple(maxs)

    def _intersections_normal_axis(self, axis: int, position: float) -> List[PlanarPolygon]:
        if axis == self.axis:
            if abs(position - self.center_axis) > self.length / 2:
                return []
            r = float(self.radius_at_axis_position(position))
            if r <= 0:
                return []
            _, (c1, c2) = pop_axis(self.center, self.axis)
            return [PlanarPolygon(regular_polygon_approx(r, _N_PTS_CIRCLE, (c1, c2)))]
        # side section: sample the boundary of the (possibly slanted) cylinder
        if not self.intersects_axis_position(axis, position):
            return []
        # in-plane coords after popping `axis`: one is the cylinder axis
        ax_lo = self.center_axis - self.length / 2
        ax_hi = self.center_axis + self.length / 2
        axes = [0, 1, 2]
        axes.remove(axis)
        # position along the remaining transverse axis of the cylinder
        trans_axis = [a for a in axes if a != self.axis][0]
        fixed_in_plane = position - self.center[axis]
        samples = np.linspace(ax_lo, ax_hi, 33)
        radii = np.maximum(self.radius_at_axis_position(samples), 0.0)
        half_chord = np.sqrt(np.maximum(radii**2 - fixed_in_plane**2, 0.0))
        if np.all(half_chord <= fp_eps):
            return []
        trans_center = self.center[trans_axis]
        # build polygon in (plane coords with axis popped) ordering
        upper = np.stack([samples, trans_center + half_chord], axis=-1)
        lower = np.stack([samples[::-1], trans_center - half_chord[::-1]], axis=-1)
        verts_axis_trans = np.concatenate([upper, lower], axis=0)
        # order vertices as (coord_a, coord_b) where a < b are the plane axes
        if self.axis < trans_axis:
            verts = verts_axis_trans
        else:
            verts = verts_axis_trans[:, ::-1]
        return [PlanarPolygon(verts)]

    def volume(self, bounds: Bound = None) -> float:
        if bounds is None and abs(self.sidewall_angle) < fp_eps:
            return np.pi * self.radius**2 * self.length
        if bounds is None:
            r0, r1 = self.radius_bottom, self.radius_top
            return np.pi * self.length / 3 * (r0**2 + r0 * r1 + r1**2)
        return super().volume(bounds)

    def surface_area(self, bounds: Bound = None) -> float:
        return 2 * np.pi * self.radius * (self.radius + self.length)

    def to_polyslab(self, num_pts: int = _N_PTS_CIRCLE, **kwargs):
        """Approximate as a PolySlab with a regular-polygon cross section."""
        from .polyslab import PolySlab

        _, (c1, c2) = pop_axis(self.center, self.axis)
        vertices = regular_polygon_approx(self.radius, num_pts, (c1, c2))
        return PolySlab(
            vertices=vertices,
            axis=self.axis,
            slab_bounds=(self.center_axis - self.length / 2, self.center_axis + self.length / 2),
            sidewall_angle=self.sidewall_angle,
            reference_plane=self.reference_plane,
            **kwargs,
        )
