"""Scene: simulation-independent container of structures + background medium.

Behavioral model: /root/reference/tidy3d/components/scene.py (Scene:58,
MAX_NUM_MEDIUMS=65530).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import pydantic

from ..exceptions import SetupError, ValidationError
from ..log import log
from .base import Tidy3dBaseModel, cached_property
from .geometry.base import Box
from .medium import AbstractMedium, Medium, MediumType, MediumType3D
from .structure import Structure
from .types import Ax, Bound, Coordinate, annotate_type

MAX_NUM_MEDIUMS = 65530


class Scene(Tidy3dBaseModel):
    """Contains structures and a background medium."""

    medium: annotate_type(MediumType3D) = pydantic.Field(
        default_factory=Medium, title="Background Medium",
    )
    structures: Tuple[Structure, ...] = pydantic.Field(
        (), title="Structures",
        description="Structures in the scene; later structures override earlier ones.",
    )

    @pydantic.field_validator("structures")
    @classmethod
    def _num_mediums(cls, val):
        mediums = {s.medium for s in val}
        if len(mediums) > MAX_NUM_MEDIUMS:
            raise ValidationError(f"Too many distinct mediums (> {MAX_NUM_MEDIUMS})")
        return val

    @cached_property
    def bounds(self) -> Bound:
        bounds = [s.geometry.bounds for s in self.structures]
        if not bounds:
            return ((0, 0, 0), (0, 0, 0))
        rmin = tuple(min(b[0][d] for b in bounds) for d in range(3))
        rmax = tuple(max(b[1][d] for b in bounds) for d in range(3))
        return rmin, rmax

    @cached_property
    def size(self) -> Tuple[float, float, float]:
        rmin, rmax = self.bounds
        return tuple(hi - lo for lo, hi in zip(rmin, rmax))

    @cached_property
    def center(self) -> Coordinate:
        rmin, rmax = self.bounds
        return tuple(0.5 * (hi + lo) for lo, hi in zip(rmin, rmax))

    @cached_property
    def box(self) -> Box:
        return Box.from_bounds(*self.bounds)

    @cached_property
    def mediums(self) -> List[AbstractMedium]:
        """All distinct mediums, background first, in order of appearance."""
        mediums = [self.medium]
        for structure in self.structures:
            if structure.medium not in mediums:
                mediums.append(structure.medium)
        return mediums

    @cached_property
    def medium_map(self) -> Dict[AbstractMedium, int]:
        return {medium: index for index, medium in enumerate(self.mediums)}

    @cached_property
    def background_structure(self) -> Structure:
        from ..constants import inf

        return Structure(geometry=Box(size=(inf, inf, inf)), medium=self.medium)

    @cached_property
    def all_structures(self) -> List[Structure]:
        return [self.background_structure] + list(self.structures)

    def intersecting_media(self, test_object: Box, structures: Tuple[Structure, ...] = None
                           ) -> List[AbstractMedium]:
        """Media of structures intersecting a box (plus background).

        For a planar test object, tangency along the plane normal does not
        count: the reference intersects actual plane cross-sections
        (scene.py:244-248 via ``_filter_structures_plane_medium``), so a
        structure whose face merely touches the plane contributes zero
        area and is excluded."""
        structures = structures if structures is not None else self.structures
        size = tuple(test_object.size)
        plane_ax = size.index(0.0) if size.count(0.0) == 1 else None
        mediums = []
        for structure in structures:
            geometry = structure.geometry
            if plane_ax is not None:
                pos = test_object.center[plane_ax]
                # true cross-section test: tangency yields no polygon,
                # a coincident face yields one; handles data-less meshes
                # and composite geometries whose bbox over-covers
                try:
                    polys = geometry.intersections_plane(
                        **{"xyz"[plane_ax]: pos})
                except NotImplementedError:
                    b = geometry.bounds
                    polys = None
                    if not (b[0][plane_ax] <= pos <= b[1][plane_ax]):
                        continue
                if polys is not None:
                    tc = [c for i, c in enumerate(test_object.center)
                          if i != plane_ax]
                    ts = [s for i, s in enumerate(test_object.size)
                          if i != plane_ax]
                    lo = [c - s / 2 for c, s in zip(tc, ts)]
                    hi = [c + s / 2 for c, s in zip(tc, ts)]
                    if not any(
                        p.bounds[0] <= hi[0] and p.bounds[2] >= lo[0]
                        and p.bounds[1] <= hi[1] and p.bounds[3] >= lo[1]
                        for p in polys
                    ):
                        continue
            if not geometry.intersects(test_object):
                continue
            if structure.medium not in mediums:
                mediums.append(structure.medium)
        if self.medium not in mediums:
            mediums.append(self.medium)
        return mediums

    def intersecting_structures(self, test_object: Box) -> List[Structure]:
        return [s for s in self.structures if s.geometry.intersects(test_object)]

    # ------------------------------------------------------------------ #
    # eps sampling (staircase; subpixel handled by the solver lowering)
    # ------------------------------------------------------------------ #

    def eps_on_points(self, x: np.ndarray, y: np.ndarray, z: np.ndarray,
                      frequency: float, component: int = 0) -> np.ndarray:
        """Complex eps at broadcastable points (later structures override)."""
        shape = np.broadcast_shapes(np.shape(x), np.shape(y), np.shape(z))
        eps_bg = self.medium.eps_diagonal(frequency)[component]
        eps = np.full(shape, eps_bg, dtype=complex)
        for structure in self.structures:
            mask = structure.geometry.inside(x, y, z)
            if not np.any(mask):
                continue
            eps_val = structure.medium.eps_diagonal(frequency)[component]
            eps = np.where(mask, eps_val, eps)
        return eps

    # plotting
    def plot(self, x: float = None, y: float = None, z: float = None, ax: Ax = None, **kwargs):
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        for structure in self.structures:
            try:
                structure.geometry.plot(x=x, y=y, z=z, ax=ax, **kwargs)
            except NotImplementedError:
                continue
        return ax

    def plot_eps(self, x: float = None, y: float = None, z: float = None,
                 freq: float = None, ax: Ax = None, **kwargs):
        return self.plot(x=x, y=y, z=z, ax=ax, **kwargs)
