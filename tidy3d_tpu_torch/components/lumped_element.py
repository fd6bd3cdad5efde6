"""Lumped circuit elements embedded in the FDTD grid.

Behavioral model: the upstream tidy3d components/lumped_element.py
(LumpedResistor:25, CoaxialLumpedResistor — converted to volumetric media +
mesh-snapping overrides).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import pydantic

from ..constants import EPSILON_0
from ..exceptions import ValidationError
from .base import Tidy3dBaseModel, cached_property
from .geometry.base import Box
from .medium import AnisotropicMedium, Medium
from .structure import MeshOverrideStructure, Structure
from .types import Axis, Coordinate, Size


class LumpedElement(Tidy3dBaseModel):
    """Base for lumped elements."""

    name: str = pydantic.Field(..., min_length=1, title="Name")
    num_grid_cells: Optional[pydantic.PositiveInt] = pydantic.Field(
        3, title="Minimum grid cells across the element")


class LumpedResistor(LumpedElement):
    """Rectangular sheet resistor between two terminals along voltage_axis."""

    center: Coordinate = pydantic.Field((0, 0, 0), title="Center")
    size: Size = pydantic.Field(..., title="Size")
    resistance: pydantic.PositiveFloat = pydantic.Field(..., title="Resistance [Ohm]")
    voltage_axis: Axis = pydantic.Field(..., title="Voltage axis")

    @pydantic.model_validator(mode="after")
    def _planar(self):
        if tuple(self.size).count(0.0) != 1:
            raise ValidationError("LumpedResistor must have exactly one zero size")
        if self.size[self.voltage_axis] == 0.0:
            raise ValidationError("voltage_axis must be an in-plane axis")
        return self

    @cached_property
    def normal_axis(self) -> Axis:
        return tuple(self.size).index(0.0)

    @cached_property
    def sheet_conductance(self) -> float:
        """Sheet conductance sigma*d implementing the resistance."""
        lateral_axis = 3 - self.normal_axis - self.voltage_axis
        w = self.size[lateral_axis]
        l = self.size[self.voltage_axis]
        return l / (self.resistance * w)

    def to_structure(self, grid=None) -> Structure:
        """Volumetric structure: one-cell-thick anisotropic conductor."""
        dl = 1.0
        if grid is not None:
            sizes = np.asarray(grid.sizes.to_list[self.normal_axis])
            dl = float(np.min(sizes))
        sigma = self.sheet_conductance / dl
        comps = {}
        for axis, name in enumerate(("xx", "yy", "zz")):
            if axis == self.voltage_axis:
                comps[name] = Medium(permittivity=1.0, conductivity=sigma)
            else:
                comps[name] = Medium(permittivity=1.0)
        size = list(self.size)
        size[self.normal_axis] = dl
        return Structure(
            geometry=Box(center=self.center, size=tuple(size)),
            medium=AnisotropicMedium(**comps), name=self.name,
        )

    def to_mesh_overrides(self) -> Tuple[MeshOverrideStructure, ...]:
        dl = [s / max(self.num_grid_cells, 1) if s > 0 else None
              for s in self.size]
        return (MeshOverrideStructure(
            geometry=Box(center=self.center, size=self.size), dl=tuple(dl)),)


class CoaxialLumpedResistor(LumpedElement):
    """Annular resistor between inner and outer coaxial conductors."""

    center: Coordinate = pydantic.Field((0, 0, 0), title="Center")
    outer_diameter: pydantic.PositiveFloat = pydantic.Field(..., title="Outer diameter")
    inner_diameter: pydantic.PositiveFloat = pydantic.Field(..., title="Inner diameter")
    normal_axis: Axis = pydantic.Field(..., title="Normal axis")
    resistance: pydantic.PositiveFloat = pydantic.Field(..., title="Resistance [Ohm]")

    @pydantic.model_validator(mode="after")
    def _check_diameters(self):
        if self.inner_diameter >= self.outer_diameter:
            raise ValidationError("inner_diameter must be less than outer_diameter")
        return self

    def to_structure(self, grid=None) -> Structure:
        from .geometry.primitives import Cylinder
        from .geometry.base import ClipOperation

        dl = 1.0
        if grid is not None:
            sizes = np.asarray(grid.sizes.to_list[self.normal_axis])
            dl = float(np.min(sizes))
        # radial sheet resistance: R = ln(b/a) / (2 pi sigma_s)
        sigma_s = np.log(self.outer_diameter / self.inner_diameter) / (
            2 * np.pi * self.resistance)
        sigma = sigma_s / dl
        ring = ClipOperation(
            operation="difference",
            geometry_a=Cylinder(center=self.center, radius=self.outer_diameter / 2,
                                length=dl, axis=self.normal_axis),
            geometry_b=Cylinder(center=self.center, radius=self.inner_diameter / 2,
                                length=dl * 1.01, axis=self.normal_axis),
        )
        return Structure(
            geometry=ring,
            medium=Medium(permittivity=1.0, conductivity=sigma), name=self.name,
        )


LumpedElementType = Union[LumpedResistor, CoaxialLumpedResistor]
