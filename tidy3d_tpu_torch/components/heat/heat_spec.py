"""Thermal material specifications (reference: tidy3d/components/heat_spec.py)."""

from __future__ import annotations

from typing import Union

import pydantic

from ..base import Tidy3dBaseModel
from ...constants import SPECIFIC_HEAT_CAPACITY, THERMAL_CONDUCTIVITY


class FluidSpec(Tidy3dBaseModel):
    """Fluid medium (not conducting heat in the solid solver)."""


class SolidSpec(Tidy3dBaseModel):
    """Solid medium thermal properties."""

    capacity: pydantic.PositiveFloat = pydantic.Field(
        ..., title="Heat capacity", description=f"[{SPECIFIC_HEAT_CAPACITY}]")
    conductivity: pydantic.PositiveFloat = pydantic.Field(
        ..., title="Thermal conductivity", description=f"[{THERMAL_CONDUCTIVITY}]")


ThermalSpecType = Union[FluidSpec, SolidSpec]
