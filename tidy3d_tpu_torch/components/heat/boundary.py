"""Heat boundary conditions and their placements.

Behavioral model: tidy3d v2.7.6 components/heat/boundary.py and
bc_placement.py (temperature / flux / convection BCs on named targets).
"""

from __future__ import annotations

from typing import Tuple, Union

import pydantic

from ..base import Tidy3dBaseModel
from ...constants import HEAT_FLUX, HEAT_TRANSFER_COEFF, KELVIN
from ..types import annotate_type


class TemperatureBC(Tidy3dBaseModel):
    """Fixed temperature (Dirichlet)."""

    temperature: pydantic.PositiveFloat = pydantic.Field(
        ..., title="Temperature", description=f"[{KELVIN}]")


class HeatFluxBC(Tidy3dBaseModel):
    """Fixed heat flux (Neumann)."""

    flux: float = pydantic.Field(..., title="Heat flux", description=f"[{HEAT_FLUX}]")


class ConvectionBC(Tidy3dBaseModel):
    """Convective (Robin) boundary condition."""

    ambient_temperature: pydantic.PositiveFloat = pydantic.Field(
        ..., title="Ambient temperature", description=f"[{KELVIN}]")
    transfer_coeff: pydantic.NonNegativeFloat = pydantic.Field(
        ..., title="Heat transfer coefficient", description=f"[{HEAT_TRANSFER_COEFF}]")


HeatBCType = Union[TemperatureBC, HeatFluxBC, ConvectionBC]


class StructureBoundary(Tidy3dBaseModel):
    """BC on the boundary of a named structure."""

    structure: str = pydantic.Field(..., title="Structure name")


class StructureStructureInterface(Tidy3dBaseModel):
    """BC on the interface between two named structures."""

    structures: Tuple[str, str] = pydantic.Field(..., title="Structure names")


class SimulationBoundary(Tidy3dBaseModel):
    """BC on the simulation domain boundary."""


class MediumMediumInterface(Tidy3dBaseModel):
    """BC on the interface of two named mediums."""

    mediums: Tuple[str, str] = pydantic.Field(..., title="Medium names")


class StructureSimulationBoundary(Tidy3dBaseModel):
    """BC where a structure touches the simulation boundary."""

    structure: str = pydantic.Field(..., title="Structure name")


BCPlacementType = Union[
    StructureBoundary, StructureStructureInterface, SimulationBoundary,
    MediumMediumInterface, StructureSimulationBoundary,
]


class HeatBoundarySpec(Tidy3dBaseModel):
    """A boundary condition with its placement."""

    condition: annotate_type(HeatBCType) = pydantic.Field(..., title="Condition")
    placement: annotate_type(BCPlacementType) = pydantic.Field(..., title="Placement")
