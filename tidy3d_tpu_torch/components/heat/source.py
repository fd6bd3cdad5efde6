"""Heat sources (reference: tidy3d/components/heat/source.py)."""

from __future__ import annotations

from typing import Tuple, Union

import pydantic

from ..base import Tidy3dBaseModel
from ...constants import VOLUMETRIC_HEAT_RATE


class UniformHeatSource(Tidy3dBaseModel):
    """Uniform volumetric heat generation inside named structures."""

    structures: Tuple[str, ...] = pydantic.Field(..., title="Structure names")
    rate: float = pydantic.Field(
        ..., title="Volumetric heat rate", description=f"[{VOLUMETRIC_HEAT_RATE}]")


HeatSourceType = UniformHeatSource
