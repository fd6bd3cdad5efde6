"""Subpixel averaging specification.

Behavioral model: /root/reference/tidy3d/components/subpixel_spec.py
(SubpixelSpec:117 selecting per-material-type averaging schemes). In this
framework the solver lowering implements SDF-based polarized averaging
natively (solver/lowering.py); these spec classes select/disable it.
"""

from __future__ import annotations

from typing import Union

import pydantic

from .base import Tidy3dBaseModel
from .types import annotate_type


class Staircasing(Tidy3dBaseModel):
    """Disable subpixel averaging (nearest-neighbor permittivity)."""


class PolarizedAveraging(Tidy3dBaseModel):
    """Polarized subpixel averaging: harmonic along the interface normal,
    arithmetic transverse (implemented from the structure SDFs)."""


class VolumetricAveraging(Tidy3dBaseModel):
    """Simple volume-fraction averaging of permittivity."""


class HeuristicPECStaircasing(Tidy3dBaseModel):
    """Heuristic staircasing for PEC interfaces."""


class PECConformal(Tidy3dBaseModel):
    """Conformal mesh scheme for PEC interfaces (Benkler); the courant number
    is reduced accordingly."""

    timestep_reduction: float = pydantic.Field(0.3, ge=0, lt=1)

    def courant_ratio(self) -> float:
        return 1.0 - self.timestep_reduction


SubpixelType = Union[Staircasing, PolarizedAveraging, VolumetricAveraging]
PECSubpixelType = Union[Staircasing, HeuristicPECStaircasing, PECConformal]


class SubpixelSpec(Tidy3dBaseModel):
    """Per-material-type subpixel averaging selection."""

    dielectric: annotate_type(SubpixelType) = pydantic.Field(
        default_factory=PolarizedAveraging, title="Dielectric scheme")
    metal: annotate_type(Union[Staircasing, VolumetricAveraging]) = pydantic.Field(
        default_factory=Staircasing, title="Lossy-metal scheme")
    pec: annotate_type(PECSubpixelType) = pydantic.Field(
        default_factory=HeuristicPECStaircasing, title="PEC scheme")
    lossy_metal: annotate_type(Union[Staircasing, VolumetricAveraging]) = pydantic.Field(
        default_factory=Staircasing, title="Lossy metal scheme")

    @classmethod
    def staircasing(cls) -> "SubpixelSpec":
        return cls(dielectric=Staircasing(), metal=Staircasing(),
                   pec=Staircasing(), lossy_metal=Staircasing())

    def courant_ratio(self, contain_pec_structures: bool = False) -> float:
        if contain_pec_structures and isinstance(self.pec, PECConformal):
            return self.pec.courant_ratio()
        return 1.0
