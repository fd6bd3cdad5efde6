"""Space-time modulation of material parameters.

Behavioral model: the upstream tidy3d components/time_modulation.py
(SpaceTimeModulation:204, ModulationSpec:265 — separable CW(t) x amp(x)
modulation of eps/sigma).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import pydantic

from ..exceptions import ValidationError
from .base import Tidy3dBaseModel, cached_property
from .data.data_array import SpatialDataArray
from .types import InterpMethod, annotate_type


class ContinuousWaveTimeModulation(Tidy3dBaseModel):
    """Harmonic modulation cos(2 pi f t + phase) with given amplitude."""

    freq0: pydantic.PositiveFloat = pydantic.Field(..., title="Modulation frequency")
    amplitude: pydantic.NonNegativeFloat = pydantic.Field(1.0, title="Amplitude")
    phase: float = pydantic.Field(0.0, title="Phase")

    def amp_time(self, time) -> np.ndarray:
        return self.amplitude * np.cos(2 * np.pi * self.freq0 * np.asarray(time)
                                       + self.phase)

    @property
    def max_modulation(self) -> float:
        return self.amplitude


class SpatialModulationUniform(Tidy3dBaseModel):
    """Uniform spatial modulation profile."""

    amplitude: pydantic.NonNegativeFloat = pydantic.Field(1.0)
    phase: float = pydantic.Field(0.0)

    @property
    def max_modulation(self) -> float:
        return self.amplitude


class SpatialModulationCustom(Tidy3dBaseModel):
    """Spatially varying modulation amplitude/phase."""

    amplitude: Union[pydantic.NonNegativeFloat, SpatialDataArray] = pydantic.Field(1.0)
    phase: Union[float, SpatialDataArray] = pydantic.Field(0.0)
    interp_method: InterpMethod = pydantic.Field("nearest")

    @property
    def max_modulation(self) -> float:
        if isinstance(self.amplitude, SpatialDataArray):
            return float(np.max(np.abs(self.amplitude.values)))
        return float(self.amplitude)


SpatialModulationType = Union[SpatialModulationUniform, SpatialModulationCustom]
TimeModulationType = ContinuousWaveTimeModulation


class SpaceTimeModulation(Tidy3dBaseModel):
    """Separable delta(x, t) = amp(x) * cw(t) modulation."""

    space_modulation: annotate_type(SpatialModulationType) = pydantic.Field(
        default_factory=SpatialModulationUniform)
    time_modulation: TimeModulationType = pydantic.Field(..., title="Time modulation")

    @property
    def max_modulation(self) -> float:
        return self.space_modulation.max_modulation * self.time_modulation.max_modulation

    @property
    def negligible_modulation(self) -> bool:
        return self.max_modulation == 0.0


class ModulationSpec(Tidy3dBaseModel):
    """Modulations applied to permittivity and/or conductivity."""

    permittivity: Optional[SpaceTimeModulation] = pydantic.Field(None)
    conductivity: Optional[SpaceTimeModulation] = pydantic.Field(None)

    @pydantic.model_validator(mode="after")
    def _same_frequency(self):
        if self.permittivity is not None and self.conductivity is not None:
            f_eps = self.permittivity.time_modulation.freq0
            f_sig = self.conductivity.time_modulation.freq0
            if not np.isclose(f_eps, f_sig):
                raise ValidationError(
                    "permittivity and conductivity modulations must share freq0")
        return self

    @property
    def applied_modulation(self) -> bool:
        return self.permittivity is not None or self.conductivity is not None
