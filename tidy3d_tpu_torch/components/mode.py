"""Mode specification for mode sources/monitors/solver.

Behavioral model: /root/reference/tidy3d/components/mode.py (ModeSpec:18).
"""

from __future__ import annotations

from typing import Literal, Optional, Tuple, Union

import numpy as np
import pydantic

from ..constants import GLANCING_CUTOFF
from ..exceptions import SetupError, ValidationError
from ..log import log
from .base import Tidy3dBaseModel
from .types import Axis2D, TrackFreq

GROUP_INDEX_STEP = 0.005


class ModeSpec(Tidy3dBaseModel):
    """Specification of mode properties for a mode solve / source / monitor."""

    num_modes: pydantic.PositiveInt = pydantic.Field(
        1, title="Number of modes", description="Number of modes returned by mode solver."
    )
    target_neff: Optional[pydantic.PositiveFloat] = pydantic.Field(
        None, title="Target effective index", description="Guess for effective index of the mode."
    )
    num_pml: Tuple[pydantic.NonNegativeInt, pydantic.NonNegativeInt] = pydantic.Field(
        (0, 0), title="Number of PML layers",
        description="Number of standard PML layers on the two mode-plane axes.",
    )
    filter_pol: Optional[Literal["te", "tm"]] = pydantic.Field(
        None, title="Polarization filtering",
        description="Sort modes with the selected polarization fraction > 0.5 first.",
    )
    angle_theta: float = pydantic.Field(
        0.0, title="Polar Angle", description="Polar angle of propagation axis from plane normal."
    )
    angle_phi: float = pydantic.Field(
        0.0, title="Azimuth Angle", description="Azimuth angle of propagation axis in the plane."
    )
    precision: Literal["single", "double"] = pydantic.Field(
        "single", title="Solver Precision",
    )
    bend_radius: Optional[float] = pydantic.Field(
        None, title="Bend radius",
        description="Radius of the circular bend of the mode plane center (signed).",
    )
    bend_axis: Optional[Axis2D] = pydantic.Field(
        None, title="Bend axis",
        description="Axis normal to the bend plane, in the two plane axes (0 or 1).",
    )
    track_freq: Optional[TrackFreq] = pydantic.Field(
        "central", title="Mode Tracking Frequency",
        description="Frequency at which mode sorting is anchored (None disables tracking).",
    )
    group_index_step: Union[bool, pydantic.PositiveFloat] = pydantic.Field(
        False, title="Group index step",
        description="Control the computation of the group index alongside the "
        "effective index; True uses the default step.",
    )

    @pydantic.field_validator("bend_radius")
    @classmethod
    def _bend_radius_not_zero(cls, val):
        if val is not None and np.isclose(val, 0):
            raise ValidationError("The magnitude of 'bend_radius' must be larger than 0.")
        return val

    @pydantic.field_validator("angle_theta")
    @classmethod
    def _glancing_incidence(cls, val):
        if np.abs(np.pi / 2 - val % np.pi) < GLANCING_CUTOFF:
            raise ValidationError(
                "Mode propagation axis too close to glancing angle for accurate injection."
            )
        return val

    @pydantic.model_validator(mode="after")
    def _bend_axis_given(self):
        if self.bend_radius is not None and self.bend_axis is None:
            raise ValidationError("'bend_axis' must be specified if 'bend_radius' is given")
        return self

    @pydantic.model_validator(mode="after")
    def _group_index_step(self):
        if self.group_index_step is True:
            object.__setattr__(self, "group_index_step", GROUP_INDEX_STEP)
        return self
