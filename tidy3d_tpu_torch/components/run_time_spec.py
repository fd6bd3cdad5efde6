"""Automatic run-time specification.

Behavioral model: the upstream tidy3d components/run_time_spec.py
(RunTimeSpec — estimate run time from source ring-down and domain transit)."""

from __future__ import annotations

import pydantic

from .base import Tidy3dBaseModel


class RunTimeSpec(Tidy3dBaseModel):
    """Specifies how to automatically compute the simulation run time: a
    quality-factor-weighted number of domain traversals plus source ring-down."""

    quality_factor: pydantic.PositiveFloat = pydantic.Field(
        1.0, title="Quality factor",
        description="Expected quality factor of the structure resonances; the "
        "run time scales with it.",
    )
    source_factor: pydantic.PositiveFloat = pydantic.Field(
        3.0, title="Source factor",
        description="Multiplier of the source turn-off time included in the run.",
    )
