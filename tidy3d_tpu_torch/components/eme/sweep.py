"""EME sweep specifications (reference: components/eme/sweep.py)."""

from __future__ import annotations

from typing import Tuple, Union

import pydantic

from ..base import Tidy3dBaseModel
from ..types import ArrayFloat1D


class EMELengthSweep(Tidy3dBaseModel):
    """Sweep the total device length by scaling all cell lengths."""

    scale_factors: ArrayFloat1D = pydantic.Field(..., title="Length scale factors")


class EMEModeSweep(Tidy3dBaseModel):
    """Sweep the number of modes retained (convergence check)."""

    num_modes: Tuple[int, ...] = pydantic.Field(..., title="Mode counts")


class EMEFreqSweep(Tidy3dBaseModel):
    """Sweep via perturbative frequency scaling."""

    freq_scale_factors: ArrayFloat1D = pydantic.Field(..., title="Frequency scales")


EMESweepSpecType = Union[EMELengthSweep, EMEModeSweep, EMEFreqSweep]
