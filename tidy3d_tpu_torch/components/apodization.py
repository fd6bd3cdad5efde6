"""Apodization (time-windowing) spec for frequency-domain monitors.

Behavioral model: /root/reference/tidy3d/components/apodization.py
(ApodizationSpec:13 — gaussian ramp of width ``width`` before ``start`` and
after ``end``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pydantic

from ..exceptions import SetupError
from .base import Tidy3dBaseModel


class ApodizationSpec(Tidy3dBaseModel):
    """Gaussian apodization of the running DFT in time."""

    start: Optional[pydantic.NonNegativeFloat] = pydantic.Field(
        None, title="Start Interval", description="Time at which the start apodization ends [s]."
    )
    end: Optional[pydantic.NonNegativeFloat] = pydantic.Field(
        None, title="End Interval", description="Time at which the end apodization begins [s]."
    )
    width: Optional[pydantic.PositiveFloat] = pydantic.Field(
        None, title="Apodization Width", description="Gaussian ramp width [s]."
    )

    @pydantic.model_validator(mode="after")
    def _validate(self):
        if self.end is not None and self.start is not None and self.end < self.start:
            raise SetupError("End apodization begins before start apodization ends.")
        if (self.start is not None or self.end is not None) and self.width is None:
            raise SetupError("apodization width must be set when start/end apodization is used")
        return self

    def apodization_weights(self, times: np.ndarray) -> np.ndarray:
        """Window weights at the given times."""
        times = np.asarray(times)
        weights = np.ones_like(times, dtype=float)
        if self.start is not None:
            before = times < self.start
            weights = np.where(
                before, np.exp(-0.5 * ((times - self.start) / self.width) ** 2), weights
            )
        if self.end is not None:
            after = times > self.end
            weights = np.where(
                after, np.exp(-0.5 * ((times - self.end) / self.width) ** 2), weights
            )
        return weights

    def plot(self, times, ax=None):
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        ax.plot(times, self.apodization_weights(times))
        ax.set_xlabel("time (s)")
        ax.set_ylabel("apodization weight")
        return ax
