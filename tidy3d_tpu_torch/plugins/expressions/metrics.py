"""Metrics: expression leaves evaluated on SimulationData.

Behavioral model: tidy3d v2.7.6 plugins/expressions/metrics.py
(ModeAmp:51, ModePower:119 — objective function pieces referencing monitors).
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import pydantic

from ...components.types import Direction, FreqArray
from .base import Expression


class Metric(Expression):
    """Expression leaf extracting a value from SimulationData."""

    monitor_name: str = pydantic.Field(..., title="Monitor name")

    @classmethod
    def from_mode_monitor(cls, monitor, mode_index: int = 0, direction: str = "+"):
        return cls(monitor_name=monitor.name, mode_index=mode_index,
                   direction=direction, f=list(np.asarray(monitor.freqs)))


class ModeAmp(Metric):
    """Complex mode amplitude from a ModeMonitor."""

    mode_index: int = pydantic.Field(0, title="Mode index")
    direction: Direction = pydantic.Field("+", title="Direction")
    f: Optional[FreqArray] = pydantic.Field(None, title="Frequencies")

    def evaluate(self, sim_data, *args, **kwargs):
        mode_data = sim_data[self.monitor_name]
        amps = mode_data.amps.sel(direction=self.direction)
        vals = amps.values[:, self.mode_index]
        if self.f is not None and len(np.atleast_1d(self.f)) == 1:
            freqs = np.asarray(amps.coords["f"])
            idx = int(np.argmin(np.abs(freqs - np.atleast_1d(self.f)[0])))
            return vals[idx]
        return vals


class ModePower(ModeAmp):
    """|mode amplitude|^2."""

    def evaluate(self, sim_data, *args, **kwargs):
        amp = super().evaluate(sim_data, *args, **kwargs)
        return np.abs(amp) ** 2


def generate_validation_data(expr: Expression):
    """Placeholder hook matching the reference's validation-data generator."""
    return None
