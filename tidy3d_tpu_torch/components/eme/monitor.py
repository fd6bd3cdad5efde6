"""EME monitors.

Behavioral model: tidy3d v2.7.6 components/eme/monitor.py
(EMEModeSolverMonitor:104, EMEFieldMonitor:187, EMECoefficientMonitor:249).
They inspect the EME expansion itself: the per-cell mode bases, the
propagated fields reconstructed from the expansion, and the forward /
backward mode coefficients in each cell.
"""

from __future__ import annotations

from typing import Optional, Union

import pydantic

from ..geometry.base import Box
from ..types import FreqArray

BYTES_COMPLEX = 8


class EMEMonitor(Box):
    """Abstract EME monitor (reference eme/monitor.py:23)."""

    name: str = pydantic.Field(..., title="Name", min_length=1)
    freqs: Optional[FreqArray] = pydantic.Field(
        None, title="Frequencies",
        description="Frequencies to record; None records all simulation "
        "frequencies.")
    num_modes: Optional[pydantic.NonNegativeInt] = pydantic.Field(
        None, title="Number of modes",
        description="Maximum number of modes to record; None records all.")
    colocate: bool = pydantic.Field(
        True, title="Colocate fields")


class EMEModeSolverMonitor(EMEMonitor):
    """Records the EME expansion modes of the cells intersecting the
    monitor geometry (reference eme/monitor.py:104). Unlike a
    ModeSolverMonitor it does not compute new modes."""

    eme_cell_interval_space: pydantic.PositiveInt = pydantic.Field(
        1, title="EME cell interval")
    normalize: bool = pydantic.Field(
        True, title="Normalize modes to unity flux")

    def storage_size(self, num_transverse_cells: int, num_eme_cells: int,
                     num_freqs: int, num_modes: int, num_sweep: int = 1) -> int:
        return (6 * BYTES_COMPLEX * num_transverse_cells * num_eme_cells
                * num_freqs * num_modes * num_sweep)


class EMEFieldMonitor(EMEMonitor):
    """Records the propagated field reconstructed from the EME expansion
    (reference eme/monitor.py:187): per excitation port and per input
    port-mode index."""

    def storage_size(self, num_cells: int, num_freqs: int, num_modes: int,
                     num_sweep: int = 1) -> int:
        return 6 * BYTES_COMPLEX * num_cells * num_freqs * num_modes * 2 \
            * num_sweep


class EMECoefficientMonitor(EMEMonitor):
    """Records the forward/backward mode coefficients in each EME cell
    intersecting the monitor geometry (reference eme/monitor.py:249)."""

    eme_cell_interval_space: pydantic.PositiveInt = pydantic.Field(
        1, title="EME cell interval")

    def storage_size(self, num_eme_cells: int, num_freqs: int,
                     num_modes: int, num_sweep: int = 1) -> int:
        return (2 * BYTES_COMPLEX * num_eme_cells * num_freqs
                * num_modes**2 * num_sweep)


EMEMonitorType = Union[EMEModeSolverMonitor, EMEFieldMonitor,
                       EMECoefficientMonitor]
