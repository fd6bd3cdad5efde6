"""EME simulation specification.

Behavioral model: tidy3d v2.7.6 components/eme/simulation.py
(EMESimulation:52 — propagation axis, EME grid, freqs, sweeps, ``_to_fdtd_sim``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import pydantic

from ...exceptions import SetupError
from ..base import cached_property
from ..boundary import Boundary, BoundarySpec, PECBoundary
from ..geometry.base import Box
from ..grid.grid_spec import GridSpec
from ..medium import Medium, MediumType3D
from ..simulation import Simulation
from ..structure import Structure
from ..types import Axis, FreqArray, annotate_type
from .grid import EMEGridSpecType, EMEModeSpec, EMEUniformGrid
from .sweep import EMESweepSpecType


class EMESimulation(Box):
    """Frequency-domain EigenMode Expansion simulation of a waveguide device."""

    medium: annotate_type(MediumType3D) = pydantic.Field(
        default_factory=Medium, title="Background medium")
    structures: Tuple[Structure, ...] = pydantic.Field((), title="Structures")
    axis: Axis = pydantic.Field(..., title="Propagation axis")
    freqs: FreqArray = pydantic.Field(..., title="Frequencies")
    eme_grid_spec: annotate_type(EMEGridSpecType) = pydantic.Field(
        default_factory=lambda: EMEUniformGrid(num_cells=1),
        title="EME grid specification")
    grid_spec: GridSpec = pydantic.Field(default_factory=GridSpec,
                                         title="Cross-section grid spec")
    monitors: Tuple = pydantic.Field((), title="Monitors")
    sweep_spec: Optional[annotate_type(EMESweepSpecType)] = pydantic.Field(
        None, title="Sweep specification")
    symmetry: Tuple[int, int, int] = pydantic.Field((0, 0, 0))
    constraint: Optional[str] = pydantic.Field(
        "passive", title="S-matrix constraint: passive | unitary | None")

    @pydantic.model_validator(mode="after")
    def _axis_has_extent(self):
        if self.size[self.axis] <= 0:
            raise SetupError("EME propagation axis must have nonzero extent")
        return self

    @cached_property
    def cell_boundaries(self) -> np.ndarray:
        lo = self.center[self.axis] - self.size[self.axis] / 2
        hi = self.center[self.axis] + self.size[self.axis] / 2
        return self.eme_grid_spec.make_boundaries(lo, hi)

    @cached_property
    def cell_centers(self) -> np.ndarray:
        b = self.cell_boundaries
        return 0.5 * (b[1:] + b[:-1])

    @cached_property
    def cell_lengths(self) -> np.ndarray:
        return np.diff(self.cell_boundaries)

    @cached_property
    def mode_specs(self) -> List[EMEModeSpec]:
        return self.eme_grid_spec.cell_mode_specs(len(self.cell_centers))

    def _to_fdtd_sim(self, run_time: float = 1e-12) -> Simulation:
        """Equivalent FDTD simulation (without sources), reference :1063."""
        return Simulation(
            center=self.center, size=self.size, run_time=run_time,
            medium=self.medium, structures=self.structures,
            grid_spec=self.grid_spec,
            boundary_spec=BoundarySpec.pec(),
            symmetry=self.symmetry,
        )
