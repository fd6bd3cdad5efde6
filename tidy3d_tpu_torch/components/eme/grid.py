"""EME cell decomposition along the propagation axis.

Behavioral model: tidy3d v2.7.6 components/eme/grid.py (EMEGrid:392;
uniform / explicit / composite specs, per-cell mode specs).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import pydantic

from ...components.base import Tidy3dBaseModel, cached_property
from ...components.mode import ModeSpec
from ...exceptions import ValidationError
from ...components.types import annotate_type


class EMEModeSpec(ModeSpec):
    """Mode spec for one EME cell (same fields as ModeSpec)."""


class EMEUniformGrid(Tidy3dBaseModel):
    """Uniformly divide the propagation span into num_cells."""

    num_cells: pydantic.PositiveInt = pydantic.Field(..., title="Number of cells")
    mode_spec: EMEModeSpec = pydantic.Field(default_factory=EMEModeSpec)

    def make_boundaries(self, lo: float, hi: float) -> np.ndarray:
        return np.linspace(lo, hi, self.num_cells + 1)

    def cell_mode_specs(self, num_cells: int) -> List[EMEModeSpec]:
        return [self.mode_spec] * num_cells


class EMEExplicitGrid(Tidy3dBaseModel):
    """Explicit interior cell boundaries."""

    boundaries: Tuple[float, ...] = pydantic.Field(..., title="Interior boundaries")
    mode_specs: Tuple[EMEModeSpec, ...] = pydantic.Field(..., title="Per-cell mode specs")

    @pydantic.model_validator(mode="after")
    def _check(self):
        if len(self.mode_specs) != len(self.boundaries) + 1:
            raise ValidationError("need len(boundaries) + 1 mode_specs")
        if np.any(np.diff(np.asarray(self.boundaries)) <= 0):
            raise ValidationError("boundaries must be increasing")
        return self

    def make_boundaries(self, lo: float, hi: float) -> np.ndarray:
        return np.concatenate([[lo], np.asarray(self.boundaries), [hi]])

    def cell_mode_specs(self, num_cells: int) -> List[EMEModeSpec]:
        return list(self.mode_specs)


class EMECompositeGrid(Tidy3dBaseModel):
    """Subgrids stitched along the axis."""

    subgrids: Tuple[Union[EMEUniformGrid, EMEExplicitGrid], ...] = pydantic.Field(...)
    subgrid_boundaries: Tuple[float, ...] = pydantic.Field(
        ..., title="Boundaries between subgrids")

    def make_boundaries(self, lo: float, hi: float) -> np.ndarray:
        bounds = [lo] + list(self.subgrid_boundaries) + [hi]
        out = [lo]
        for sub, s_lo, s_hi in zip(self.subgrids, bounds[:-1], bounds[1:]):
            sub_bounds = sub.make_boundaries(s_lo, s_hi)
            out.extend(sub_bounds[1:].tolist())
        return np.asarray(out)

    def cell_mode_specs(self, num_cells: int) -> List[EMEModeSpec]:
        specs: List[EMEModeSpec] = []
        bounds_count = None
        for sub in self.subgrids:
            if isinstance(sub, EMEUniformGrid):
                specs.extend([sub.mode_spec] * sub.num_cells)
            else:
                specs.extend(sub.mode_specs)
        return specs


EMEGridSpecType = Union[EMEUniformGrid, EMEExplicitGrid, EMECompositeGrid]
