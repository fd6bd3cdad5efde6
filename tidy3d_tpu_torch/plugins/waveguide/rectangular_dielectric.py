"""RectangularDielectric: convenience mode analysis of strip/rib/slot guides.

Behavioral model: tidy3d v2.7.6 plugins/waveguide/
rectangular_dielectric.py (RectangularDielectric:34 — geometry construction +
auto grid + ModeSolver wiring with n_eff/mode-field accessors).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import pydantic

from ...components.base import Tidy3dBaseModel, cached_property
from ...components.boundary import Boundary, BoundarySpec
from ...components.geometry.base import Box
from ...components.grid.grid_spec import GridSpec
from ...components.medium import Medium, MediumType
from ...components.mode import ModeSpec
from ...components.simulation import Simulation
from ...components.structure import Structure
from ...components.types import ArrayFloat1D, Coordinate, Size1D, annotate_type
from ...constants import C_0, inf
from ...exceptions import SetupError, ValidationError
from ..mode.mode_solver import ModeSolver


class RectangularDielectric(Tidy3dBaseModel):
    """Rectangular dielectric waveguide (strip / rib / slot) mode helper."""

    wavelength: Union[float, ArrayFloat1D] = pydantic.Field(..., title="Wavelength(s) [um]")
    core_width: Union[float, ArrayFloat1D] = pydantic.Field(..., title="Core width(s)")
    core_thickness: float = pydantic.Field(..., title="Core thickness")
    core_medium: annotate_type(MediumType) = pydantic.Field(..., title="Core medium")
    clad_medium: annotate_type(MediumType) = pydantic.Field(
        default_factory=Medium, title="Top cladding medium")
    box_medium: Optional[annotate_type(MediumType)] = pydantic.Field(
        None, title="Bottom cladding medium")
    slab_thickness: float = pydantic.Field(0.0, title="Rib slab thickness")
    clad_thickness: Optional[float] = pydantic.Field(None)
    box_thickness: Optional[float] = pydantic.Field(None)
    side_margin: Optional[float] = pydantic.Field(None)
    sidewall_angle: float = pydantic.Field(0.0, title="Sidewall angle [rad]")
    gap: Union[float, ArrayFloat1D] = pydantic.Field(0.0, title="Gap(s) between cores")
    mode_spec: ModeSpec = pydantic.Field(default_factory=ModeSpec)
    grid_resolution: int = pydantic.Field(15, title="Cells per wavelength")

    @cached_property
    def _wavelengths(self) -> np.ndarray:
        return np.atleast_1d(np.asarray(self.wavelength, dtype=float))

    @cached_property
    def _widths(self) -> np.ndarray:
        return np.atleast_1d(np.asarray(self.core_width, dtype=float))

    @cached_property
    def _gaps(self) -> np.ndarray:
        gaps = np.atleast_1d(np.asarray(self.gap, dtype=float))
        if len(gaps) == 1 and len(self._widths) > 1:
            gaps = np.full(len(self._widths) - 1, gaps[0])
        return gaps

    @cached_property
    def freqs(self) -> np.ndarray:
        return C_0 / self._wavelengths

    @cached_property
    def _margins(self) -> Tuple[float, float, float]:
        lam = float(self._wavelengths.max())
        side = self.side_margin if self.side_margin is not None else 1.5 * lam
        clad = self.clad_thickness if self.clad_thickness is not None else 1.5 * lam
        box = self.box_thickness if self.box_thickness is not None else 1.5 * lam
        return side, clad, box

    @cached_property
    def structures(self) -> Tuple[Structure, ...]:
        """Waveguide core(s) + optional slab, extruded along x."""
        side, clad, box = self._margins
        out = []
        box_med = self.box_medium or self.clad_medium
        # substrate/box fills the lower half space
        out.append(Structure(
            geometry=Box(center=(0, 0, -box / 2 - self.core_thickness / 2 - 1),
                         size=(inf, inf, box + 2)),
            medium=box_med, name="box"))
        if self.slab_thickness > 0:
            out.append(Structure(
                geometry=Box(center=(0, 0, -self.core_thickness / 2
                                     + self.slab_thickness / 2),
                             size=(inf, inf, self.slab_thickness)),
                medium=self.core_medium, name="slab"))
        # cores laid out along y
        total_width = float(np.sum(self._widths) + np.sum(self._gaps))
        y0 = -total_width / 2
        for ci, w in enumerate(self._widths):
            center_y = y0 + w / 2
            out.append(Structure(
                geometry=Box(center=(0, center_y, 0),
                             size=(inf, w, self.core_thickness)),
                medium=self.core_medium, name=f"core_{ci}"))
            y0 += w + (self._gaps[ci] if ci < len(self._gaps) else 0.0)
        return tuple(out)

    @cached_property
    def simulation(self) -> Simulation:
        side, clad, box = self._margins
        total_width = float(np.sum(self._widths) + np.sum(self._gaps))
        size_y = total_width + 2 * side
        size_z = self.core_thickness + clad + box
        lam = float(self._wavelengths.max())
        return Simulation(
            center=(0, 0, (clad - box) / 2),
            size=(2 * lam, size_y, size_z),
            run_time=1e-12,
            structures=self.structures,
            medium=self.clad_medium,
            boundary_spec=BoundarySpec.pec(),
            grid_spec=GridSpec.auto(wavelength=lam,
                                    min_steps_per_wvl=self.grid_resolution),
        )

    @cached_property
    def mode_solver(self) -> ModeSolver:
        side, clad, box = self._margins
        sim = self.simulation
        return ModeSolver(
            simulation=sim,
            plane=Box(center=sim.center, size=(0, sim.size[1], sim.size[2])),
            mode_spec=self.mode_spec,
            freqs=self.freqs.tolist(),
        )

    # convenience accessors
    @cached_property
    def mode_data(self):
        return self.mode_solver.data

    @property
    def n_eff(self):
        return self.mode_data.n_complex.real

    @property
    def n_complex(self):
        return self.mode_data.n_complex

    @property
    def n_group(self):
        return self.mode_data.n_group
