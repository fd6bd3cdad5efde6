"""Grid specifications: per-axis 1D specs + the top-level GridSpec.

Behavioral model: /root/reference/tidy3d/components/grid/grid_spec.py
(GridSpec:535, UniformGrid:212, CustomGrid:316, CustomGridBoundaries:272,
AutoGrid:386; PML extension :114, symmetry handling :140-210, source
wavelength inference :626).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import pydantic

from ...constants import C_0, fp_eps, inf
from ...exceptions import SetupError
from ...log import log
from ..base import Tidy3dBaseModel, cached_property
from ..types import ArrayFloat1D, Axis, Coordinate, Symmetry, annotate_type
from .grid import Coords, Grid
from .mesher import GradedMesher, Mesher


class GridSpec1d(Tidy3dBaseModel, ABC):
    """Abstract 1D grid spec along one axis."""

    def make_coords(
        self,
        axis: Axis,
        structures: list,
        symmetry: Tuple[Symmetry, Symmetry, Symmetry],
        periodic: bool,
        wavelength: float,
        num_pml_layers: Tuple[int, int],
        snapping_points: List[Coordinate] = (),
    ) -> np.ndarray:
        """Generate boundary coords along ``axis``, accounting for symmetry
        and extending into the PML layers."""
        # symmetry: mesh only the upper half of the domain, then mirror
        center = structures[0].geometry.center[axis]
        if symmetry[axis] != 0:
            structures = [self._shrink_to_half(structures[0], axis, center)] + list(
                structures[1:]
            )

        bound_coords = self._make_coords_initial(
            axis=axis, structures=structures, wavelength=wavelength,
            symmetry=symmetry, is_periodic=periodic, snapping_points=snapping_points,
        )

        if symmetry[axis] != 0:
            coords_right = bound_coords[bound_coords > center + fp_eps]
            bound_coords = np.concatenate(
                [(2 * center - coords_right)[::-1], [center], coords_right]
            )

        return self._add_pml_to_bounds(num_pml_layers, bound_coords)

    @staticmethod
    def _shrink_to_half(structure, axis: Axis, center: float):
        """Restrict the simulation box structure to its upper half along axis."""
        from ..geometry.base import Box

        rmin, rmax = structure.geometry.bounds
        if rmin[axis] >= center - fp_eps:
            return structure
        new_rmin = list(rmin)
        new_rmin[axis] = center
        new_box = Box.from_bounds(tuple(new_rmin), tuple(rmax))
        return structure.copy(update={"geometry": new_box})

    @abstractmethod
    def _make_coords_initial(self, axis, structures, wavelength, symmetry,
                             is_periodic, snapping_points) -> np.ndarray:
        """Boundary coords covering the simulation domain along axis."""

    @staticmethod
    def _add_pml_to_bounds(num_layers: Tuple[int, int], bounds: np.ndarray) -> np.ndarray:
        """Extend bounds by repeating the edge cell size into the PML."""
        if len(bounds) < 2:
            return bounds
        first_step = bounds[1] - bounds[0]
        last_step = bounds[-1] - bounds[-2]
        add_left = bounds[0] - first_step * np.arange(num_layers[0], 0, -1)
        add_right = bounds[-1] + last_step * np.arange(1, num_layers[1] + 1)
        return np.concatenate([add_left, bounds, add_right])

    @staticmethod
    def estimated_min_dl(*args, **kwargs) -> float:
        return 0.0


class UniformGrid(GridSpec1d):
    """Uniform grid with fixed step ``dl``."""

    dl: pydantic.PositiveFloat = pydantic.Field(
        ..., title="Grid Size", description="Grid size for uniform grid generation."
    )

    def _make_coords_initial(self, axis, structures, wavelength, symmetry,
                             is_periodic, snapping_points) -> np.ndarray:
        rmin, rmax = structures[0].geometry.bounds
        lo, hi = rmin[axis], rmax[axis]
        size = hi - lo
        num_cells = max(int(np.ceil(size / self.dl)), 1)
        # snap to grid size slightly smaller than dl for exact coverage
        dl_snapped = size / num_cells if size > 0 else self.dl
        return lo + np.arange(num_cells + 1) * dl_snapped


class CustomGrid(GridSpec1d):
    """Custom list of cell sizes centered on the simulation center."""

    dl: Tuple[pydantic.PositiveFloat, ...] = pydantic.Field(
        ..., title="Customized grid sizes"
    )
    custom_offset: Optional[float] = pydantic.Field(None, title="Customized offset")

    def _make_coords_initial(self, axis, structures, wavelength, symmetry,
                             is_periodic, snapping_points) -> np.ndarray:
        rmin, rmax = structures[0].geometry.bounds
        center = structures[0].geometry.center[axis]
        dl = np.asarray(self.dl)
        bounds = np.append(0.0, np.cumsum(dl))
        if self.custom_offset is None:
            bounds += center - bounds[-1] / 2
        else:
            bounds += self.custom_offset
        size = rmax[axis] - rmin[axis]
        if bounds[0] > rmin[axis] + fp_eps * size or bounds[-1] < rmax[axis] - fp_eps * size:
            log.warning("custom grid does not span the simulation domain along "
                        f"axis {axis}; cells will be added with the edge size.")
            while bounds[0] > rmin[axis]:
                bounds = np.concatenate([[bounds[0] - dl[0]], bounds])
            while bounds[-1] < rmax[axis]:
                bounds = np.concatenate([bounds, [bounds[-1] + dl[-1]]])
        return bounds


class CustomGridBoundaries(GridSpec1d):
    """Custom grid given by explicit boundary coordinates."""

    coords: ArrayFloat1D = pydantic.Field(..., title="Grid Boundary Coordinates")

    def _make_coords_initial(self, axis, structures, wavelength, symmetry,
                             is_periodic, snapping_points) -> np.ndarray:
        return np.asarray(self.coords)


class AutoGrid(GridSpec1d):
    """Automatic nonuniform grid: ``min_steps_per_wvl`` points per material
    wavelength, graded growth limited by ``max_scale``."""

    min_steps_per_wvl: float = pydantic.Field(
        10.0, title="Minimal number of steps per wavelength", ge=6.0,
    )
    max_scale: float = pydantic.Field(
        1.4, title="Maximum Grid Size Scaling", ge=1.2, lt=2.0,
    )
    dl_min: pydantic.NonNegativeFloat = pydantic.Field(
        0, title="Lower bound of grid size",
    )
    mesher: GradedMesher = pydantic.Field(
        default_factory=GradedMesher, title="Grid Construction Tool"
    )

    def _make_coords_initial(self, axis, structures, wavelength, symmetry,
                             is_periodic, snapping_points) -> np.ndarray:
        sim_geometry = structures[0].geometry
        rmin, rmax = sim_geometry.bounds
        domain_bounds = (rmin[axis], rmax[axis])

        # (bounds, max_dl) pairs for the mesher
        mesher_structures = []
        for structure in structures:
            if hasattr(structure, "dl"):  # MeshOverrideStructure
                dl_axis = structure.dl[axis]
                if dl_axis is not None:
                    mesher_structures.append((structure.geometry.bounds, float(dl_axis)))
                continue
            medium = structure.medium
            n, _ = _medium_index(medium, wavelength)
            max_dl = wavelength / max(n, 1.0) / self.min_steps_per_wvl
            mesher_structures.append((structure.geometry.bounds, max_dl))

        return self.mesher.make_coords(
            axis=axis,
            structures=mesher_structures,
            wavelength=wavelength,
            min_steps_per_wvl=self.min_steps_per_wvl,
            dl_min=self.dl_min,
            max_scale=self.max_scale,
            snapping_points=snapping_points,
            domain_bounds=domain_bounds,
        )


def _medium_index(medium, wavelength: float) -> Tuple[float, float]:
    """Max refractive index of a medium at the given wavelength."""
    freq = C_0 / wavelength
    try:
        if hasattr(medium, "eps_dataarray_freq"):
            eps_arrs = medium.eps_dataarray_freq(freq)
            eps_max = max(float(np.max(np.real(arr.values))) for arr in eps_arrs)
            return float(np.sqrt(max(eps_max, 1.0))), 0.0
        eps_list = medium.eps_diagonal(freq)
        n_max = 0.0
        for eps in eps_list:
            n, _ = medium.eps_complex_to_nk(eps)
            n_max = max(n_max, float(np.real(n)))
        # PEC reports huge eps; cap to 1 (mesh near PEC set by neighbors)
        if getattr(medium, "is_pec", False) or n_max > 1e3:
            n_max = 1.0
        return max(n_max, 1.0), 0.0
    except Exception:
        return 1.0, 0.0


GridType = Union[UniformGrid, CustomGrid, AutoGrid, CustomGridBoundaries]


class GridSpec(Tidy3dBaseModel):
    """Collective grid spec for all three dimensions."""

    grid_x: annotate_type(GridType) = pydantic.Field(
        default_factory=AutoGrid, title="Grid specification along x-axis"
    )
    grid_y: annotate_type(GridType) = pydantic.Field(
        default_factory=AutoGrid, title="Grid specification along y-axis"
    )
    grid_z: annotate_type(GridType) = pydantic.Field(
        default_factory=AutoGrid, title="Grid specification along z-axis"
    )
    wavelength: Optional[float] = pydantic.Field(
        None, title="Free-space wavelength",
        description="Wavelength for automatic nonuniform grid; inferred from "
        "sources if not provided.",
    )
    override_structures: Tuple[Any, ...] = pydantic.Field(
        (), title="Grid specification override structures",
    )

    @pydantic.field_validator("override_structures", mode="before")
    @classmethod
    def _parse_override_structures(cls, val):
        """Parse serialized dicts into Structure/MeshOverrideStructure
        models (reference grid_spec.py uses a StructureType union)."""
        if not val:
            return val
        from ..structure import MeshOverrideStructure, Structure

        out = []
        for item in val:
            if isinstance(item, dict):
                model = MeshOverrideStructure \
                    if item.get("type") == "MeshOverrideStructure" \
                    else Structure
                item = model.model_validate(item)
            out.append(item)
        return tuple(out)
    snapping_points: Tuple[Tuple[Optional[float], Optional[float], Optional[float]], ...] = (
        pydantic.Field((), title="Grid points to snap to")
    )

    @property
    def auto_grid_used(self) -> bool:
        return any(isinstance(g, AutoGrid) for g in (self.grid_x, self.grid_y, self.grid_z))

    @staticmethod
    def wavelength_from_sources(sources) -> float:
        """Define a wavelength based on the source central frequencies."""
        freqs = [source.source_time.freq0 for source in sources]
        if len(freqs) == 0:
            raise SetupError(
                "Automatic grid generation requires either a wavelength in "
                "'GridSpec' or at least one source in the simulation."
            )
        if max(freqs) - min(freqs) > 1e-5 * max(freqs):
            log.warning("Different source frequencies detected; using their average "
                        "for automatic grid generation.")
        return C_0 / np.mean(freqs)

    def make_grid(
        self,
        structures: list,
        symmetry: Tuple[Symmetry, Symmetry, Symmetry] = (0, 0, 0),
        periodic: Tuple[bool, bool, bool] = (False, False, False),
        sources: list = (),
        num_pml_layers: List[Tuple[int, int]] = ((0, 0), (0, 0), (0, 0)),
    ) -> Grid:
        """Generate the 3D Yee grid."""
        wavelength = self.wavelength
        if wavelength is None and self.auto_grid_used:
            wavelength = self.wavelength_from_sources(sources)

        all_structures = list(structures) + list(self.override_structures)

        coords = {}
        for axis, (key, grid_1d) in enumerate(
            zip("xyz", (self.grid_x, self.grid_y, self.grid_z))
        ):
            coords[key] = grid_1d.make_coords(
                axis=axis,
                structures=all_structures,
                symmetry=symmetry,
                periodic=periodic[axis],
                wavelength=wavelength if wavelength is not None else 1.0,
                num_pml_layers=num_pml_layers[axis],
                snapping_points=self.snapping_points,
            )

        return Grid(boundaries=Coords(**coords))

    @classmethod
    def auto(
        cls,
        wavelength: float = None,
        min_steps_per_wvl: float = 10.0,
        max_scale: float = 1.4,
        override_structures: tuple = (),
        snapping_points: tuple = (),
        dl_min: float = 0,
        mesher: Mesher = None,
        **kwargs,
    ) -> "GridSpec":
        """Use the same AutoGrid along each direction."""
        mesher = mesher or GradedMesher()
        grid_1d = AutoGrid(min_steps_per_wvl=min_steps_per_wvl, max_scale=max_scale,
                           dl_min=dl_min, mesher=mesher)
        return cls(wavelength=wavelength, grid_x=grid_1d, grid_y=grid_1d, grid_z=grid_1d,
                   override_structures=override_structures,
                   snapping_points=snapping_points, **kwargs)

    @classmethod
    def uniform(cls, dl: float, **kwargs) -> "GridSpec":
        """Use the same uniform dl in each direction."""
        grid_1d = UniformGrid(dl=dl)
        return cls(grid_x=grid_1d, grid_y=grid_1d, grid_z=grid_1d, **kwargs)
