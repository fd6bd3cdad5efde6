"""Structure = geometry + medium pairing.

Behavioral model: /root/reference/tidy3d/components/structure.py
(Structure:102, MeshOverrideStructure:591).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import pydantic

from ..exceptions import SetupError, ValidationError
from .base import Tidy3dBaseModel, cached_property
from .data.data_array import SpatialDataArray
from .geometry.base import Box, GeometryType
from .medium import CustomMedium, Medium, MediumType
from .types import Bound, Coordinate, annotate_type


class AbstractStructure(Tidy3dBaseModel):
    """Base of structures: a geometry plus display/meta info."""

    geometry: annotate_type(GeometryType) = pydantic.Field(
        ..., title="Geometry", description="Defines the structure's spatial extent."
    )
    name: Optional[str] = pydantic.Field(None, title="Name")


class Structure(AbstractStructure):
    """A geometry with an assigned medium."""

    medium: annotate_type(MediumType) = pydantic.Field(
        ..., title="Medium", description="Defines the electromagnetic properties."
    )
    background_permittivity: Optional[float] = pydantic.Field(
        None, ge=1.0, title="Background Permittivity",
        description="Relative permittivity used for the background of this "
        "structure when computing shape-derivative gradients.",
    )

    def eps_diagonal(self, frequency: float) -> Tuple[complex, complex, complex]:
        return self.medium.eps_diagonal(frequency)

    @cached_property
    def bounds(self) -> Bound:
        return self.geometry.bounds

    @classmethod
    def from_permittivity_array(cls, geometry: GeometryType, eps_data: np.ndarray,
                                **kwargs) -> "Structure":
        """Structure with a pixellated permittivity grid over its bounding box."""
        eps_data = np.asarray(eps_data)
        if eps_data.ndim != 3:
            raise ValidationError("eps_data must be a 3D array")
        rmin, rmax = geometry.bounds
        coords = {}
        for dim, lo, hi, n in zip("xyz", rmin, rmax, eps_data.shape):
            centers = np.linspace(lo, hi, 2 * n + 1)[1::2] if n > 0 else np.array([0.5 * (lo + hi)])
            coords[dim] = centers
        permittivity = SpatialDataArray(eps_data, coords=coords)
        medium = CustomMedium(permittivity=permittivity)
        return cls(geometry=geometry, medium=medium, **kwargs)

    @property
    def viz_spec(self):
        return None

    # ------------------------------------------------------------------ #
    # shape-derivative adjoint protocol
    # ------------------------------------------------------------------ #

    def make_adjoint_monitors(self, freqs, index: int, pad: float = 0.0):
        """Gradient monitors over this structure's bounding box (padded by
        ``pad`` on every side so interface integrals can interpolate across
        the boundary): a raw (non-colocated) FieldMonitor plus a
        PermittivityMonitor (reference: structure.py make_adjoint_monitors:209)."""
        from .monitor import FieldMonitor, PermittivityMonitor

        rmin, rmax = self.geometry.bounds
        center = tuple(0.5 * (lo + hi) for lo, hi in zip(rmin, rmax))
        size = tuple((hi - lo) + 2 * pad for lo, hi in zip(rmin, rmax))
        kwargs = dict(center=center, size=size, freqs=list(freqs))
        fld = FieldMonitor(fields=["Ex", "Ey", "Ez"], colocate=False,
                           name=f"adjoint_fld_{index}", **kwargs)
        eps = PermittivityMonitor(name=f"adjoint_eps_{index}", **kwargs)
        return fld, eps

    def compute_derivatives(self, structure_paths, derivative_info) -> dict:
        """Dispatch adjoint gradients to geometry / medium
        (reference: structure.py compute_derivatives:244).

        ``structure_paths``: sequences like ('geometry', 'center') or
        ('medium', 'permittivity').
        """
        by_field = {}
        for path in structure_paths:
            by_field.setdefault(path[0], []).append(path[1])
        out = {}
        if "geometry" in by_field:
            grads = self.geometry.compute_derivatives(
                by_field["geometry"], derivative_info)
            for sub, val in grads.items():
                out[("geometry", sub)] = val
        if "medium" in by_field:
            grads = self.medium.compute_derivatives(
                by_field["medium"], derivative_info, self.geometry)
            for sub, val in grads.items():
                out[("medium", sub)] = val
        return out


class MeshOverrideStructure(AbstractStructure):
    """A geometry with user-defined mesh step sizes (used by AutoGrid)."""

    dl: Tuple[Optional[pydantic.PositiveFloat], Optional[pydantic.PositiveFloat],
              Optional[pydantic.PositiveFloat]] = pydantic.Field(
        ..., title="Grid Size", description="Grid size along x, y, z; None = no override."
    )
    enforce: bool = pydantic.Field(
        False, title="Enforce Grid Size",
        description="Enforce this override even if finer grids are needed elsewhere.",
    )


StructureType = Union[Structure, MeshOverrideStructure]
