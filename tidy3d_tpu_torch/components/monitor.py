"""Monitors: frequency- and time-domain field recording, flux, mode amps,
permittivity, far-field projections, diffraction.

Behavioral model: /root/reference/tidy3d/components/monitor.py (:47-1400):
same class names/fields, ``interval_space`` downsampling, ``colocate``
semantics, storage estimates, apodization spec.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Literal, Optional, Tuple, Union

import numpy as np
import pydantic

from ..constants import HERTZ, SECOND, inf
from ..exceptions import SetupError, ValidationError
from ..log import log
from .apodization import ApodizationSpec
from .base import Tidy3dBaseModel, cached_property
from .geometry.base import Box
from .mode import ModeSpec
from .types import ArrayFloat1D, Axis, Direction, EMField, FreqArray, ObsGridArray

BYTES_REAL = 4
BYTES_COMPLEX = 8


class Monitor(Box, ABC):
    """Abstract base for all monitors."""

    name: str = pydantic.Field(
        ..., title="Name", min_length=1, description="Unique name for monitor."
    )
    interval_space: Tuple[pydantic.PositiveInt, pydantic.PositiveInt, pydantic.PositiveInt] = (
        pydantic.Field(
            (1, 1, 1), title="Spatial Interval",
            description="Subsampling stride along x, y, z.",
        )
    )
    colocate: bool = pydantic.Field(
        True, title="Colocate Fields",
        description="Colocate fields to grid cell boundaries (primal grid).",
    )

    @cached_property
    def plot_params(self):
        return None

    @abstractmethod
    def storage_size(self, num_cells: int, tmesh: np.ndarray) -> int:
        """Estimated size in bytes of the monitor data."""

    def downsample(self, arr: np.ndarray, axis: Axis) -> np.ndarray:
        """Downsample a coordinate array per ``interval_space``."""
        size = len(arr)
        interval = self.interval_space[axis]
        if interval == 1 or size < 4:
            return arr
        inds = np.arange(0, size, interval)
        if inds[-1] != size - 1:
            inds = np.append(inds, size - 1)
        return arr[inds]

    def downsampled_num_cells(self, num_cells: Tuple[int, int, int]) -> Tuple[int, ...]:
        return tuple(len(self.downsample(np.arange(n), axis=a))
                     for a, n in enumerate(num_cells))


class FreqMonitor(Monitor, ABC):
    """Monitor recording frequency-domain data."""

    freqs: FreqArray = pydantic.Field(
        ..., title="Frequencies", description="Frequencies at which to record [Hz]."
    )
    apodization: ApodizationSpec = pydantic.Field(
        default_factory=ApodizationSpec, title="Apodization Specification"
    )

    @pydantic.field_validator("freqs")
    @classmethod
    def _freqs_nonempty(cls, val):
        if len(val) == 0:
            raise ValidationError("'freqs' must not be empty")
        if np.any(np.asarray(val) <= 0):
            raise ValidationError("'freqs' must be positive")
        return val


class TimeMonitor(Monitor, ABC):
    """Monitor recording time-domain data."""

    start: pydantic.NonNegativeFloat = pydantic.Field(
        0.0, title="Start time", description="[s]"
    )
    stop: Optional[pydantic.NonNegativeFloat] = pydantic.Field(
        None, title="Stop time", description="[s]"
    )
    interval: Optional[pydantic.PositiveInt] = pydantic.Field(
        None, title="Time interval",
        description="Sampling rate in time steps (None -> every step).",
    )

    @pydantic.model_validator(mode="after")
    def _stop_ge_start(self):
        if self.stop is not None and self.stop < self.start:
            raise SetupError("Monitor stop time is before start time.")
        return self

    def time_inds(self, tmesh: np.ndarray) -> Tuple[int, int]:
        """(start, stop) step indices sampled by the monitor."""
        tmesh = np.asarray(tmesh)
        tind_beg = int(np.searchsorted(tmesh, self.start, side="left"))
        stop = self.stop if self.stop is not None else tmesh[-1]
        tind_end = int(np.searchsorted(tmesh, stop, side="right"))
        return (tind_beg, tind_end)

    def num_steps(self, tmesh: np.ndarray) -> int:
        tind_beg, tind_end = self.time_inds(tmesh)
        interval = self.interval or 1
        return max((tind_end - tind_beg + interval - 1) // interval, 0)


class AbstractFieldMonitor(Monitor, ABC):
    """Monitor recording vector field components."""

    fields: Tuple[EMField, ...] = pydantic.Field(
        ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"), title="Field Components",
    )

    @pydantic.field_validator("fields")
    @classmethod
    def _nonempty(cls, val):
        if len(val) == 0:
            raise ValidationError("'fields' must not be empty")
        return val


class FieldMonitor(AbstractFieldMonitor, FreqMonitor):
    """Frequency-domain E/H fields in a volume/plane/point region."""

    def storage_size(self, num_cells: int, tmesh=None) -> int:
        return BYTES_COMPLEX * num_cells * len(np.asarray(self.freqs)) * len(self.fields)


class FieldTimeMonitor(AbstractFieldMonitor, TimeMonitor):
    """Time-domain E/H fields."""

    def storage_size(self, num_cells: int, tmesh: np.ndarray) -> int:
        return BYTES_REAL * num_cells * self.num_steps(tmesh) * len(self.fields)


class PermittivityMonitor(FreqMonitor):
    """Diagonal complex relative permittivity on the Yee grid."""

    colocate: Literal[False] = pydantic.Field(False, title="Colocate Fields")

    def storage_size(self, num_cells: int, tmesh=None) -> int:
        return BYTES_COMPLEX * num_cells * len(np.asarray(self.freqs)) * 3


class SurfaceIntegrationMonitor(Monitor, ABC):
    """Monitor integrating fields over a surface (plane or box surfaces)."""

    normal_dir: Optional[Direction] = pydantic.Field(
        None, title="Normal vector orientation",
        description="Direction of integration normal for planar monitors.",
    )
    exclude_surfaces: Optional[Tuple[Literal["x-", "x+", "y-", "y+", "z-", "z+"], ...]] = (
        pydantic.Field(None, title="Excluded surfaces")
    )

    @property
    def integration_surfaces(self):
        """Surfaces comprising the monitor (itself if planar)."""
        if tuple(self.size).count(0.0) == 1:
            return [self]
        # carry all monitor fields over to the surface monitors
        base_kwargs = {
            k: getattr(self, k) for k in self.__pydantic_fields__
            if k not in ("center", "size", "name", "type", "exclude_surfaces", "normal_dir")
        }
        surfaces = []
        excluded = set(self.exclude_surfaces or ())
        for axis in range(3):
            if self.size[axis] >= inf / 2:
                # an infinite axis has no terminating surfaces (they would sit
                # at +/- inf); the side faces capture everything in practice
                continue
            for sign, tag in zip((-1, 1), ("-", "+")):
                key = f"{'xyz'[axis]}{tag}"
                if key in excluded:
                    continue
                s_center = list(self.center)
                s_center[axis] += sign * self.size[axis] / 2
                s_size = list(self.size)
                s_size[axis] = 0.0
                surfaces.append(type(self)(
                    center=tuple(s_center), size=tuple(s_size),
                    name=f"{self.name}_{key}", normal_dir=tag, **base_kwargs,
                ))
        return surfaces

    @pydantic.model_validator(mode="after")
    def _normal_dir_exclude_surfaces(self):
        num_zero = tuple(self.size).count(0.0)
        if num_zero > 1:
            raise ValidationError(
                f"Integration monitor '{self.name}' has more than one zero dimension."
            )
        if num_zero == 1:
            if self.exclude_surfaces is not None:
                raise SetupError("exclude_surfaces only applies to box monitors")
        elif self.normal_dir is not None:
            raise SetupError("normal_dir only applies to planar monitors")
        return self


class AbstractFluxMonitor(SurfaceIntegrationMonitor, ABC):
    """Poynting flux through the monitor surface(s)."""


class FluxMonitor(AbstractFluxMonitor, FreqMonitor):
    """Frequency-domain power flux."""

    def storage_size(self, num_cells: int, tmesh=None) -> int:
        return BYTES_REAL * len(np.asarray(self.freqs))


class FluxTimeMonitor(AbstractFluxMonitor, TimeMonitor):
    """Time-domain power flux."""

    def storage_size(self, num_cells: int, tmesh: np.ndarray) -> int:
        return BYTES_REAL * self.num_steps(tmesh)


class ModeMonitor(FreqMonitor):
    """Mode amplitude decomposition of fields on a plane."""

    mode_spec: ModeSpec = pydantic.Field(..., title="Mode Specification")
    store_fields_direction: Optional[Direction] = pydantic.Field(
        None, title="Store mode fields",
    )
    colocate: Literal[False] = pydantic.Field(False, title="Colocate Fields")

    @pydantic.model_validator(mode="after")
    def _is_planar(self):
        if tuple(self.size).count(0.0) != 1:
            raise ValidationError(f"ModeMonitor '{self.name}' must be planar.")
        return self

    def storage_size(self, num_cells: int, tmesh=None) -> int:
        return 3 * BYTES_COMPLEX * len(np.asarray(self.freqs)) * self.mode_spec.num_modes


class ModeSolverMonitor(FreqMonitor):
    """Mode fields (and n_eff) computed on a plane."""

    mode_spec: ModeSpec = pydantic.Field(..., title="Mode Specification")
    direction: Direction = pydantic.Field("+", title="Propagation direction")
    colocate: bool = pydantic.Field(True, title="Colocate fields")

    @pydantic.model_validator(mode="after")
    def _is_planar(self):
        if tuple(self.size).count(0.0) != 1:
            raise ValidationError(f"ModeSolverMonitor '{self.name}' must be planar.")
        return self

    def storage_size(self, num_cells: int, tmesh=None) -> int:
        return 6 * BYTES_COMPLEX * num_cells * len(np.asarray(self.freqs)) \
            * self.mode_spec.num_modes


class AbstractFieldProjectionMonitor(SurfaceIntegrationMonitor, FreqMonitor):
    """Far-field projection monitor base."""

    custom_origin: Optional[Tuple[float, float, float]] = pydantic.Field(
        None, title="Local origin",
    )
    far_field_approx: bool = pydantic.Field(
        True, title="Far field approximation",
    )
    window_size: Tuple[pydantic.NonNegativeFloat, pydantic.NonNegativeFloat] = pydantic.Field(
        (0, 0), title="Spatial filtering window size",
    )
    medium: Optional[Any] = pydantic.Field(None, title="Projection medium")

    @property
    def projection_surfaces(self):
        return [s for s in self.integration_surfaces]

    @property
    def local_origin(self) -> Tuple[float, float, float]:
        return self.custom_origin if self.custom_origin is not None else self.center


class FieldProjectionAngleMonitor(AbstractFieldProjectionMonitor):
    """Far fields at spherical angles (theta, phi) on a sphere of radius
    proj_distance."""

    proj_distance: float = pydantic.Field(1e6, title="Projection distance")
    theta: ObsGridArray = pydantic.Field(..., title="Polar angles")
    phi: ObsGridArray = pydantic.Field(..., title="Azimuth angles")

    def storage_size(self, num_cells: int, tmesh=None) -> int:
        return 6 * BYTES_COMPLEX * len(np.asarray(self.theta)) * len(np.asarray(self.phi)) \
            * len(np.asarray(self.freqs))


class FieldProjectionCartesianMonitor(AbstractFieldProjectionMonitor):
    """Far fields on a cartesian plane at distance proj_distance."""

    proj_axis: Axis = pydantic.Field(..., title="Projection plane axis")
    proj_distance: float = pydantic.Field(1e6, title="Projection distance")
    x: ObsGridArray = pydantic.Field(..., title="Local x observation coords")
    y: ObsGridArray = pydantic.Field(..., title="Local y observation coords")

    def storage_size(self, num_cells: int, tmesh=None) -> int:
        return 6 * BYTES_COMPLEX * len(np.asarray(self.x)) * len(np.asarray(self.y)) \
            * len(np.asarray(self.freqs))


class FieldProjectionKSpaceMonitor(AbstractFieldProjectionMonitor):
    """Far fields in reciprocal (ux, uy) space."""

    proj_axis: Axis = pydantic.Field(..., title="Projection plane axis")
    proj_distance: float = pydantic.Field(1e6, title="Projection distance")
    ux: ObsGridArray = pydantic.Field(..., title="Normalized kx")
    uy: ObsGridArray = pydantic.Field(..., title="Normalized ky")

    @pydantic.field_validator("ux", "uy")
    @classmethod
    def _u_in_range(cls, val):
        if np.any(np.abs(np.asarray(val)) > 1):
            raise ValidationError("ux/uy must be in [-1, 1]")
        return val

    def storage_size(self, num_cells: int, tmesh=None) -> int:
        return 6 * BYTES_COMPLEX * len(np.asarray(self.ux)) * len(np.asarray(self.uy)) \
            * len(np.asarray(self.freqs))


class DiffractionMonitor(FreqMonitor):
    """Diffraction order amplitudes for periodic structures."""

    normal_dir: Direction = pydantic.Field(
        "+", title="Normal vector orientation",
    )
    colocate: Literal[False] = pydantic.Field(False, title="Colocate fields")

    @pydantic.model_validator(mode="after")
    def _is_planar_infinite(self):
        if tuple(self.size).count(0.0) != 1:
            raise ValidationError(f"DiffractionMonitor '{self.name}' must be planar.")
        return self

    def storage_size(self, num_cells: int, tmesh=None) -> int:
        return BYTES_COMPLEX * len(np.asarray(self.freqs)) * 10


MonitorType = Union[
    FieldMonitor, FieldTimeMonitor, PermittivityMonitor, FluxMonitor, FluxTimeMonitor,
    ModeMonitor, ModeSolverMonitor, FieldProjectionAngleMonitor,
    FieldProjectionCartesianMonitor, FieldProjectionKSpaceMonitor, DiffractionMonitor,
]
