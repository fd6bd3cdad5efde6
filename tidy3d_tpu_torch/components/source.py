"""Sources: time dependences (GaussianPulse, CW, custom envelope) and spatial
source types (dipole, current/field sheets, mode, plane wave, Gaussian beams,
TFSF).

Behavioral model: /root/reference/tidy3d/components/source.py (hierarchy
:443-1204) and time.py (DTFT ``spectrum`` with kernel exp(+2j pi f t) over the
real part of the complex amplitude). Conventions preserved exactly so source
normalization matches the reference bit-for-bit.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Literal, Optional, Tuple, Union

import numpy as np
import pydantic

from ..constants import C_0, GLANCING_CUTOFF, inf
from ..exceptions import SetupError, ValidationError
from ..log import log
from .base import Tidy3dBaseModel, cached_property
from .data.data_array import TimeDataArray
from .geometry.base import Box
from .mode import ModeSpec
from .types import (
    ArrayComplex1D,
    ArrayFloat1D,
    Axis,
    Coordinate,
    Direction,
    FreqBound,
    Polarization,
    annotate_type,
)

# how many fwidths from freq0 until the spectrum is considered negligible
WIDTH_FACTOR = 5.0
# gaussian pulse is considered "off" after this many twidths past the peak
END_TIME_FACTOR_GAUSSIAN = 10.0
DFT_CUTOFF = 1e-8
# warn if source bandwidth covers more than this fraction of freq0
WARN_BANDWIDTH_FRAC = 0.5


class AbstractTimeDependence(Tidy3dBaseModel, ABC):
    """Complex-valued time dependence; only its real part drives the fields."""

    amplitude: pydantic.NonNegativeFloat = pydantic.Field(
        1.0, title="Amplitude", description="Real-valued maximum amplitude of the time dependence."
    )
    phase: float = pydantic.Field(
        0.0, title="Phase", description="Phase shift of the time dependence [rad]."
    )

    @abstractmethod
    def amp_time(self, time: float) -> complex:
        """Complex-valued amplitude at time [s]."""

    def spectrum(self, times: np.ndarray, freqs: np.ndarray, dt: float,
                 complex_fields: bool = False) -> np.ndarray:
        """Complex spectrum with kernel exp(+2j pi f t): DTFT of Re(amp_time),
        or of the full complex amp_time for complex-field (Bloch) runs, whose
        injected current is the analytic signal (reference: source.py
        spectrum:120 with the same complex_fields switch)."""
        times = np.asarray(times)
        freqs = np.asarray(freqs)
        amps = self.amp_time(times)
        time_amps = amps if complex_fields else np.real(amps)

        if np.all(time_amps == 0.0):
            return np.zeros_like(freqs, dtype=complex)

        # cut to the relevant time span for efficiency
        relevant = np.where(np.abs(time_amps) / np.max(np.abs(time_amps)) > DFT_CUTOFF)[0]
        if len(relevant) == 0:
            return np.zeros_like(freqs, dtype=complex)
        sl = slice(relevant[0], relevant[-1] + 1)
        time_amps = time_amps[sl]
        times_cut = times[sl]

        kernel = np.exp(2j * np.pi * freqs[None, :] * times_cut[:, None])
        return dt * np.sum(time_amps[:, None] * kernel, axis=0)

    def plot(self, times, val: str = "real", ax=None):
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        amps = self.amp_time(np.asarray(times))
        vals = {"real": np.real, "imag": np.imag, "abs": np.abs}[val](amps)
        ax.plot(times, vals)
        ax.set_xlabel("time (s)")
        return ax


class SourceTime(AbstractTimeDependence, ABC):
    """Base class describing the time dependence of a source."""

    @abstractmethod
    def frequency_range(self, num_fwidth: float = 4.0) -> FreqBound:
        """Frequency range within +/- num_fwidth * fwidth of freq0."""

    @abstractmethod
    def end_time(self) -> Optional[float]:
        """Time after which the source is effectively off."""


class Pulse(SourceTime, ABC):
    """Source time that ramps up with ``fwidth`` and oscillates at ``freq0``."""

    freq0: pydantic.PositiveFloat = pydantic.Field(
        ..., title="Central Frequency", description="[Hz]"
    )
    fwidth: pydantic.PositiveFloat = pydantic.Field(
        ..., title="Frequency Width", description="Std of frequency content [Hz]."
    )
    offset: float = pydantic.Field(
        5.0, ge=2.5, title="Offset",
        description="Delay of the peak in units of 1 / (2 pi fwidth).",
    )

    @property
    def twidth(self) -> float:
        """Width of the pulse in seconds."""
        return 1.0 / (2 * np.pi * self.fwidth)

    def frequency_range(self, num_fwidth: float = 4.0) -> FreqBound:
        freq_width_range = num_fwidth * self.fwidth
        return (max(0.0, self.freq0 - freq_width_range), self.freq0 + freq_width_range)


class GaussianPulse(Pulse):
    """Gaussian pulse with optional DC-component removal."""

    remove_dc_component: bool = pydantic.Field(
        True, title="Remove DC Component",
        description="Zero out the DC component of the pulse spectrum.",
    )

    def amp_time(self, time):
        time = np.asarray(time)
        omega0 = 2 * np.pi * self.freq0
        t_rel = time - self.offset * self.twidth

        phasor = self.amplitude * np.exp(1j * self.phase)
        carrier = np.exp(-1j * omega0 * time)
        envelope = np.exp(-(t_rel**2) / 2 / self.twidth**2)

        amp = phasor * carrier * envelope
        if self.remove_dc_component:
            return amp * (1j + t_rel / self.twidth**2 / omega0)
        return amp * 1j

    def end_time(self) -> Optional[float]:
        return self.offset * self.twidth + END_TIME_FACTOR_GAUSSIAN * self.twidth

    @property
    def amp_complex(self) -> complex:
        return self.amplitude * np.exp(1j * self.phase)

    @classmethod
    def from_amp_complex(cls, amp: complex, **kwargs) -> "GaussianPulse":
        return cls(amplitude=abs(amp), phase=float(np.angle(amp)), **kwargs)


class ContinuousWave(Pulse):
    """Ramp-up to continuous oscillation (fields never decay)."""

    def amp_time(self, time):
        time = np.asarray(time)
        twidth = self.twidth
        omega0 = 2 * np.pi * self.freq0
        t_rel = time - self.offset * twidth
        phasor = self.amplitude * np.exp(1j * self.phase)
        carrier = np.exp(-1j * omega0 * time)
        ramp = 1 / (1 + np.exp(-t_rel / twidth))
        return phasor * carrier * ramp

    def end_time(self) -> Optional[float]:
        return None


class CustomSourceTime(Pulse):
    """Custom-envelope source: amp(t) = amplitude * e^{i phase} * e^{-i w0 t}
    * envelope(t), with the envelope sampled on a uniform time grid."""

    offset: float = pydantic.Field(0.0, title="Offset")  # type: ignore[assignment]
    source_time_dataset: Optional[dict] = pydantic.Field(
        None, title="Source time dataset",
        description="Dict with 'values' (complex array) and 'times' (s).",
    )

    @pydantic.field_validator("source_time_dataset", mode="before")
    @classmethod
    def _from_time_dataset(cls, val):
        """Accept the reference's TimeDataset layout (source.py:259: a
        'values' TimeDataArray on a 't' coord); a data-less placeholder
        (JSON-written file) degrades to None with a warning."""
        if isinstance(val, dict) and val.get("type") == "TimeDataset":
            inner = val.get("values")
            if isinstance(inner, str):  # DataArray placeholder
                log.warning("Loading 'source_time_dataset' without data.")
                return None
            if inner is None:
                return None
            values = np.asarray(getattr(inner, "values", inner))
            coords = getattr(inner, "coords", {})
            times = np.asarray(coords.get("t", np.arange(len(values))))
            return {"values": values, "times": times}
        return val

    @classmethod
    def from_values(cls, freq0: float, fwidth: float, values, dt: float, **kwargs):
        times = np.arange(len(np.asarray(values))) * dt
        return cls(
            freq0=freq0, fwidth=fwidth,
            source_time_dataset={"values": np.asarray(values), "times": times},
            **kwargs,
        )

    def amp_time(self, time):
        time = np.asarray(time, dtype=float)
        if self.source_time_dataset is None:
            return np.zeros_like(time, dtype=complex)
        data_times = np.asarray(self.source_time_dataset["times"], dtype=float)
        values = np.asarray(self.source_time_dataset["values"])
        envelope = np.interp(
            time - self.offset / (2 * np.pi * self.fwidth), data_times,
            np.real(values), left=0.0, right=0.0,
        ).astype(complex)
        if np.iscomplexobj(values):
            envelope += 1j * np.interp(
                time - self.offset / (2 * np.pi * self.fwidth), data_times,
                np.imag(values), left=0.0, right=0.0,
            )
        omega0 = 2 * np.pi * self.freq0
        return self.amplitude * np.exp(1j * self.phase) * np.exp(-1j * omega0 * time) * envelope

    def end_time(self) -> Optional[float]:
        if self.source_time_dataset is None:
            return None
        return float(np.max(np.asarray(self.source_time_dataset["times"])))


SourceTimeType = Union[GaussianPulse, ContinuousWave, CustomSourceTime]


# --------------------------------------------------------------------------- #
# spatial sources
# --------------------------------------------------------------------------- #


class Source(Box, ABC):
    """Abstract base for all sources: a Box with a time dependence."""

    source_time: annotate_type(SourceTimeType) = pydantic.Field(
        ..., title="Source Time", description="Time dependence of the source."
    )
    name: Optional[str] = pydantic.Field(None, title="Name")

    @cached_property
    def _injection_axis(self) -> Optional[Axis]:
        return None

    @cached_property
    def _dir_vector(self) -> Optional[Tuple[float, float, float]]:
        return None

    def plot(self, *args, **kwargs):
        kwargs.setdefault("facecolor", "limegreen")
        return super().plot(*args, **kwargs)


class FieldSource(Source, ABC):
    """A source defined by electromagnetic fields."""


class CurrentSource(Source, ABC):
    """A source defined by current distributions."""

    polarization: Polarization = pydantic.Field(
        ..., title="Polarization", description="Which field component is injected."
    )
    interpolate: bool = pydantic.Field(
        True, title="Enable Interpolation",
        description="Interpolate the source between Yee points (vs snap to nearest).",
    )


class ReverseInterpolatedSource(Source):
    """Source interpolated with reversed weights onto the Yee grid."""

    interpolate: bool = pydantic.Field(True, title="Enable Interpolation")


class UniformCurrentSource(CurrentSource):
    """Volume current source with uniform current density in a Box."""


class PointDipole(CurrentSource):
    """Infinitesimal dipole: a zero-size UniformCurrentSource."""

    size: Tuple[Literal[0], Literal[0], Literal[0]] = pydantic.Field(
        (0, 0, 0), title="Size"
    )


class CustomCurrentSource(ReverseInterpolatedSource):
    """Current source with a custom spatial dataset (Ex..Hz components hold
    the injected current densities J and M)."""

    current_dataset: Optional[Any] = pydantic.Field(
        ..., title="Current Dataset",
        description="FieldDataset-like with components of J (E keys) and M (H keys)."
    )


class AngledFieldSource(FieldSource, ABC):
    """Field source with a direction and propagation angles."""

    direction: Direction = pydantic.Field(
        ..., title="Direction", description="'+' or '-' propagation along the injection axis."
    )

    @cached_property
    def _injection_axis(self) -> Axis:
        return self._plane_axis()

    @cached_property
    def angle_theta_actual(self) -> float:
        return getattr(self, "angle_theta", 0.0)

    @cached_property
    def _dir_vector(self) -> Tuple[float, float, float]:
        theta = getattr(self, "angle_theta", 0.0)
        phi = getattr(self, "angle_phi", 0.0)
        inj = self._injection_axis
        sign = 1.0 if self.direction == "+" else -1.0
        normal = sign * np.cos(theta)
        plane1 = np.sin(theta) * np.cos(phi)
        plane2 = np.sin(theta) * np.sin(phi)
        vec = [0.0, 0.0, 0.0]
        others = [a for a in range(3) if a != inj]
        vec[inj] = normal
        vec[others[0]] = plane1
        vec[others[1]] = plane2
        return tuple(vec)


class PlanarSource(Source, ABC):
    """Source defined on a plane (exactly one zero size dimension)."""

    @pydantic.model_validator(mode="after")
    def _is_plane(self):
        if tuple(self.size).count(0.0) != 1:
            raise ValidationError(f"{type(self).__name__} must be planar, given size={self.size}")
        return self

    @cached_property
    def injection_axis(self) -> Axis:
        return self._plane_axis()


class ModeSource(PlanarSource, AngledFieldSource):
    """Eigenmode injection source on a plane.

    The mode is computed by the native TPU mode solver; ``num_freqs`` > 1
    requests broadband injection via Chebyshev fitting of the mode fields.
    """

    mode_spec: ModeSpec = pydantic.Field(
        default_factory=ModeSpec, title="Mode Specification"
    )
    mode_index: pydantic.NonNegativeInt = pydantic.Field(
        0, title="Mode Index"
    )
    num_freqs: int = pydantic.Field(
        1, ge=1, le=20, title="Number of Frequency Points",
        description="Frequencies used to fit the mode field frequency dependence.",
    )

    @cached_property
    def angle_theta(self) -> float:
        return self.mode_spec.angle_theta

    @cached_property
    def angle_phi(self) -> float:
        return self.mode_spec.angle_phi


class BroadbandSource(Source, ABC):
    """Source with frequency-dependent field profiles."""

    num_freqs: int = pydantic.Field(1, ge=1, le=99, title="Number of Frequency Points")


class PlaneWave(AngledFieldSource, PlanarSource):
    """Uniform plane wave on an infinite extent plane."""

    angle_theta: float = pydantic.Field(
        0.0, title="Polar Angle", description="Angle of propagation from the injection axis."
    )
    angle_phi: float = pydantic.Field(
        0.0, title="Azimuth Angle"
    )
    pol_angle: float = pydantic.Field(
        0.0, title="Polarization Angle",
        description="Angle of E-field polarization in the plane orthogonal to propagation.",
    )

    @pydantic.field_validator("angle_theta")
    @classmethod
    def _glancing(cls, val):
        if np.abs(np.pi / 2 - val % np.pi) < GLANCING_CUTOFF:
            raise ValidationError("PlaneWave angle too close to glancing incidence.")
        return val


class GaussianBeam(AngledFieldSource, PlanarSource):
    """Gaussian beam with a planar phase front at the waist."""

    waist_radius: pydantic.PositiveFloat = pydantic.Field(
        1.0, title="Waist Radius", description="Radius of the beam at the waist [um]."
    )
    waist_distance: float = pydantic.Field(
        0.0, title="Waist Distance",
        description="Distance from the beam waist to the source plane along propagation.",
    )
    angle_theta: float = pydantic.Field(0.0, title="Polar Angle")
    angle_phi: float = pydantic.Field(0.0, title="Azimuth Angle")
    pol_angle: float = pydantic.Field(0.0, title="Polarization Angle")


class AstigmaticGaussianBeam(AngledFieldSource, PlanarSource):
    """Astigmatic Gaussian beam with independent waists along the plane axes."""

    waist_sizes: Tuple[pydantic.PositiveFloat, pydantic.PositiveFloat] = pydantic.Field(
        (1.0, 1.0), title="Waist sizes"
    )
    waist_distances: Tuple[float, float] = pydantic.Field(
        (0.0, 0.0), title="Waist distances"
    )
    angle_theta: float = pydantic.Field(0.0, title="Polar Angle")
    angle_phi: float = pydantic.Field(0.0, title="Azimuth Angle")
    pol_angle: float = pydantic.Field(0.0, title="Polarization Angle")


class CustomFieldSource(PlanarSource, FieldSource):
    """Equivalence-principle injection from tangential E/H fields on a plane."""

    field_dataset: Optional[Any] = pydantic.Field(
        ..., title="Field Dataset",
        description="FieldDataset-like with tangential field components on the plane.",
    )


class TFSF(AngledFieldSource):
    """Total-field/scattered-field box injecting a plane wave with exact
    amplitude inside the box."""

    angle_theta: float = pydantic.Field(0.0, title="Polar Angle")
    angle_phi: float = pydantic.Field(0.0, title="Azimuth Angle")
    pol_angle: float = pydantic.Field(0.0, title="Polarization Angle")
    injection_axis: Axis = pydantic.Field(
        ..., title="Injection Axis", description="Axis of plane wave injection into the box."
    )

    @cached_property
    def _injection_axis(self) -> Axis:
        return self.injection_axis

    @cached_property
    def injection_plane_center(self) -> Coordinate:
        sign = 1 if self.direction == "-" else -1
        center = list(self.center)
        center[self.injection_axis] += sign * self.size[self.injection_axis] / 2
        return tuple(center)


SourceType = Union[
    UniformCurrentSource, PointDipole, GaussianBeam, AstigmaticGaussianBeam,
    ModeSource, PlaneWave, CustomFieldSource, CustomCurrentSource, TFSF,
]

for _model in (CustomCurrentSource, CustomFieldSource):
    _model.model_rebuild()
