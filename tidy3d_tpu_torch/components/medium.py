"""Material models: nondispersive, dispersive (pole-residue family), PEC,
anisotropic, 2D sheets, spatially-custom media, and nonlinearities.

Behavioral model: /root/reference/tidy3d/components/medium.py (6.5k LoC;
AbstractMedium:619-920, PoleResidue:2843, Sellmeier:3584, Lorentz:3943,
Drude:4327, Debye:4579, AnisotropicMedium:4863, FullyAnisotropicMedium:5058,
Medium2D:6090, PEC:1454, nonlinearities :249-618). Same math conventions:
exp(-i w t) time dependence, eps(w) = eps_inf - sum_p [c_p/(jw+a_p) + c.c.],
eps_complex = eps_real + i sigma / (2 pi f eps_0).

The solver lowers these models to flat device arrays (eps/sigma grids and
per-pole ADE coefficient tables) in tidy3d_tpu/solver/lowering.py.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import pydantic

from ..constants import C_0, EPSILON_0, HBAR, MU_0, fp_eps, inf
from ..exceptions import SetupError, ValidationError
from ..log import log
from .autograd.derivative_utils import quad_weights
from .base import Tidy3dBaseModel, cached_property
from .data.data_array import ScalarFieldDataArray, SpatialDataArray
from .data.unstructured import TetrahedralGridDataset, TriangularGridDataset

# spatial data accepted by custom media: Cartesian or unstructured
# (reference dataset.py:2857 CustomSpatialDataType)
CustomSpatialDataType = Union[SpatialDataArray, TriangularGridDataset,
                              TetrahedralGridDataset]
from .types import (
    Axis,
    Bound,
    Complex,
    FreqBound,
    InterpMethod,
    PoleAndResidue,
    TensorReal,
    annotate_type,
)

# evaluation frequency representing "infinity"
FREQ_EVAL_INF = 1e50
# tolerance for gain checks
LOSS_TOL = -1e-12


def _not_loaded(field) -> bool:
    """Whether a serialized custom-data field came in as a data-less
    placeholder — reference-written '.json' files strip DataArrays to
    their type-name string (reference medium.py:1376 ``_not_loaded``)."""
    from .base import DATA_ARRAY_MAP

    if isinstance(field, str) and field in DATA_ARRAY_MAP:
        return True
    if isinstance(field, dict) and field.get("type") in (
            "TriangularGridDataset", "TetrahedralGridDataset"):
        return any(isinstance(sub, str) and sub in DATA_ARRAY_MAP
                   for sub in (field.get("points"), field.get("cells"),
                               field.get("values")))
    return False


def _vacuum_spatial() -> "SpatialDataArray":
    return SpatialDataArray(np.ones((1, 1, 1)),
                            coords=dict(x=[0], y=[0], z=[0]))


def _spatial_vals(arr) -> np.ndarray:
    """Raw numpy values of a SpatialDataArray or unstructured dataset."""
    if hasattr(arr, "points"):  # UnstructuredGridDataset
        return np.asarray(arr.values.values)
    return np.asarray(arr.values)


def ensure_freq_in_range(eps_model: Callable) -> Callable:
    """Decorator warning if the evaluation frequency is outside frequency_range."""

    def _eps_model(self, frequency):
        if frequency is None or (np.isscalar(frequency) and np.isinf(frequency)):
            frequency = FREQ_EVAL_INF
        if isinstance(frequency, np.ndarray):
            frequency = frequency.astype(float)
            frequency = np.where(np.isinf(frequency), FREQ_EVAL_INF, frequency)
        if self.frequency_range is not None:
            fmin, fmax = self.frequency_range
            if np.any(np.asarray(frequency) < fmin * (1 - fp_eps)) or np.any(
                np.asarray(frequency) > fmax * (1 + fp_eps)
            ):
                log.warning(
                    f"frequency passed to '{type(self).__name__}.eps_model()' is outside of "
                    "the medium's 'frequency_range'.",
                    log_once=True,
                )
        return eps_model(self, frequency)

    return _eps_model


class NonlinearModel(Tidy3dBaseModel, ABC):
    """Base of nonlinear material responses."""

    def _validate_medium(self, medium):
        pass


class NonlinearSusceptibility(NonlinearModel):
    """Chi3 instantaneous nonlinear susceptibility (reference: medium.py:249)."""

    chi3: float = pydantic.Field(0.0, title="Chi3", description="Chi3 nonlinear susceptibility [um^2/V^2].")
    numiters: Optional[pydantic.PositiveInt] = pydantic.Field(None, title="Number of iterations (deprecated)")


class TwoPhotonAbsorption(NonlinearModel):
    """Two-photon absorption + free-carrier effects (reference: medium.py:318)."""

    beta: Complex = pydantic.Field(0.0, title="TPA coefficient", description="[um/W]")
    tau: pydantic.NonNegativeFloat = pydantic.Field(0.0, title="Carrier lifetime")
    sigma: pydantic.NonNegativeFloat = pydantic.Field(0.0, title="FCA cross section")
    e_c: pydantic.NonNegativeFloat = pydantic.Field(0.0)
    e_v: pydantic.NonNegativeFloat = pydantic.Field(0.0)
    c_e: float = pydantic.Field(0.0)
    c_h: float = pydantic.Field(0.0)
    n0: Optional[Complex] = pydantic.Field(None, title="Complex linear index")


class KerrNonlinearity(NonlinearModel):
    """Intensity-dependent index n = n0 + n2 |E|^2 (reference: medium.py:468)."""

    n2: Complex = pydantic.Field(0.0, title="Nonlinear index", description="[um^2/W]")
    n0: Optional[Complex] = pydantic.Field(None, title="Complex linear index")


NonlinearModelType = Union[NonlinearSusceptibility, TwoPhotonAbsorption, KerrNonlinearity]


class NonlinearSpec(Tidy3dBaseModel):
    """Nonlinear response specification (reference: medium.py:554-618)."""

    models: Tuple[annotate_type(NonlinearModelType), ...] = pydantic.Field(
        (), title="Nonlinear models"
    )
    num_iters: pydantic.PositiveInt = pydantic.Field(
        5, title="Number of fixed-point iterations per time step", le=100
    )


class AbstractMedium(Tidy3dBaseModel, ABC):
    """Base class of all mediums."""

    name: Optional[str] = pydantic.Field(None, title="Name")
    frequency_range: Optional[FreqBound] = pydantic.Field(
        None, title="Frequency Range", description="Range of validity [Hz]."
    )
    allow_gain: bool = pydantic.Field(
        False, title="Allow gain medium",
        description="Allow the medium to be active (amplifying).",
    )

    @pydantic.field_validator("allow_gain", mode="before")
    @classmethod
    def _allow_gain_none(cls, val):
        # the reference serializes AnisotropicMedium.allow_gain as None
        # (a derived property there, medium.py:4863); coerce on load
        return False if val is None else val
    nonlinear_spec: Optional[Union[NonlinearSpec, NonlinearModelType]] = pydantic.Field(
        None, title="Nonlinear spec"
    )
    modulation_spec: Optional[Any] = pydantic.Field(None, title="Modulation spec")
    heat_spec: Optional[Any] = pydantic.Field(None, title="Heat spec")

    @property
    def _nonlinear_models(self) -> List[NonlinearModel]:
        if self.nonlinear_spec is None:
            return []
        if isinstance(self.nonlinear_spec, NonlinearSpec):
            return list(self.nonlinear_spec.models)
        return [self.nonlinear_spec]

    # ------------------------------------------------------------------ #
    # permittivity models
    # ------------------------------------------------------------------ #

    @abstractmethod
    def eps_model(self, frequency: float) -> complex:
        """Complex relative permittivity at ``frequency`` (Hz)."""

    def nk_model(self, frequency: float) -> Tuple[float, float]:
        eps_complex = self.eps_model(frequency=frequency)
        return self.eps_complex_to_nk(eps_complex)

    def sigma_model(self, freq) -> complex:
        """Equivalent complex conductivity sigma = -i w eps0 (eps - eps_inf)
        (reference: medium.py AbstractMedium.sigma_model:944)."""
        freq = np.asarray(freq, dtype=float)
        eps_inf = getattr(self, "eps_inf", 1.0)
        eps = np.vectorize(self.eps_model)(freq) if freq.ndim else \
            self.eps_model(float(freq))
        return -2j * np.pi * freq * EPSILON_0 * (eps - eps_inf)

    def eps_diagonal(self, frequency: float) -> Tuple[complex, complex, complex]:
        """Diagonal components of the permittivity tensor at ``frequency``."""
        eps = self.eps_model(frequency)
        return (eps, eps, eps)

    def eps_comp(self, row: Axis, col: Axis, frequency: float) -> complex:
        if row == col:
            return self.eps_diagonal(frequency)[row]
        return 0j

    @cached_property
    def is_pec(self) -> bool:
        return False

    @property
    def is_isotropic(self) -> bool:
        return True

    @property
    def is_spatially_uniform(self) -> bool:
        return True

    @property
    def is_time_modulated(self) -> bool:
        return self.modulation_spec is not None

    @property
    def is_nonlinear(self) -> bool:
        return self.nonlinear_spec is not None

    @property
    def is_custom(self) -> bool:
        return False

    @property
    def is_fully_anisotropic(self) -> bool:
        return False

    @cached_property
    def n_cfl(self) -> float:
        """Index-of-refraction factor multiplying the CFL-stable time step."""
        return 1.0

    def sel_inside(self, bounds: Bound) -> "AbstractMedium":
        """Crop any spatial data inside bounds (no-op for uniform media)."""
        return self

    # ------------------------------------------------------------------ #
    # conversion helpers (reference: medium.py:954-1096)
    # ------------------------------------------------------------------ #

    @staticmethod
    def nk_to_eps_complex(n: float, k: float = 0.0) -> complex:
        eps_real = n**2 - k**2
        eps_imag = 2 * n * k
        return eps_real + 1j * eps_imag

    @staticmethod
    def eps_complex_to_nk(eps_c: complex) -> Tuple[float, float]:
        eps_c = np.asarray(eps_c, dtype=complex)
        ref_index = np.sqrt(eps_c)
        return np.real(ref_index), np.imag(ref_index)

    @staticmethod
    def nk_to_eps_sigma(n: float, k: float, freq: float) -> Tuple[float, float]:
        eps_complex = AbstractMedium.nk_to_eps_complex(n, k)
        eps_real, eps_imag = eps_complex.real, eps_complex.imag
        omega = 2 * np.pi * freq
        sigma = omega * eps_imag * EPSILON_0
        return eps_real, sigma

    @staticmethod
    def eps_sigma_to_eps_complex(eps_real: float, sigma: float, freq: float):
        if freq is None:
            return eps_real + 0j
        omega = 2 * np.pi * np.asarray(freq)
        return np.asarray(eps_real) + 1j * np.asarray(sigma) / omega / EPSILON_0

    @staticmethod
    def eps_complex_to_eps_sigma(eps_complex: complex, freq: float) -> Tuple[float, float]:
        eps_complex = np.asarray(eps_complex)
        omega = 2 * np.pi * freq
        return np.real(eps_complex), np.imag(eps_complex) * omega * EPSILON_0

    # plotting
    def plot(self, freqs, ax=None):
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        freqs = np.asarray(freqs)
        eps = np.array([self.eps_model(f) for f in freqs])
        n, k = self.eps_complex_to_nk(eps)
        ax.plot(freqs, n, label="n")
        ax.plot(freqs, k, label="k")
        ax.set_xlabel("frequency (Hz)")
        ax.legend()
        return ax

    def _validate_passivity(self, eps_imag: np.ndarray, name: str = "medium") -> None:
        if not self.allow_gain and np.any(np.asarray(eps_imag) < LOSS_TOL):
            raise ValidationError(
                f"{name} is active (gain). For passive medium, imaginary part of "
                "permittivity must be non-negative; set 'allow_gain=True' to bypass."
            )


class Medium(AbstractMedium):
    """Dispersionless medium: permittivity + conductivity.

    Reference: medium.py:1523.
    """

    permittivity: float = pydantic.Field(
        1.0, ge=0.0, title="Permittivity", description="Relative permittivity."
    )
    conductivity: float = pydantic.Field(
        0.0, title="Conductivity", description="Electric conductivity [S/um].",
    )

    @pydantic.model_validator(mode="after")
    def _passivity(self):
        if not self.allow_gain and self.conductivity < LOSS_TOL:
            raise ValidationError(
                "Negative conductivity (gain) requires 'allow_gain=True'."
            )
        return self

    @staticmethod
    def _eps_model(permittivity: float, conductivity: float, frequency: float) -> complex:
        return AbstractMedium.eps_sigma_to_eps_complex(permittivity, conductivity, frequency)

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        return self._eps_model(self.permittivity, self.conductivity, frequency)

    @classmethod
    def from_nk(cls, n: float, k: float, freq: float, **kwargs) -> "Medium":
        eps, sigma = AbstractMedium.nk_to_eps_sigma(n, k, freq)
        if eps < 1:
            log.warning("permittivity < 1 may cause instability; consider a dispersive fit.")
        return cls(permittivity=eps, conductivity=sigma, **kwargs)

    @cached_property
    def n_cfl(self) -> float:
        n, _ = self.eps_complex_to_nk(self.permittivity + 0j)
        return float(n)

    def compute_derivatives(self, paths, derivative_info, geometry) -> dict:
        """Adjoint gradients for 'permittivity' / 'conductivity': the
        per-cell dJ/deps map (Re[pref E_fwd E_adj] dV, verified against
        jax.grad through the solver) contracted with the exact rasterizer
        sensitivity (reference behavior: medium.py compute_derivatives:1146
        does the continuum volume integral instead).

        Permittivity enters every cell through the polarized-subpixel
        formula (d eps_cell/d eps_in via FD of ``raster_eps``); the
        conductivity contribution uses the arithmetic occupancy frac and
        the phasor conversion d(eps_eff)/d(sigma) = i / (omega eps_0)
        (e^{-i w t} convention).
        """
        from .autograd.derivative_utils import raster_eps

        info = derivative_info
        eps_in = float(np.real(info.eps_in))
        eps_out = float(np.real(info.eps_out))
        h = 1e-4 * max(abs(eps_in), 1.0)
        grad_eps = 0.0
        total_sigma = 0.0 + 0.0j
        for ci, comp in enumerate(("Ex", "Ey", "Ez")):
            coords = info.sample_coords(comp)
            cs = [np.asarray(coords[d], dtype=float) for d in "xyz"]
            if any(len(c) == 0 for c in cs):
                continue
            X, Y, Z = np.meshgrid(*cs, indexing="ij")
            # singleton axes integrate over that axis's actual cell size
            # (ZERO_DIM_CELL_SIZE=1.0 on flattened 2D axes — the solver's
            # per-unit-length convention), NOT dl_loc (a 3-axis mean that
            # underweights 2D sims by ~2.7x; caught by FD on a 2D sim)
            ws = [quad_weights(c, c[0] - 1e-12, c[-1] + 1e-12)
                  if len(c) > 1 else np.array([info.avg_dls[a]])
                  for a, c in enumerate(cs)]
            w3 = (ws[0][:, None, None] * ws[1][None, :, None]
                  * ws[2][None, None, :])
            e_prod = info.e_prod(comp, X, Y, Z) * w3
            if "permittivity" in paths:
                ep = raster_eps(geometry, cs, ci, info.dl_loc,
                                eps_in + h, eps_out, info.avg_dls)
                em = raster_eps(geometry, cs, ci, info.dl_loc,
                                eps_in - h, eps_out, info.avg_dls)
                grad_eps += np.sum(info.real_grad(e_prod)
                                   * (ep - em) / (2 * h))
            if "conductivity" in paths:
                sdf = np.broadcast_to(
                    np.asarray(geometry.sdf(X, Y, Z), float), X.shape)
                frac = np.clip(0.5 - sdf / info.dl_loc, 0.0, 1.0)
                total_sigma += np.sum(e_prod * frac)
        out = {}
        omega = 2 * np.pi * info.frequency
        for path in paths:
            if path == "permittivity":
                out[path] = grad_eps
            elif path == "conductivity":
                out[path] = info.real_grad(
                    total_sigma * (1j / (omega * EPSILON_0)))
            else:
                raise NotImplementedError(
                    f"Medium derivative for path {path!r} not supported")
        return out


class PECMedium(AbstractMedium):
    """Perfect electric conductor. All E components inside are zeroed.

    Reference: medium.py:1454.
    """

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        # behaves as high-conductivity medium for eps queries
        return 1 + 1j * 1e8

    @cached_property
    def n_cfl(self) -> float:
        return 1.0

    @cached_property
    def is_pec(self) -> bool:
        return True


# instance exported as td.PEC
PEC = PECMedium(name="PEC")


class DispersiveMedium(AbstractMedium, ABC):
    """Base for dispersive media convertible to pole-residue form."""

    @abstractmethod
    def _pole_residue_dict(self) -> Dict:
        """Dict defining the equivalent PoleResidue model."""

    @cached_property
    def pole_residue(self) -> "PoleResidue":
        return PoleResidue(**self._pole_residue_dict())

    @cached_property
    def n_cfl(self) -> float:
        eps_inf = self._pole_residue_dict().get("eps_inf", 1.0)
        return float(np.sqrt(max(float(np.min(np.real(eps_inf))), 0.0))) or 1.0

    @staticmethod
    def tuple_to_complex(value: Tuple[float, float]) -> complex:
        return value[0] + 1j * value[1]

    @staticmethod
    def complex_to_tuple(value: complex) -> Tuple[float, float]:
        return (value.real, value.imag)


class PoleResidue(DispersiveMedium):
    """Pole-residue dispersion model:
    eps(w) = eps_inf - sum_p [c_p / (j w + a_p) + c_p* / (j w + a_p*)].

    Reference: medium.py:2843 (incl. causality check Re(a) <= 0).
    """

    eps_inf: pydantic.PositiveFloat = pydantic.Field(
        1.0, title="Epsilon at Infinity"
    )
    poles: Tuple[PoleAndResidue, ...] = pydantic.Field(
        (), title="Poles", description="Tuple of (a_p, c_p) complex pairs."
    )

    @pydantic.field_validator("poles")
    @classmethod
    def _causality(cls, val):
        for a, _ in val:
            if np.real(a) > 0:
                raise ValidationError(
                    "For stability, all pole 'a' values must have non-positive real part."
                )
        return val

    @staticmethod
    def _eps_model(eps_inf, poles, frequency) -> complex:
        omega = 2 * np.pi * np.asarray(frequency)
        eps = eps_inf + 0 * omega + 0.0j
        for a, c in poles:
            eps = eps - c / (1j * omega + a)
            eps = eps - np.conj(c) / (1j * omega + np.conj(a))
        return eps

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        return self._eps_model(self.eps_inf, self.poles, frequency)

    def _pole_residue_dict(self) -> Dict:
        return dict(
            eps_inf=self.eps_inf, poles=self.poles,
            frequency_range=self.frequency_range, name=self.name,
            allow_gain=self.allow_gain,
        )

    @cached_property
    def n_cfl(self) -> float:
        return float(np.sqrt(self.eps_inf))

    @classmethod
    def from_medium(cls, medium: Medium) -> "PoleResidue":
        poles = []
        if medium.conductivity != 0:
            # conductivity as a pole at a=0: sigma/(eps0) / (j w) => c = -sigma/(2 eps0)
            poles = [(0j, 0.5 * medium.conductivity / EPSILON_0 + 0j)]
        return cls(eps_inf=medium.permittivity, poles=poles,
                   frequency_range=medium.frequency_range, name=medium.name)

    def to_medium(self, frequency: float = None) -> Medium:
        if frequency is None:
            if not self.poles:
                return Medium(permittivity=self.eps_inf)
            raise SetupError("frequency required to convert dispersive PoleResidue to Medium")
        eps_complex = self.eps_model(frequency)
        eps, sigma = self.eps_complex_to_eps_sigma(eps_complex, frequency)
        return Medium(permittivity=float(np.real(eps)), conductivity=float(sigma))

    @staticmethod
    def lo_to_eps_model(poles, eps_inf, frequency):
        omega = 2 * np.pi * frequency
        eps = eps_inf + 0j
        for w_lo, g_lo, w_to, g_to in poles:
            eps *= (w_lo**2 - omega**2 - 1j * omega * g_lo) / (
                w_to**2 - omega**2 - 1j * omega * g_to
            )
        return eps


class Sellmeier(DispersiveMedium):
    """Sellmeier model: n^2(lam) = 1 + sum_i B_i lam^2 / (lam^2 - C_i).

    Reference: medium.py:3584.
    """

    coeffs: Tuple[Tuple[float, pydantic.PositiveFloat], ...] = pydantic.Field(
        ..., title="Coefficients", description="(B_i, C_i [um^2]) pairs.",
    )

    def _n_model(self, frequency):
        wvl = C_0 / np.asarray(frequency)
        wvl2 = wvl**2
        n_squared = 1.0 + 0 * wvl2
        for B, C in self.coeffs:
            n_squared = n_squared + B * wvl2 / (wvl2 - C)
        return np.sqrt(n_squared.astype(complex))

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        n = self._n_model(frequency)
        return self.nk_to_eps_complex(n)

    def _pole_residue_dict(self) -> Dict:
        poles = []
        for B, C in self.coeffs:
            beta = 2 * np.pi * C_0 / np.sqrt(C)
            alpha = -0.5 * B * beta
            poles.append((1j * beta, 1j * alpha))
        return dict(eps_inf=1.0, poles=poles, frequency_range=self.frequency_range,
                    name=self.name, allow_gain=self.allow_gain)

    @classmethod
    def from_dispersion(cls, n: float, freq: float, dn_dwvl: float = 0, **kwargs) -> "Sellmeier":
        """Single-pole fit matching index and dispersion at one frequency."""
        if dn_dwvl >= 0:
            raise ValidationError("dn_dwvl must be smaller than zero")
        wvl = C_0 / freq
        nsqm1 = n**2 - 1
        c_coeff = -(wvl**3) * n * dn_dwvl / (nsqm1 - wvl * n * dn_dwvl)
        b_coeff = (wvl**2 - c_coeff) / wvl**2 * nsqm1
        return cls(coeffs=((b_coeff, c_coeff),), **kwargs)


class Lorentz(DispersiveMedium):
    """Lorentz model: eps(f) = eps_inf + sum_i de_i f_i^2 / (f_i^2 - 2j f delta_i - f^2).

    Reference: medium.py:3943.
    """

    eps_inf: pydantic.PositiveFloat = pydantic.Field(1.0, title="Epsilon at Infinity")
    coeffs: Tuple[Tuple[float, float, pydantic.NonNegativeFloat], ...] = pydantic.Field(
        ..., title="Coefficients", description="(de_i, f_i [Hz], delta_i [Hz]) triples."
    )

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        eps = self.eps_inf + 0j * np.asarray(frequency)
        f = np.asarray(frequency)
        for de, f0, delta in self.coeffs:
            eps = eps + de * f0**2 / (f0**2 - 2j * f * delta - f**2)
        return eps

    def _pole_residue_dict(self) -> Dict:
        poles = []
        for de, f0, delta in self.coeffs:
            w0 = 2 * np.pi * f0
            d = 2 * np.pi * delta
            if d > w0:
                r = np.sqrt(d * d - w0 * w0) + 0j
                a0, c0 = -d + r, 0.25 * de * w0**2 / r
                a1, c1 = -d - r, -c0
                poles += [(a0, c0), (a1, c1)]
            else:
                r = np.sqrt(w0 * w0 - d * d)
                a = -d - 1j * r
                c = 0.5j * de * w0**2 / r
                poles.append((a, c))
        return dict(eps_inf=self.eps_inf, poles=poles, frequency_range=self.frequency_range,
                    name=self.name, allow_gain=self.allow_gain)

    @classmethod
    def from_nk(cls, n: float, k: float, freq: float, **kwargs) -> "Lorentz":
        eps_complex = AbstractMedium.nk_to_eps_complex(n, k)
        fp = freq * 10
        eps_r = np.real(eps_complex)
        de = (eps_r - 1) * (fp**2 - freq**2) / fp**2
        delta = np.imag(eps_complex) * (fp**2 - freq**2) / (2 * freq * fp**2) * fp**2 / max(de, fp_eps) if de != 0 else 0.0
        return cls(eps_inf=1.0, coeffs=((de, fp, delta),), **kwargs)


class Drude(DispersiveMedium):
    """Drude model: eps(f) = eps_inf - sum_i f_i^2 / (f^2 + 1j f delta_i).

    Reference: medium.py:4327 (same (f_i, delta_i) convention as the
    reference's eps_model:4376).
    """

    eps_inf: pydantic.PositiveFloat = pydantic.Field(1.0, title="Epsilon at Infinity")
    coeffs: Tuple[Tuple[float, pydantic.PositiveFloat], ...] = pydantic.Field(
        ..., title="Coefficients", description="(f_i [Hz], delta_i [Hz]) pairs."
    )

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        eps = self.eps_inf + 0j * np.asarray(frequency)
        f = np.asarray(frequency)
        for fi, delta in self.coeffs:
            eps = eps - fi**2 / (f**2 + 1j * f * delta)
        return eps

    def _pole_residue_dict(self) -> Dict:
        poles = []
        for fi, delta in self.coeffs:
            wp = 2 * np.pi * fi
            g = 2 * np.pi * delta
            # -wp^2/(w^2 + jwg) = (wp^2/g)[1/(jw - g) - 1/(jw)]; with the
            # eps = eps_inf - sum[c/(jw+a) + c.c.] storage and REAL poles
            # (where +c.c. doubles the term), residues are +/- wp^2/(2g)
            c0 = 0.5 * wp**2 / g + 0j
            poles += [(0j, c0), (-g + 0j, -c0)]
        return dict(eps_inf=self.eps_inf, poles=poles, frequency_range=self.frequency_range,
                    name=self.name, allow_gain=self.allow_gain)


class Debye(DispersiveMedium):
    """Debye model: eps(f) = eps_inf + sum_i de_i / (1 - 2j pi f tau_i).

    Reference: medium.py:4579.
    """

    eps_inf: pydantic.PositiveFloat = pydantic.Field(1.0, title="Epsilon at Infinity")
    coeffs: Tuple[Tuple[float, pydantic.PositiveFloat], ...] = pydantic.Field(
        ..., title="Coefficients", description="(de_i, tau_i [s]) pairs."
    )

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        # NOTE reference convention (medium.py:4644): de/(1 - 1j f tau) with
        # f in Hz (no 2 pi)
        eps = self.eps_inf + 0j * np.asarray(frequency)
        f = np.asarray(frequency)
        for de, tau in self.coeffs:
            eps = eps + de / (1 - 1j * f * tau)
        return eps

    def _pole_residue_dict(self) -> Dict:
        # de/(1 - i f tau) = -de (2 pi/tau)/(s - 2 pi/tau) with s = j omega;
        # as -2c/(s + a) with real pole: a = -2 pi/tau, c = de pi/tau
        poles = []
        for de, tau in self.coeffs:
            poles.append((-2 * np.pi / tau + 0j, np.pi * de / tau + 0j))
        return dict(eps_inf=self.eps_inf, poles=poles, frequency_range=self.frequency_range,
                    name=self.name, allow_gain=self.allow_gain)


# --------------------------------------------------------------------------- #
# custom (spatially varying) media
# --------------------------------------------------------------------------- #


class CustomIsotropicMedium(AbstractMedium):
    """Isotropic nondispersive medium with spatially varying eps/sigma
    (internal; reference: medium.py:1702)."""

    permittivity: Optional[SpatialDataArray] = pydantic.Field(None, title="Permittivity")
    conductivity: Optional[SpatialDataArray] = pydantic.Field(None, title="Conductivity")
    interp_method: InterpMethod = pydantic.Field("nearest", title="Interpolation method")

    @property
    def is_spatially_uniform(self) -> bool:
        return False

    @property
    def is_custom(self) -> bool:
        return True

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        eps = np.mean(self.permittivity.values) if self.permittivity is not None else 1.0
        sigma = np.mean(self.conductivity.values) if self.conductivity is not None else 0.0
        return self.eps_sigma_to_eps_complex(eps, sigma, frequency)

    @cached_property
    def n_cfl(self) -> float:
        eps_min = float(np.min(self.permittivity.values)) if self.permittivity is not None else 1.0
        n, _ = self.eps_complex_to_nk(eps_min + 0j)
        return float(n)

    def eps_dataarray_freq(self, frequency: float) -> Tuple[SpatialDataArray, ...]:
        eps = self.permittivity
        sigma = self.conductivity
        if eps is None:
            raise SetupError("permittivity data missing")
        omega = 2 * np.pi * frequency
        eps_c = eps.values.astype(complex)
        if sigma is not None:
            eps_c = eps_c + 1j * sigma.values / omega / EPSILON_0
        arr = SpatialDataArray(eps_c, coords=eps.coords)
        return (arr, arr, arr)

    def sel_inside(self, bounds: Bound) -> "CustomIsotropicMedium":
        update = {}
        if self.permittivity is not None:
            update["permittivity"] = self.permittivity.sel_inside(bounds)
        if self.conductivity is not None:
            update["conductivity"] = self.conductivity.sel_inside(bounds)
        return self.copy(update=update)


class CustomMedium(AbstractMedium):
    """Medium with user-supplied permittivity distribution.

    Reference: medium.py:1784.
    """

    eps_dataset: Optional[Any] = pydantic.Field(
        None, title="Permittivity dataset (legacy)",
    )
    permittivity: Optional[CustomSpatialDataType] = pydantic.Field(
        None, title="Permittivity", description="Spatial relative permittivity (>= 1)."
    )
    conductivity: Optional[CustomSpatialDataType] = pydantic.Field(
        None, title="Conductivity", description="Spatial conductivity [S/um]."
    )
    interp_method: InterpMethod = pydantic.Field(
        "nearest", title="Interpolation method",
        description="Interpolation used when mapping data onto the Yee grid.",
    )
    subpixel: bool = pydantic.Field(
        False, title="Subpixel averaging",
        description="Apply subpixel averaging of this medium at structure interfaces.",
    )

    @pydantic.model_validator(mode="before")
    @classmethod
    def _warn_if_unloaded(cls, values):
        """Reference medium.py ``_warn_if_none``: a data-less placeholder
        (JSON-written file) degrades to a vacuum medium with a warning."""
        if not isinstance(values, dict):
            return values
        fail = False
        for fld in ("permittivity", "conductivity"):
            if _not_loaded(values.get(fld)):
                log.warning(f"Loading '{fld}' without data; constructing "
                            "a vacuum medium instead.")
                fail = True
        eps_dataset = values.get("eps_dataset")
        if isinstance(eps_dataset, dict) and any(
                _not_loaded(v) for v in eps_dataset.values()):
            log.warning("Loading 'eps_dataset' without data; constructing "
                        "a vacuum medium instead.")
            fail = True
        if fail:
            return dict(permittivity=_vacuum_spatial())
        return values

    @pydantic.model_validator(mode="after")
    def _check_data(self):
        if self.permittivity is None and self.eps_dataset is None:
            raise ValidationError("CustomMedium requires 'permittivity' data.")
        return self

    @property
    def is_spatially_uniform(self) -> bool:
        return False

    @property
    def is_custom(self) -> bool:
        return True

    @classmethod
    def from_nk(cls, n: SpatialDataArray, k: SpatialDataArray = None, freq: float = None,
                **kwargs) -> "CustomMedium":
        n_vals = np.asarray(n.values)
        k_vals = np.asarray(k.values) if k is not None else np.zeros_like(n_vals)
        eps, sigma = AbstractMedium.nk_to_eps_sigma(n_vals, k_vals, freq)
        return cls(
            permittivity=SpatialDataArray(eps, coords=n.coords),
            conductivity=SpatialDataArray(sigma, coords=n.coords),
            **kwargs,
        )

    @classmethod
    def from_eps_raw(cls, eps: SpatialDataArray, freq: float = None, **kwargs) -> "CustomMedium":
        eps_values = np.asarray(eps.values)
        if np.iscomplexobj(eps_values):
            if freq is None:
                raise SetupError("freq required for complex eps input")
            eps_real, sigma = AbstractMedium.eps_complex_to_eps_sigma(eps_values, freq)
            return cls(
                permittivity=SpatialDataArray(eps_real, coords=eps.coords),
                conductivity=SpatialDataArray(sigma, coords=eps.coords),
                **kwargs,
            )
        return cls(permittivity=SpatialDataArray(eps_values, coords=eps.coords), **kwargs)

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        eps = float(np.mean(np.real(_spatial_vals(self.permittivity))))
        sigma = float(np.mean(np.real(_spatial_vals(self.conductivity)))) \
            if self.conductivity is not None else 0.0
        return self.eps_sigma_to_eps_complex(eps, sigma, frequency)

    def eps_dataarray_freq(self, frequency: float) -> Tuple[Any, ...]:
        omega = 2 * np.pi * frequency
        eps_c = _spatial_vals(self.permittivity).astype(complex)
        if self.conductivity is not None:
            eps_c = eps_c + 1j * _spatial_vals(self.conductivity) \
                / omega / EPSILON_0
        if hasattr(self.permittivity, "points"):  # unstructured dataset
            arr = self.permittivity._with_values(eps_c)
        else:
            arr = SpatialDataArray(eps_c, coords=self.permittivity.coords)
        return (arr, arr, arr)

    def eps_diagonal_on_grid(self, frequency: float, coords) -> Tuple[np.ndarray, ...]:
        """Diagonal eps evaluated at arbitrary grid coords (Coords object or dict)."""
        arrs = self.eps_dataarray_freq(frequency)
        out = []
        for arr in arrs:
            if hasattr(arr, "points"):  # unstructured: barycentric interp
                interp = arr.interp(x=np.asarray(coords.x),
                                    y=np.asarray(coords.y),
                                    z=np.asarray(coords.z))
            else:
                interp = arr.interp(
                    x=np.asarray(coords.x), y=np.asarray(coords.y),
                    z=np.asarray(coords.z),
                    method=self.interp_method
                    if self.interp_method != "nearest" else "nearest",
                )
            out.append(interp.values)
        return tuple(out)

    @cached_property
    def n_cfl(self) -> float:
        eps_min = float(np.min(np.real(_spatial_vals(self.permittivity))))
        n, _ = self.eps_complex_to_nk(eps_min + 0j)
        return float(max(n, 0.0)) or 1.0

    def sel_inside(self, bounds: Bound) -> "CustomMedium":
        update = {}
        for fld in ("permittivity", "conductivity"):
            arr = getattr(self, fld)
            if arr is not None and hasattr(arr, "sel_inside"):
                update[fld] = arr.sel_inside(bounds)
        return self.copy(update=update)

    def compute_derivatives(self, paths, derivative_info, geometry) -> dict:
        """Per-data-point adjoint gradients of the spatial permittivity /
        conductivity arrays (reference behavior: CustomMedium
        ``_derivative_field_cmp``, medium.py:2043): the per-cell sensitivity
        map Re[pref E_fwd E_adj] dV, evaluated at each E component's Yee
        samples inside the geometry, scattered back onto the data grid with
        the SAME interpolation stencil the rasterizer uses forward
        (nearest / trilinear, lowering.py:543-553) — the exact transpose of
        the data -> Yee-coefficient map, so gradients are exact to the
        discretization (FD-validated in test_topology_adjoint.py).

        This is the production inverse-design path: both solves run forward
        on the Pallas kernels (no AD tracing), unlike
        ``plugins/adjoint/topology.py``'s ``jax.grad`` route which drops to
        the XLA kernels.
        """
        from .autograd.derivative_utils import quad_weights

        info = derivative_info
        data = self.permittivity
        dcoords = [np.asarray(data.coords[d], dtype=float) for d in "xyz"]
        dshape = tuple(len(c) for c in dcoords)
        want_eps = "permittivity" in paths
        want_sigma = "conductivity" in paths
        grad_eps = np.zeros(dshape)
        grad_sigma = np.zeros(dshape) if want_sigma else None
        omega = 2 * np.pi * info.frequency
        linear = self.interp_method == "linear"

        for comp in ("Ex", "Ey", "Ez"):
            coords = info.sample_coords(comp)
            cs = [np.asarray(coords[d], dtype=float) for d in "xyz"]
            if any(len(c) == 0 for c in cs):
                continue
            X, Y, Z = np.meshgrid(*cs, indexing="ij")
            # singleton-axis weight = that axis's cell size (see the same
            # convention in Medium.compute_derivatives above)
            ws = [quad_weights(c, c[0] - 1e-12, c[-1] + 1e-12)
                  if len(c) > 1 else np.array([info.avg_dls[a]])
                  for a, c in enumerate(cs)]
            w3 = (ws[0][:, None, None] * ws[1][None, :, None]
                  * ws[2][None, None, :])
            inside = np.broadcast_to(
                np.asarray(geometry.inside(X, Y, Z), bool), X.shape)
            e_prod = np.where(inside, info.e_prod(comp, X, Y, Z) * w3, 0.0)

            # per-axis interpolation stencils of sample -> data points
            stencils = []  # per axis: list of (index_array, weight_array)
            for ax in range(3):
                dc = dcoords[ax]
                sc = cs[ax]
                if len(dc) == 1:
                    stencils.append([(np.zeros(len(sc), int),
                                      np.ones(len(sc)))])
                    continue
                if linear:
                    i = np.clip(np.searchsorted(dc, sc) - 1, 0, len(dc) - 2)
                    f = np.clip((sc - dc[i]) / (dc[i + 1] - dc[i]), 0.0, 1.0)
                    stencils.append([(i, 1.0 - f), (i + 1, f)])
                else:
                    # nearest: replicate DataArray.interp's comparison
                    # BIT-EXACTLY (searchsorted + strict '<' favoring the
                    # upper point on ties). Midpoint-based assignment
                    # breaks ties the other way, and ties are the NORM
                    # here: design data sits at cell centers, so every
                    # staggered Yee sample is exactly equidistant between
                    # two data points — a mismatched tie-break scatters
                    # whole components one cell off (FD showed 2x errors)
                    idx = np.clip(np.searchsorted(dc, sc), 0, len(dc) - 1)
                    idx_lo = np.clip(idx - 1, 0, len(dc) - 1)
                    use_lo = np.abs(dc[idx_lo] - sc) < np.abs(dc[idx] - sc)
                    i = np.where(use_lo, idx_lo, idx)
                    stencils.append([(i, np.ones(len(sc)))])

            def scatter(vals, out):
                for ix, wx in stencils[0]:
                    for iy, wy in stencils[1]:
                        for iz, wz in stencils[2]:
                            w = (wx[:, None, None] * wy[None, :, None]
                                 * wz[None, None, :])
                            np.add.at(
                                out,
                                (ix[:, None, None],
                                 iy[None, :, None],
                                 iz[None, None, :]),
                                vals * w)

            if want_eps:
                scatter(info.real_grad(e_prod), grad_eps)
            if want_sigma:
                scatter(info.real_grad(e_prod * (1j / (omega * EPSILON_0))),
                        grad_sigma)

        out = {}
        for path in paths:
            if path == "permittivity":
                out[path] = grad_eps
            elif path == "conductivity":
                out[path] = grad_sigma
            else:
                raise NotImplementedError(
                    f"CustomMedium derivative for path {path!r} not "
                    "supported")
        return out


class CustomPoleResidue(PoleResidue):
    """PoleResidue with spatially varying eps_inf and poles.

    Reference: medium.py:3122.
    """

    eps_inf: CustomSpatialDataType = pydantic.Field(..., title="Epsilon at Infinity")  # type: ignore[assignment]
    poles: Tuple[Tuple[Union[Complex, CustomSpatialDataType], Union[Complex, CustomSpatialDataType]], ...] = pydantic.Field(
        (), title="Poles"
    )

    @pydantic.model_validator(mode="before")
    @classmethod
    def _warn_if_unloaded(cls, values):
        """Reference medium.py ``_warn_if_none``: data-less placeholders
        (JSON-written files) degrade to a vacuum medium with a warning."""
        if not isinstance(values, dict):
            return values
        fail = _not_loaded(values.get("eps_inf"))
        for pole in values.get("poles") or ():
            for term in (pole if isinstance(pole, (list, tuple)) else (pole,)):
                fail = fail or _not_loaded(term)
        if fail:
            log.warning("Loading 'eps_inf' or 'poles' without data; "
                        "constructing a vacuum medium instead.")
            return dict(eps_inf=_vacuum_spatial(), poles=())
        return values

    @pydantic.field_validator("poles")
    @classmethod
    def _causality(cls, val):
        for a, _ in val:
            a_vals = _spatial_vals(a) if hasattr(a, "values") else a
            if np.any(np.real(a_vals) > 0):
                raise ValidationError("all pole 'a' values must have non-positive real part")
        return val

    @property
    def is_spatially_uniform(self) -> bool:
        return False

    @property
    def is_custom(self) -> bool:
        return True

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        eps_inf = float(np.mean(np.real(_spatial_vals(self.eps_inf))))
        poles = []
        for a, c in self.poles:
            a_val = complex(np.mean(_spatial_vals(a))) \
                if hasattr(a, "values") else a
            c_val = complex(np.mean(_spatial_vals(c))) \
                if hasattr(c, "values") else c
            poles.append((a_val, c_val))
        return PoleResidue._eps_model(eps_inf, poles, frequency)

    @cached_property
    def n_cfl(self) -> float:
        return float(np.sqrt(np.min(np.real(_spatial_vals(self.eps_inf)))))


class _CustomDispersiveBase(Tidy3dBaseModel):
    """Mixin for spatially-varying dispersive models: coefficients may be
    SpatialDataArray; scalar-model formulas are evaluated on spatial means
    for eps_model, and converted cellwise via to_pole_residue for lowering
    (reference: medium.py CustomDispersiveMedium:2772)."""

    @property
    def is_spatially_uniform(self) -> bool:
        return False

    @property
    def is_custom(self) -> bool:
        return True

    @pydantic.model_validator(mode="before")
    @classmethod
    def _warn_if_unloaded(cls, values):
        """Reference medium.py ``_warn_if_none``: data-less placeholders
        (JSON-written files) degrade to a vacuum medium with a warning."""
        if not isinstance(values, dict):
            return values
        fail = _not_loaded(values.get("eps_inf"))
        for coeff in values.get("coeffs") or ():
            for term in (coeff if isinstance(coeff, (list, tuple))
                         else (coeff,)):
                fail = fail or _not_loaded(term)
        if fail:
            log.warning("Loading 'eps_inf' or 'coeffs' without data; "
                        "constructing a vacuum medium instead.")
            out = dict(coeffs=())
            if "eps_inf" in values:
                out["eps_inf"] = 1.0
            return out
        return values

    @staticmethod
    def _mean(value):
        if hasattr(value, "values"):
            return float(np.mean(np.real(_spatial_vals(value))))
        return value


class CustomSellmeier(_CustomDispersiveBase, Sellmeier):
    """Sellmeier with spatially varying (B, C) coefficients
    (reference: medium.py:3725)."""

    coeffs: Tuple[Tuple[Union[float, CustomSpatialDataType],
                        Union[float, CustomSpatialDataType]], ...] = pydantic.Field(
        (), title="Coefficients")

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        mean_coeffs = tuple((self._mean(b), self._mean(c))
                            for b, c in self.coeffs)
        return Sellmeier(coeffs=mean_coeffs).eps_model(frequency)

    def _pole_residue_dict(self) -> Dict:
        mean_coeffs = tuple((self._mean(b), self._mean(c))
                            for b, c in self.coeffs)
        return Sellmeier(coeffs=mean_coeffs)._pole_residue_dict()


class CustomLorentz(_CustomDispersiveBase, Lorentz):
    """Lorentz with spatially varying coefficients (reference: medium.py:4110)."""

    eps_inf: Union[pydantic.PositiveFloat, CustomSpatialDataType] = pydantic.Field(1.0)  # type: ignore[assignment]
    coeffs: Tuple[Tuple[Union[float, CustomSpatialDataType],
                        Union[float, CustomSpatialDataType],
                        Union[float, CustomSpatialDataType]], ...] = pydantic.Field(
        (), title="Coefficients")

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        mean_coeffs = tuple((self._mean(a), self._mean(b), self._mean(c))
                            for a, b, c in self.coeffs)
        return Lorentz(eps_inf=self._mean(self.eps_inf),
                       coeffs=mean_coeffs).eps_model(frequency)

    def _pole_residue_dict(self) -> Dict:
        mean_coeffs = tuple((self._mean(a), self._mean(b), self._mean(c))
                            for a, b, c in self.coeffs)
        return Lorentz(eps_inf=self._mean(self.eps_inf),
                       coeffs=mean_coeffs)._pole_residue_dict()


class CustomDrude(_CustomDispersiveBase, Drude):
    """Drude with spatially varying coefficients (reference: medium.py:4412)."""

    eps_inf: Union[pydantic.PositiveFloat, CustomSpatialDataType] = pydantic.Field(1.0)  # type: ignore[assignment]
    coeffs: Tuple[Tuple[Union[float, CustomSpatialDataType],
                        Union[float, CustomSpatialDataType]], ...] = pydantic.Field(
        (), title="Coefficients")

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        mean_coeffs = tuple((self._mean(f), self._mean(d))
                            for f, d in self.coeffs)
        return Drude(eps_inf=self._mean(self.eps_inf),
                     coeffs=mean_coeffs).eps_model(frequency)

    def _pole_residue_dict(self) -> Dict:
        mean_coeffs = tuple((self._mean(f), self._mean(d))
                            for f, d in self.coeffs)
        return Drude(eps_inf=self._mean(self.eps_inf),
                     coeffs=mean_coeffs)._pole_residue_dict()


class CustomDebye(_CustomDispersiveBase, Debye):
    """Debye with spatially varying coefficients (reference: medium.py:4670)."""

    eps_inf: Union[pydantic.PositiveFloat, CustomSpatialDataType] = pydantic.Field(1.0)  # type: ignore[assignment]
    coeffs: Tuple[Tuple[Union[float, CustomSpatialDataType],
                        Union[float, CustomSpatialDataType]], ...] = pydantic.Field(
        (), title="Coefficients")

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        mean_coeffs = tuple((self._mean(d), self._mean(t))
                            for d, t in self.coeffs)
        return Debye(eps_inf=self._mean(self.eps_inf),
                     coeffs=mean_coeffs).eps_model(frequency)

    def _pole_residue_dict(self) -> Dict:
        mean_coeffs = tuple((self._mean(d), self._mean(t))
                            for d, t in self.coeffs)
        return Debye(eps_inf=self._mean(self.eps_inf),
                     coeffs=mean_coeffs)._pole_residue_dict()


# --------------------------------------------------------------------------- #
# perturbation media (thermo-optic / free-carrier workflows)
# --------------------------------------------------------------------------- #


class AbstractPerturbationMedium(Tidy3dBaseModel):
    """Mixin providing perturbed_copy from heat/charge solution fields
    (reference: medium.py AbstractPerturbationMedium:5560)."""

    perturbation_spec: Optional[Any] = pydantic.Field(
        None, title="Perturbation spec",
        description="PermittivityPerturbation or IndexPerturbation model.")

    def _delta_eps_sigma(self, temperature, electron_density, hole_density,
                         base_n_k=None):
        """(delta_eps, delta_sigma) arrays from the configured perturbations."""
        from .parameter_perturbation import (
            IndexPerturbation,
            ParameterPerturbation,
            PermittivityPerturbation,
        )

        d_eps = 0.0
        d_sigma = 0.0

        def apply(pp):
            if pp is None:
                return 0.0
            return pp.apply_data(temperature, electron_density, hole_density)

        direct_eps = getattr(self, "permittivity_perturbation", None)
        direct_sigma = getattr(self, "conductivity_perturbation", None)
        if direct_eps is not None or direct_sigma is not None:
            d_eps = d_eps + apply(direct_eps)
            d_sigma = d_sigma + apply(direct_sigma)
        spec = self.perturbation_spec
        if isinstance(spec, PermittivityPerturbation):
            d_eps = d_eps + apply(spec.delta_eps)
            d_sigma = d_sigma + apply(spec.delta_sigma)
        elif isinstance(spec, IndexPerturbation):
            dn = apply(spec.delta_n)
            dk = apply(spec.delta_k)
            n0, k0 = base_n_k if base_n_k is not None else (1.0, 0.0)
            # eps = (n + ik)^2: d_eps_real = 2(n dn - k dk);
            # d_sigma from d_eps_imag = 2(n dk + k dn)
            d_eps = d_eps + 2 * (n0 * dn - k0 * dk)
            omega = 2 * np.pi * spec.freq
            d_sigma = d_sigma + 2 * (n0 * dk + k0 * dn) * omega * EPSILON_0
        return d_eps, d_sigma


class PerturbationMedium(Medium, AbstractPerturbationMedium):
    """Dispersionless medium with heat/charge perturbations
    (reference: medium.py:5648)."""

    permittivity_perturbation: Optional[Any] = pydantic.Field(
        None, title="Permittivity perturbation")
    conductivity_perturbation: Optional[Any] = pydantic.Field(
        None, title="Conductivity perturbation")

    def perturbed_copy(self, temperature=None, electron_density=None,
                       hole_density=None, interp_method: str = "linear"
                       ) -> CustomMedium:
        """Sample the perturbations on the provided solution fields and
        return the equivalent CustomMedium."""
        ref = temperature if temperature is not None else electron_density
        if ref is None:
            return CustomMedium(permittivity=None)  # pragma: no cover
        n0, k0 = self.eps_complex_to_nk(
            self.eps_model(C_0))  # nominal band center; only IndexPerturbation uses it
        d_eps, d_sigma = self._delta_eps_sigma(temperature, electron_density,
                                               hole_density, base_n_k=(n0, k0))
        coords = {d: np.asarray(ref.coords[d]) for d in "xyz"}
        eps = np.broadcast_to(
            np.asarray(self.permittivity + d_eps),
            tuple(len(coords[d]) for d in "xyz")).copy()
        sigma = np.broadcast_to(
            np.asarray(self.conductivity + d_sigma),
            tuple(len(coords[d]) for d in "xyz")).copy()
        return CustomMedium(
            permittivity=SpatialDataArray(np.maximum(eps, 1.0), coords=coords),
            conductivity=SpatialDataArray(sigma, coords=coords),
            interp_method=interp_method, name=self.name)


class PerturbationPoleResidue(PoleResidue, AbstractPerturbationMedium):
    """PoleResidue with perturbations of eps_inf and poles
    (reference: medium.py:5834)."""

    eps_inf_perturbation: Optional[Any] = pydantic.Field(
        None, title="Eps_inf perturbation")
    poles_perturbation: Optional[Tuple[Tuple[Optional[Any], Optional[Any]],
                                       ...]] = pydantic.Field(
        None, title="Pole perturbations")

    def perturbed_copy(self, temperature=None, electron_density=None,
                       hole_density=None, interp_method: str = "linear"
                       ) -> "CustomPoleResidue":
        ref = temperature if temperature is not None else electron_density
        coords = {d: np.asarray(ref.coords[d]) for d in "xyz"}
        shape = tuple(len(coords[d]) for d in "xyz")

        def apply(pp):
            if pp is None:
                return 0.0
            return pp.apply_data(temperature, electron_density, hole_density)

        eps_inf = np.broadcast_to(
            np.asarray(self.eps_inf + np.real(apply(self.eps_inf_perturbation))),
            shape).copy()
        poles = []
        pole_perts = self.poles_perturbation or ((None, None),) * len(self.poles)
        for (a, c), (pa, pc) in zip(self.poles, pole_perts):
            da = apply(pa)
            dc = apply(pc)
            a_new = a + da if np.ndim(da) == 0 and da == 0.0 else \
                SpatialDataArray(np.broadcast_to(a + da, shape).copy(),
                                 coords=coords)
            c_new = c + dc if np.ndim(dc) == 0 and dc == 0.0 else \
                SpatialDataArray(np.broadcast_to(c + dc, shape).copy(),
                                 coords=coords)
            poles.append((a_new, c_new))
        return CustomPoleResidue(
            eps_inf=SpatialDataArray(eps_inf, coords=coords),
            poles=tuple(poles), name=self.name)


# --------------------------------------------------------------------------- #
# anisotropic media
# --------------------------------------------------------------------------- #

IsotropicUniformMediumType = Union[Medium, PoleResidue, Sellmeier, Lorentz, Drude, Debye, PECMedium]


class AnisotropicMedium(AbstractMedium):
    """Diagonally anisotropic medium with independent xx/yy/zz models.

    Reference: medium.py:4863.
    """

    xx: annotate_type(IsotropicUniformMediumType) = pydantic.Field(..., title="XX Component")
    yy: annotate_type(IsotropicUniformMediumType) = pydantic.Field(..., title="YY Component")
    zz: annotate_type(IsotropicUniformMediumType) = pydantic.Field(..., title="ZZ Component")

    @property
    def components(self) -> Dict[str, AbstractMedium]:
        return dict(xx=self.xx, yy=self.yy, zz=self.zz)

    @property
    def is_isotropic(self) -> bool:
        return False

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        return np.mean(self.eps_diagonal(frequency))

    def eps_diagonal(self, frequency: float) -> Tuple[complex, complex, complex]:
        return (
            self.xx.eps_model(frequency),
            self.yy.eps_model(frequency),
            self.zz.eps_model(frequency),
        )

    @cached_property
    def n_cfl(self) -> float:
        return min(comp.n_cfl for comp in (self.xx, self.yy, self.zz))


class FullyAnisotropicMedium(AbstractMedium):
    """Fully anisotropic nondispersive medium with 3x3 eps/sigma tensors.

    Reference: medium.py:5058.
    """

    permittivity: TensorReal = pydantic.Field(
        default_factory=lambda: np.eye(3).tolist(), title="Permittivity tensor"
    )
    conductivity: TensorReal = pydantic.Field(
        default_factory=lambda: np.zeros((3, 3)).tolist(), title="Conductivity tensor"
    )

    @pydantic.field_validator("permittivity", "conductivity")
    @classmethod
    def _check_symmetric(cls, val):
        arr = np.asarray(val, dtype=float)
        if arr.shape != (3, 3):
            raise ValidationError("tensor must be 3x3")
        if not np.allclose(arr, arr.T, atol=1e-10 * np.max(np.abs(arr) + 1e-30)):
            raise ValidationError("tensor must be symmetric")
        return arr

    @property
    def is_fully_anisotropic(self) -> bool:
        return True

    @property
    def is_isotropic(self) -> bool:
        return False

    @cached_property
    def eps_sigma_diag(self):
        """Diagonalization: eigenvalues + rotation matrix."""
        perm_diag, vecs = np.linalg.eigh(np.asarray(self.permittivity, dtype=float))
        cond_rot = vecs.T @ np.asarray(self.conductivity, dtype=float) @ vecs
        return perm_diag, np.diag(cond_rot), vecs

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        perm_diag, cond_diag, _ = self.eps_sigma_diag
        eps = [self.eps_sigma_to_eps_complex(p, s, frequency)
               for p, s in zip(perm_diag, cond_diag)]
        return np.mean(eps)

    def eps_diagonal(self, frequency: float) -> Tuple[complex, complex, complex]:
        arr = np.asarray(self.permittivity).diagonal()
        sig = np.asarray(self.conductivity).diagonal()
        return tuple(self.eps_sigma_to_eps_complex(p, s, frequency) for p, s in zip(arr, sig))

    def eps_comp(self, row: Axis, col: Axis, frequency: float) -> complex:
        eps = np.asarray(self.permittivity)[row, col]
        sig = np.asarray(self.conductivity)[row, col]
        return self.eps_sigma_to_eps_complex(eps, sig, frequency)

    @cached_property
    def n_cfl(self) -> float:
        perm_diag, _, _ = self.eps_sigma_diag
        return float(np.sqrt(max(np.min(perm_diag), 0.0))) or 1.0


class CustomAnisotropicMedium(AnisotropicMedium):
    """Diagonally anisotropic with spatially-varying components
    (reference: medium.py:5416)."""

    xx: Union[CustomMedium, CustomPoleResidue] = pydantic.Field(..., title="XX Component")  # type: ignore[assignment]
    yy: Union[CustomMedium, CustomPoleResidue] = pydantic.Field(..., title="YY Component")  # type: ignore[assignment]
    zz: Union[CustomMedium, CustomPoleResidue] = pydantic.Field(..., title="ZZ Component")  # type: ignore[assignment]

    @property
    def is_spatially_uniform(self) -> bool:
        return False

    @property
    def is_custom(self) -> bool:
        return True


class Medium2D(AbstractMedium):
    """In-plane 2D material sheet, defined by surface conductivity media along
    the two tangential axes (ss, tt).

    Reference: medium.py:6090 (volumetric-equivalent conversion is applied by
    the simulation when rasterizing).
    """

    ss: annotate_type(IsotropicUniformMediumType) = pydantic.Field(..., title="SS Component")
    tt: annotate_type(IsotropicUniformMediumType) = pydantic.Field(..., title="TT Component")

    @ensure_freq_in_range
    def eps_model(self, frequency: float) -> complex:
        return np.mean([self.ss.eps_model(frequency), self.tt.eps_model(frequency)])

    @classmethod
    def from_medium(cls, medium: Medium, thickness: float) -> "Medium2D":
        """Generate a Medium2D equivalent of a volumetric medium of given thickness."""
        med = cls._weighted_avg([medium], [thickness])
        return cls(ss=med, tt=med)

    @classmethod
    def from_dispersive_medium(cls, medium: DispersiveMedium, thickness: float) -> "Medium2D":
        med = cls._weighted_avg([medium], [thickness])
        return cls(ss=med, tt=med)

    @staticmethod
    def _weighted_avg(media: List[AbstractMedium], weights: List[float]) -> PoleResidue:
        """Weighted average of media as a PoleResidue (conductivity scaled by weights)."""
        eps_inf = 1.0
        poles: List = []
        for medium, weight in zip(media, weights):
            if isinstance(medium, DispersiveMedium):
                pr = medium.pole_residue
            elif isinstance(medium, Medium):
                pr = PoleResidue.from_medium(medium)
            elif isinstance(medium, PECMedium):
                # huge conductivity pole
                pr = PoleResidue(eps_inf=1.0, poles=((0j, 0.5 * 1e8 + 0j),))
            else:
                raise ValidationError(f"cannot average medium type {type(medium).__name__}")
            eps_inf += weight * (pr.eps_inf - 1)
            poles += [(a, weight * c) for a, c in pr.poles]
        return PoleResidue(eps_inf=max(eps_inf, 1.0), poles=tuple(poles))

    def volumetric_equivalent(self, axis: Axis, adjacent_media, adjacent_dls) -> AnisotropicMedium:
        """Convert to a volumetric anisotropic medium in a one-cell-thick slab.

        The sheet conductivity is distributed over the grid cell thickness and
        combined with the average of the adjacent media
        (reference: medium.py Medium2D.volumetric_equivalent).
        """
        def get_component(med: AbstractMedium, comp: str) -> AbstractMedium:
            if isinstance(med, AnisotropicMedium):
                return med.components[comp]
            return med

        dl = sum(adjacent_dls) / 2
        media_bg = []
        for comp in ("xx", "yy", "zz"):
            bg = self._weighted_avg(
                [get_component(m, comp) for m in adjacent_media], [0.5, 0.5]
            )
            media_bg.append(bg)

        # tangential components get the sheet response scaled by 1/dl
        _, tan_axes = _pop_axis_names(axis)
        comps = {}
        for name, bg in zip(("xx", "yy", "zz"), media_bg):
            comps[name] = bg
        for tan_axis, sheet in zip(tan_axes, (self.ss, self.tt)):
            name = "xyz"[tan_axis] * 2
            comps[name] = PoleResidue(**{
                **self._weighted_avg(
                    [comps[name]], [1.0]
                )._pole_residue_dict(),
            })
            sheet_pr = self._weighted_avg([sheet], [1.0 / dl])
            base = comps[name]
            comps[name] = PoleResidue(
                eps_inf=base.eps_inf + (sheet_pr.eps_inf - 1.0),
                poles=tuple(list(base.poles) + list(sheet_pr.poles)),
            )
        return AnisotropicMedium(xx=comps["xx"], yy=comps["yy"], zz=comps["zz"])

    @cached_property
    def n_cfl(self) -> float:
        return 1.0


def _pop_axis_names(axis: Axis) -> Tuple[int, Tuple[int, int]]:
    others = [0, 1, 2]
    others.remove(axis)
    return axis, tuple(others)


# full union of medium types for discriminated fields
MediumType3D = Union[
    Medium, PoleResidue, Sellmeier, Lorentz, Drude, Debye, PECMedium,
    AnisotropicMedium, FullyAnisotropicMedium, CustomMedium, CustomPoleResidue,
    CustomSellmeier, CustomLorentz, CustomDrude, CustomDebye,
    CustomAnisotropicMedium, CustomIsotropicMedium,
    PerturbationMedium, PerturbationPoleResidue,
]
MediumType = Union[
    Medium, PoleResidue, Sellmeier, Lorentz, Drude, Debye, PECMedium,
    AnisotropicMedium, FullyAnisotropicMedium, CustomMedium, CustomPoleResidue,
    CustomSellmeier, CustomLorentz, CustomDrude, CustomDebye,
    CustomAnisotropicMedium, CustomIsotropicMedium, Medium2D,
    PerturbationMedium, PerturbationPoleResidue,
]


def medium_from_nk(n: float, k: float, freq: float, **kwargs) -> AbstractMedium:
    """Convenience: lossless/lossy medium from n, k at a frequency."""
    if k == 0:
        return Medium(permittivity=n**2, **kwargs)
    return Medium.from_nk(n, k, freq, **kwargs)
