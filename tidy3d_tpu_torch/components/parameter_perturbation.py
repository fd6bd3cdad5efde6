"""Heat/charge perturbations of material parameters.

Behavioral model: /root/reference/tidy3d/components/parameter_perturbation.py
(ParameterPerturbation:967, PermittivityPerturbation:1127,
IndexPerturbation:1227 — linear/custom thermo-optic and free-carrier
perturbations applied by Simulation.perturbed_mediums_copy).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import pydantic

from ..constants import KELVIN, PERCMCUBE
from ..exceptions import SetupError
from .base import Tidy3dBaseModel, cached_property
from .data.data_array import HeatDataArray, ChargeDataArray, SpatialDataArray
from .types import ArrayLike, Complex, annotate_type


class AbstractPerturbation(Tidy3dBaseModel):
    """Base of parameter perturbations."""


# ---------------------------------------------------------------------- #
# heat
# ---------------------------------------------------------------------- #


class LinearHeatPerturbation(AbstractPerturbation):
    """delta = coeff * (T - temperature_ref)."""

    temperature_ref: pydantic.NonNegativeFloat = pydantic.Field(
        ..., title="Reference temperature [K]")
    coeff: Union[float, Complex] = pydantic.Field(..., title="Sensitivity [1/K]")
    temperature_range: Tuple[pydantic.NonNegativeFloat, pydantic.NonNegativeFloat] = (
        pydantic.Field((0, 1e4), title="Valid temperature range"))

    def sample(self, temperature) -> np.ndarray:
        temp = np.asarray(temperature)
        return self.coeff * (temp - self.temperature_ref)

    @property
    def perturbation_range(self) -> Tuple[complex, complex]:
        lo, hi = self.temperature_range
        vals = [self.coeff * (lo - self.temperature_ref),
                self.coeff * (hi - self.temperature_ref)]
        return (min(vals, key=np.real), max(vals, key=np.real))


class CustomHeatPerturbation(AbstractPerturbation):
    """delta sampled from tabulated perturbation-vs-temperature data."""

    perturbation_values: HeatDataArray = pydantic.Field(
        ..., title="Perturbation values over temperature")
    temperature_range: Optional[Tuple[float, float]] = pydantic.Field(None)
    interp_method: str = pydantic.Field("linear", title="Interpolation")

    def sample(self, temperature) -> np.ndarray:
        temps = np.asarray(self.perturbation_values.coords["T"], dtype=float)
        vals = np.asarray(self.perturbation_values.values)
        temp = np.asarray(temperature, dtype=float)
        if np.iscomplexobj(vals):
            return (np.interp(temp, temps, vals.real)
                    + 1j * np.interp(temp, temps, vals.imag))
        return np.interp(temp, temps, vals)

    @property
    def perturbation_range(self) -> Tuple[complex, complex]:
        vals = np.asarray(self.perturbation_values.values)
        return (vals.min(), vals.max())


HeatPerturbationType = Union[LinearHeatPerturbation, CustomHeatPerturbation]


# ---------------------------------------------------------------------- #
# charge
# ---------------------------------------------------------------------- #


class LinearChargePerturbation(AbstractPerturbation):
    """delta = e_coeff*(n - n_ref) + h_coeff*(p - p_ref)."""

    electron_ref: pydantic.NonNegativeFloat = pydantic.Field(..., title="n ref [1/cm^3]")
    electron_coeff: float = pydantic.Field(..., title="n sensitivity")
    electron_range: Tuple[float, float] = pydantic.Field((0, 1e21))
    hole_ref: pydantic.NonNegativeFloat = pydantic.Field(..., title="p ref [1/cm^3]")
    hole_coeff: float = pydantic.Field(..., title="p sensitivity")
    hole_range: Tuple[float, float] = pydantic.Field((0, 1e21))

    def sample(self, electron_density, hole_density) -> np.ndarray:
        n = np.asarray(electron_density)
        p = np.asarray(hole_density)
        return (self.electron_coeff * (n - self.electron_ref)
                + self.hole_coeff * (p - self.hole_ref))


class CustomChargePerturbation(AbstractPerturbation):
    """delta tabulated over (n, p)."""

    perturbation_values: ChargeDataArray = pydantic.Field(...)
    interp_method: str = pydantic.Field("linear")

    def sample(self, electron_density, hole_density) -> np.ndarray:
        arr = self.perturbation_values
        return arr.interp(n=np.asarray(electron_density, dtype=float),
                          p=np.asarray(hole_density, dtype=float)).values


ChargePerturbationType = Union[LinearChargePerturbation, CustomChargePerturbation]


class ParameterPerturbation(Tidy3dBaseModel):
    """Combined heat + charge perturbation of one scalar parameter."""

    heat: Optional[annotate_type(HeatPerturbationType)] = pydantic.Field(None)
    charge: Optional[annotate_type(ChargePerturbationType)] = pydantic.Field(None)

    def apply_data(self, temperature=None, electron_density=None,
                   hole_density=None):
        """Total perturbation sampled on the provided data arrays."""
        total = None

        def acc(val):
            nonlocal total
            total = val if total is None else total + val

        if self.heat is not None and temperature is not None:
            acc(self.heat.sample(np.asarray(temperature.values
                                            if hasattr(temperature, "values")
                                            else temperature)))
        if self.charge is not None and electron_density is not None \
                and hole_density is not None:
            e = np.asarray(electron_density.values
                           if hasattr(electron_density, "values") else electron_density)
            h = np.asarray(hole_density.values
                           if hasattr(hole_density, "values") else hole_density)
            acc(self.charge.sample(e, h))
        return total if total is not None else 0.0


class PermittivityPerturbation(Tidy3dBaseModel):
    """Perturbations of permittivity and conductivity."""

    delta_eps: Optional[ParameterPerturbation] = pydantic.Field(None)
    delta_sigma: Optional[ParameterPerturbation] = pydantic.Field(None)


class IndexPerturbation(Tidy3dBaseModel):
    """Perturbations of refractive index n, k."""

    delta_n: Optional[ParameterPerturbation] = pydantic.Field(None)
    delta_k: Optional[ParameterPerturbation] = pydantic.Field(None)
    freq: pydantic.PositiveFloat = pydantic.Field(..., title="Frequency [Hz]")
