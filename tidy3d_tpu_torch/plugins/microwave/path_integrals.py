"""Voltage/current path integrals on field data (RF post-processing).

Behavioral model: tidy3d v2.7.6 plugins/microwave/path_integrals.py
(:65-250 — axis-aligned line integrals of E (voltage) and closed-contour
integrals of H (current), feeding the impedance calculator and terminal
S-matrix).
"""

from __future__ import annotations

from abc import ABC
from typing import Optional, Tuple, Union

import numpy as np
import pydantic

from ...components.base import Tidy3dBaseModel, cached_property
from ...components.data.data_array import FreqDataArray, TimeDataArray
from ...components.geometry.base import Box
from ...components.types import Axis, Direction
from ...exceptions import DataError, SetupError


class AbstractAxesRH(Tidy3dBaseModel, ABC):
    """Base for path-integral specifications."""


class AxisAlignedPathIntegral(AbstractAxesRH, Box):
    """Line integral along the single non-zero dimension of the box."""

    extrapolate_to_endpoints: bool = pydantic.Field(False)
    snap_path_to_grid: bool = pydantic.Field(False)

    @pydantic.model_validator(mode="after")
    def _is_line(self):
        if tuple(self.size).count(0.0) != 2:
            raise SetupError("Path integral requires exactly one non-zero dimension.")
        return self

    @cached_property
    def main_axis(self) -> Axis:
        for axis, s in enumerate(self.size):
            if s > 0:
                return axis
        raise SetupError("zero-size path")

    def compute_integral(self, scalar_field) -> Union[FreqDataArray, TimeDataArray]:
        """Integrate a scalar field DataArray along the path."""
        axis = self.main_axis
        dim = "xyz"[axis]
        rmin, rmax = self.bounds
        # interp onto the path: fix the two transverse positions
        coords = {}
        for a, d in enumerate("xyz"):
            if a == axis:
                continue
            coords[d] = self.center[a]
        arr = scalar_field.interp(coords=coords)
        path_coords = np.asarray(arr.coords[dim], dtype=float)
        mask = (path_coords >= rmin[axis]) & (path_coords <= rmax[axis])
        arr = arr.isel(**{dim: np.nonzero(mask)[0]}) if mask.sum() else arr
        result = arr.integrate(dim)
        values = np.asarray(result.values if hasattr(result, "values") else result)
        if "f" in getattr(result, "dims", ()):
            return FreqDataArray(values, coords=dict(f=result.coords["f"]))
        if "t" in getattr(result, "dims", ()):
            return TimeDataArray(values, coords=dict(t=result.coords["t"]))
        return values


class VoltageIntegralAxisAligned(AxisAlignedPathIntegral):
    """V = -integral(E . dl) along the path."""

    sign: Direction = pydantic.Field("+", title="Sign of the voltage")

    def compute_voltage(self, em_field) -> FreqDataArray:
        axis = self.main_axis
        comp = f"E{'xyz'[axis]}"
        field = em_field.field_components.get(comp) if hasattr(
            em_field, "field_components") else getattr(em_field, comp, None)
        if field is None:
            raise DataError(f"missing field component {comp} for voltage integral")
        result = self.compute_integral(field)
        sign = -1.0 if self.sign == "+" else 1.0
        return result * sign


class CurrentIntegralAxisAligned(AbstractAxesRH, Box):
    """I = closed contour integral of H around the box perimeter (the box is a
    plane; the contour is its boundary, right-handed about ``sign`` normal)."""

    sign: Direction = pydantic.Field("+", title="Direction of the contour normal")
    extrapolate_to_endpoints: bool = pydantic.Field(False)
    snap_contour_to_grid: bool = pydantic.Field(False)

    @cached_property
    def normal_axis(self) -> Axis:
        return tuple(self.size).index(0.0)

    def compute_current(self, em_field) -> FreqDataArray:
        axis = self.normal_axis
        b = (axis + 1) % 3
        c = (axis + 2) % 3
        rmin, rmax = self.bounds
        h_b = em_field.field_components[f"H{'xyz'[b]}"]
        h_c = em_field.field_components[f"H{'xyz'[c]}"]

        def line(field, along_axis, fixed_axis, fixed_pos, lo, hi, direction):
            coords = {"xyz"[fixed_axis]: fixed_pos, "xyz"[axis]: self.center[axis]}
            arr = field.interp(coords=coords)
            dim = "xyz"[along_axis]
            pts = np.asarray(arr.coords[dim], dtype=float)
            mask = (pts >= lo) & (pts <= hi)
            if mask.sum():
                arr = arr.isel(**{dim: np.nonzero(mask)[0]})
            res = arr.integrate(dim)
            return direction * np.asarray(res.values), res.coords.get("f")

        # contour: +b at c_min, +c at b_max, -b at c_max, -c at b_min
        total = 0.0
        freqs = None
        for field, along, fixed, pos, lo, hi, sgn in (
            (h_b, b, c, rmin[c], rmin[b], rmax[b], +1.0),
            (h_c, c, b, rmax[b], rmin[c], rmax[c], +1.0),
            (h_b, b, c, rmax[c], rmin[b], rmax[b], -1.0),
            (h_c, c, b, rmin[b], rmin[c], rmax[c], -1.0),
        ):
            vals, f = line(field, along, fixed, pos, lo, hi, sgn)
            total = total + vals
            freqs = f if f is not None else freqs
        if self.sign == "-":
            total = -total
        return FreqDataArray(total, coords=dict(f=freqs))


class ImpedanceCalculator(Tidy3dBaseModel):
    """Z = V / I (or V^2 / P, P / I^2 when only one integral is given)."""

    voltage_integral: Optional[VoltageIntegralAxisAligned] = pydantic.Field(None)
    current_integral: Optional[CurrentIntegralAxisAligned] = pydantic.Field(None)

    @pydantic.model_validator(mode="after")
    def _at_least_one(self):
        if self.voltage_integral is None and self.current_integral is None:
            raise SetupError("provide a voltage and/or current integral")
        return self

    def compute_impedance(self, em_field) -> FreqDataArray:
        if self.voltage_integral is not None and self.current_integral is not None:
            v = self.voltage_integral.compute_voltage(em_field)
            i = self.current_integral.compute_current(em_field)
            return FreqDataArray(np.asarray(v.values) / np.asarray(i.values),
                                 coords=dict(f=v.coords["f"]))
        flux = em_field.flux_value() if hasattr(em_field, "flux_value") else None
        if self.voltage_integral is not None:
            v = self.voltage_integral.compute_voltage(em_field)
            power = np.asarray(flux.values)
            return FreqDataArray(np.abs(np.asarray(v.values)) ** 2 / (2 * power),
                                 coords=dict(f=v.coords["f"]))
        i = self.current_integral.compute_current(em_field)
        power = np.asarray(flux.values)
        return FreqDataArray(2 * power / np.abs(np.asarray(i.values)) ** 2,
                             coords=dict(f=i.coords["f"]))
