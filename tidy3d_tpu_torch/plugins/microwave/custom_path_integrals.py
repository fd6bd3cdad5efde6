"""Arbitrary-path voltage/current integrals on field data.

Behavioral model: tidy3d v2.7.6 plugins/microwave/
custom_path_integrals.py (CustomPathIntegral2D, CustomVoltageIntegral2D,
CustomCurrentIntegral2D) — V = -int E . dl along a polyline in a plane;
I = loop int H . dl around a closed contour.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import pydantic

from ...components.base import Tidy3dBaseModel, cached_property
from ...components.data.data_array import FreqDataArray
from ...components.types import Axis
from ...exceptions import DataError, SetupError


class CustomPathIntegral2D(Tidy3dBaseModel):
    """Line integral of a vector field along a polyline in a plane normal to
    `axis` at `position`."""

    axis: Axis = pydantic.Field(2, title="Normal axis")
    position: float = pydantic.Field(..., title="Plane position")
    vertices: Tuple[Tuple[float, float], ...] = pydantic.Field(
        ..., title="Polyline vertices (in-plane coords)", min_length=2)

    @cached_property
    def _dims(self):
        return [d for i, d in enumerate("xyz") if i != self.axis]

    @cached_property
    def is_closed(self) -> bool:
        v = np.asarray(self.vertices, dtype=float)
        return bool(np.allclose(v[0], v[-1]))

    def _sample(self, arr, pts_b, pts_c):
        """Sample a field DataArray at in-plane points (per-point interp)."""
        d1, d2 = self._dims
        n_dim = "xyz"[self.axis]
        out = []
        for b, c in zip(pts_b, pts_c):
            coords = {d1: float(b), d2: float(c)}
            if n_dim in arr.dims and len(arr.coords[n_dim]) > 1:
                coords[n_dim] = self.position
            sel = arr.interp(coords=coords, kwargs=dict(fill_value=0.0))
            vals = np.asarray(sel.values).squeeze()
            out.append(vals)
        return np.asarray(out)  # (npts, nf)

    def compute_integral(self, field_data, field: str = "E") -> FreqDataArray:
        """int F . dl with F the tangential component pair in the plane."""
        d1, d2 = self._dims
        f1 = getattr(field_data, f"{field}{d1}", None)
        f2 = getattr(field_data, f"{field}{d2}", None)
        if f1 is None or f2 is None:
            raise DataError(f"field data is missing {field}{d1}/{field}{d2}")
        v = np.asarray(self.vertices, dtype=float)
        # midpoints and segment vectors
        mids = 0.5 * (v[1:] + v[:-1])
        dl = v[1:] - v[:-1]
        s1 = self._sample(f1, mids[:, 0], mids[:, 1])
        s2 = self._sample(f2, mids[:, 0], mids[:, 1])
        while s1.ndim < 2:
            s1 = s1[:, None]
            s2 = s2[:, None]
        total = np.sum(s1 * dl[:, 0:1] + s2 * dl[:, 1:2], axis=0)
        freqs = np.asarray(f1.coords["f"], dtype=float) if "f" in f1.dims \
            else np.zeros(total.shape[-1])
        return FreqDataArray(total, coords=dict(f=freqs))


class CustomVoltageIntegral2D(CustomPathIntegral2D):
    """V = -int E . dl along the path."""

    def compute_voltage(self, field_data) -> FreqDataArray:
        integral = self.compute_integral(field_data, "E")
        return FreqDataArray(-np.asarray(integral.values),
                             coords=dict(integral.coords))


class CustomCurrentIntegral2D(CustomPathIntegral2D):
    """I = loop int H . dl around a closed contour."""

    @pydantic.model_validator(mode="after")
    def _closed(self):
        v = np.asarray(self.vertices, dtype=float)
        if not np.allclose(v[0], v[-1]):
            raise SetupError("current integral path must be closed "
                             "(first vertex == last vertex)")
        return self

    def compute_current(self, field_data) -> FreqDataArray:
        return self.compute_integral(field_data, "H")
