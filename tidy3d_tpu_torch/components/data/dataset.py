"""Datasets: groupings of DataArrays (EM fields, permittivity, mode data).

Behavioral model: /root/reference/tidy3d/components/data/dataset.py
(FieldDataset:223, FieldTimeDataset, ModeSolverDataset:323,
PermittivityDataset; unstructured grid datasets are provided in
unstructured.py). Colocation helpers mirror the reference semantics.
"""

from __future__ import annotations

from abc import ABC
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import pydantic

from ...exceptions import DataError
from ..base import Tidy3dBaseModel, cached_property
from ..types import Axis, EMField
from .data_array import (
    DataArray,
    FreqModeDataArray,
    ModeIndexDataArray,
    GroupIndexDataArray,
    ModeDispersionDataArray,
    ScalarFieldDataArray,
    ScalarFieldTimeDataArray,
    ScalarModeFieldDataArray,
    SpatialDataArray,
    TimeDataArray,
)


class Dataset(Tidy3dBaseModel, ABC):
    """Abstract base for datasets."""


class AbstractFieldDataset(Dataset, ABC):
    """Dataset with a collection of scalar field components."""

    @property
    def field_components(self) -> Dict[str, DataArray]:
        """Maps component name to its DataArray (None components omitted)."""
        out = {}
        for name in self.__pydantic_fields__:
            if name in ("type",):
                continue
            val = getattr(self, name)
            if isinstance(val, DataArray):
                out[name] = val
        return out

    def apply_phase(self, phase: float) -> "AbstractFieldDataset":
        """Multiply all complex fields by exp(1j phase)."""
        if phase == 0.0:
            return self
        factor = np.exp(1j * phase)
        update = {k: v._maybe_same_cls(v.values * factor)
                  for k, v in self.field_components.items()}
        return self.copy(update=update)

    def package_colocate_results(self, centered_fields: Dict[str, DataArray]):
        """Combine colocated components into a dataset-like dict."""
        return centered_fields

    def colocate(self, x=None, y=None, z=None) -> Dict[str, DataArray]:
        """Colocate all field components to the given coordinates."""
        centered = {}
        for name, arr in self.field_components.items():
            coords = {}
            if x is not None and "x" in arr.dims:
                coords["x"] = np.atleast_1d(x)
            if y is not None and "y" in arr.dims:
                coords["y"] = np.atleast_1d(y)
            if z is not None and "z" in arr.dims:
                coords["z"] = np.atleast_1d(z)
            centered[name] = arr.interp(coords=coords, kwargs=dict(fill_value=None)) \
                if coords else arr
        return self.package_colocate_results(centered)


class ElectromagneticFieldDataset(AbstractFieldDataset, ABC):
    """Dataset with E and H components on the Yee grid."""

    @property
    def grid_locations(self) -> Dict[str, str]:
        return {comp: comp for comp in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")}


class FieldDataset(ElectromagneticFieldDataset):
    """Frequency-domain EM field dataset."""

    Ex: Optional[ScalarFieldDataArray] = pydantic.Field(None, title="Ex")
    Ey: Optional[ScalarFieldDataArray] = pydantic.Field(None, title="Ey")
    Ez: Optional[ScalarFieldDataArray] = pydantic.Field(None, title="Ez")
    Hx: Optional[ScalarFieldDataArray] = pydantic.Field(None, title="Hx")
    Hy: Optional[ScalarFieldDataArray] = pydantic.Field(None, title="Hy")
    Hz: Optional[ScalarFieldDataArray] = pydantic.Field(None, title="Hz")


class FieldTimeDataset(ElectromagneticFieldDataset):
    """Time-domain EM field dataset."""

    Ex: Optional[ScalarFieldTimeDataArray] = pydantic.Field(None, title="Ex")
    Ey: Optional[ScalarFieldTimeDataArray] = pydantic.Field(None, title="Ey")
    Ez: Optional[ScalarFieldTimeDataArray] = pydantic.Field(None, title="Ez")
    Hx: Optional[ScalarFieldTimeDataArray] = pydantic.Field(None, title="Hx")
    Hy: Optional[ScalarFieldTimeDataArray] = pydantic.Field(None, title="Hy")
    Hz: Optional[ScalarFieldTimeDataArray] = pydantic.Field(None, title="Hz")

    def apply_phase(self, phase: float):
        if phase != 0.0:
            raise DataError("Can't apply complex phase to real-valued time data.")
        return self


class ModeSolverDataset(ElectromagneticFieldDataset):
    """Mode fields + complex effective index."""

    Ex: Optional[ScalarModeFieldDataArray] = pydantic.Field(None, title="Ex")
    Ey: Optional[ScalarModeFieldDataArray] = pydantic.Field(None, title="Ey")
    Ez: Optional[ScalarModeFieldDataArray] = pydantic.Field(None, title="Ez")
    Hx: Optional[ScalarModeFieldDataArray] = pydantic.Field(None, title="Hx")
    Hy: Optional[ScalarModeFieldDataArray] = pydantic.Field(None, title="Hy")
    Hz: Optional[ScalarModeFieldDataArray] = pydantic.Field(None, title="Hz")
    n_complex: Optional[ModeIndexDataArray] = pydantic.Field(None, title="n_complex")
    n_group_raw: Optional[GroupIndexDataArray] = pydantic.Field(None, title="Group index")
    dispersion_raw: Optional[ModeDispersionDataArray] = pydantic.Field(None, title="Dispersion")

    @property
    def field_components(self) -> Dict[str, DataArray]:
        return {k: v for k, v in super().field_components.items()
                if k in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")}

    @property
    def n_eff(self):
        return self.n_complex.real if self.n_complex is not None else None

    @property
    def k_eff(self):
        return self.n_complex.imag if self.n_complex is not None else None

    @property
    def n_group(self):
        return self.n_group_raw


class PermittivityDataset(AbstractFieldDataset):
    """Diagonal complex permittivity on the Yee grid."""

    eps_xx: Optional[ScalarFieldDataArray] = pydantic.Field(None, title="eps_xx")
    eps_yy: Optional[ScalarFieldDataArray] = pydantic.Field(None, title="eps_yy")
    eps_zz: Optional[ScalarFieldDataArray] = pydantic.Field(None, title="eps_zz")


# dataset types holding custom-source / custom-medium data
FieldDatasetTypes = Union[FieldDataset, FieldTimeDataset, ModeSolverDataset,
                          PermittivityDataset]
