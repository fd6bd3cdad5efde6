"""Heat result containers (reference: tidy3d/components/heat/data/)."""

from __future__ import annotations

from typing import Dict, Tuple, Union

import pydantic

from ..base import Tidy3dBaseModel, cached_property
from ..data.data_array import SpatialDataArray
from ..data.unstructured import TetrahedralGridDataset, TriangularGridDataset
from ..types import annotate_type
from .monitor import TemperatureMonitor


class TemperatureData(Tidy3dBaseModel):
    """Temperature field of one monitor.

    ``temperature`` is a Cartesian ``SpatialDataArray`` by default; with
    ``TemperatureMonitor(unstructured=True)`` it is a tri/tet unstructured
    dataset (reference schema: heat monitors return
    TriangularGridDataset/TetrahedralGridDataset, feeding
    ``perturbed_mediums_copy``)."""

    monitor: TemperatureMonitor = pydantic.Field(...)
    temperature: Union[SpatialDataArray, TriangularGridDataset,
                       TetrahedralGridDataset] = pydantic.Field(
        ..., title="Temperature [K]")


class HeatSimulationData(Tidy3dBaseModel):
    """Results of a heat simulation."""

    simulation: object = pydantic.Field(...)
    data: Tuple[TemperatureData, ...] = pydantic.Field(...)

    @cached_property
    def monitor_data(self) -> Dict[str, TemperatureData]:
        return {d.monitor.name: d for d in self.data}

    def __getitem__(self, name: str) -> TemperatureData:
        return self.monitor_data[name]
