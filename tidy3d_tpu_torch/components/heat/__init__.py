from .boundary import (
    ConvectionBC,
    HeatBoundarySpec,
    HeatFluxBC,
    TemperatureBC,
)
from .heat_spec import FluidSpec, SolidSpec
from .monitor import TemperatureMonitor
from .data import HeatSimulationData, TemperatureData
from .simulation import HeatSimulation
from .source import UniformHeatSource
