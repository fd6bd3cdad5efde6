from . import models
from .custom_path_integrals import (
    CustomCurrentIntegral2D,
    CustomPathIntegral2D,
    CustomVoltageIntegral2D,
)
from .path_integrals import (
    AxisAlignedPathIntegral,
    CurrentIntegralAxisAligned,
    ImpedanceCalculator,
    VoltageIntegralAxisAligned,
)
