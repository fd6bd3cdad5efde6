from .data import (
    EMECoefficientData,
    EMEFieldData,
    EMEModeSolverData,
    EMESimulationData,
    EMESMatrixDataset,
)
from .monitor import (
    EMECoefficientMonitor,
    EMEFieldMonitor,
    EMEModeSolverMonitor,
    EMEMonitor,
)
from .grid import (
    EMECompositeGrid,
    EMEExplicitGrid,
    EMEModeSpec,
    EMEUniformGrid,
)
from .simulation import EMESimulation
from .sweep import EMEFreqSweep, EMELengthSweep, EMEModeSweep
