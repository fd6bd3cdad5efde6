"""tidy3d_tpu_torch — the PyTorch/CUDA port of the tidy3d_tpu FDTD solver.

The package stands alone: it imports torch, numpy, scipy and pydantic, and
nothing of ``tidy3d_tpu`` or JAX. Its schema (``components``), the
lowering to a ``SimulationPlan`` (``solver.lowering``), the CPML and field
sources, the host mode solver and the material library are copies of the
JAX-free modules of ``tidy3d_tpu`` under the same relative paths. What runs
on the device — the time-stepping runner and its kernels, and the mode
solver's Chebyshev filter — is this package's own: PyTorch around
hand-written CUDA kernels for Hopper.

    import tidy3d_tpu_torch as td
    sim = td.Simulation(...)
    data = td.web.run(sim)            # on the GPU; device="cpu" for the
                                      # plain PyTorch path

A simulation of either package crosses to the other through its JSON:
``tidy3d_tpu.Simulation.parse_raw(sim.json())`` and back. The top-level
and ``web`` names are the JAX package's. The EME solver
(``solver.eme.run_eme``, its cells' mode solves on the card's filter) and
the heat solver (``HeatSimulation.run``, scipy on the host) are copies of
the JAX package's, as are its JAX-free plugins.
"""

from . import _malloc  # noqa: F401  (glibc tuning; must run before numpy allocs)
from .constants import C_0, EPSILON_0, ETA_0, HBAR, K_B, MU_0, Q_e, inf
from .config import config
from .log import log, set_logging_console, set_logging_file, set_logging_level
from .version import __version__

# --- base / types ---------------------------------------------------------- #
from .components.base import Tidy3dBaseModel
from .components.types import Coordinate, Size, Symmetry

# --- geometry -------------------------------------------------------------- #
from .components.geometry.base import (
    Box,
    ClipOperation,
    Geometry,
    GeometryGroup,
    Transformed,
)
from .components.geometry.primitives import Cylinder, Sphere
from .components.geometry.polyslab import ComplexPolySlabBase, PolySlab
from .components.geometry.mesh import TriangleMesh

# --- mediums --------------------------------------------------------------- #
from .components.medium import (
    PEC,
    AbstractMedium,
    AnisotropicMedium,
    CustomAnisotropicMedium,
    CustomIsotropicMedium,
    CustomDebye,
    CustomDrude,
    CustomLorentz,
    CustomMedium,
    CustomPoleResidue,
    CustomSellmeier,
    PerturbationMedium,
    PerturbationPoleResidue,
    Debye,
    Drude,
    FullyAnisotropicMedium,
    KerrNonlinearity,
    Lorentz,
    Medium,
    Medium2D,
    NonlinearSpec,
    NonlinearSusceptibility,
    PECMedium,
    PoleResidue,
    Sellmeier,
    TwoPhotonAbsorption,
)

# --- structures / scene ---------------------------------------------------- #
from .components.structure import MeshOverrideStructure, Structure
from .components.scene import Scene

# --- grid ------------------------------------------------------------------ #
from .components.grid.grid import Coords, FieldGrid, Grid, YeeGrid
from .components.grid.grid_spec import (
    AutoGrid,
    CustomGrid,
    CustomGridBoundaries,
    GridSpec,
    UniformGrid,
)
from .components.grid.mesher import GradedMesher

# --- boundaries ------------------------------------------------------------ #
from .components.boundary import (
    PML,
    Absorber,
    AbsorberParams,
    BlochBoundary,
    Boundary,
    BoundarySpec,
    BoundaryEdge,
    DefaultAbsorberParameters,
    DefaultPMLParameters,
    DefaultStablePMLParameters,
    PECBoundary,
    Periodic,
    PMCBoundary,
    PMLParams,
    StablePML,
)

# --- sources --------------------------------------------------------------- #
from .components.source import (
    TFSF,
    AstigmaticGaussianBeam,
    ContinuousWave,
    CustomCurrentSource,
    CustomFieldSource,
    CustomSourceTime,
    GaussianBeam,
    GaussianPulse,
    ModeSource,
    PlaneWave,
    PointDipole,
    Source,
    SourceTime,
    UniformCurrentSource,
)

# --- monitors -------------------------------------------------------------- #
from .components.monitor import (
    DiffractionMonitor,
    FieldMonitor,
    FieldTimeMonitor,
    FieldProjectionAngleMonitor,
    FieldProjectionCartesianMonitor,
    FieldProjectionKSpaceMonitor,
    FluxMonitor,
    FluxTimeMonitor,
    ModeMonitor,
    ModeSolverMonitor,
    Monitor,
    PermittivityMonitor,
)

# --- mode / apodization ---------------------------------------------------- #
from .components.mode import ModeSpec
from .components.apodization import ApodizationSpec

# --- simulation ------------------------------------------------------------ #
from .components.simulation import Simulation
from .components.subpixel_spec import (
    HeuristicPECStaircasing,
    PECConformal,
    PolarizedAveraging,
    Staircasing,
    SubpixelSpec,
    VolumetricAveraging,
)

# --- data ------------------------------------------------------------------ #
from .components.data.data_array import (
    ChargeDataArray,
    DataArray,
    DiffractionDataArray,
    FieldProjectionAngleDataArray,
    FieldProjectionCartesianDataArray,
    FieldProjectionKSpaceDataArray,
    FluxDataArray,
    FluxTimeDataArray,
    FreqDataArray,
    FreqModeDataArray,
    GroupIndexDataArray,
    HeatDataArray,
    ModeAmpsDataArray,
    ModeIndexDataArray,
    ScalarFieldDataArray,
    ScalarFieldTimeDataArray,
    ScalarModeFieldDataArray,
    SpatialDataArray,
    TimeDataArray,
)
from .components.data.dataset import (
    FieldDataset,
    FieldTimeDataset,
    ModeSolverDataset,
    PermittivityDataset,
)
from .components.data.monitor_data import (
    DiffractionData,
    FieldData,
    FieldTimeData,
    FluxData,
    FluxTimeData,
    ModeData,
    ModeSolverData,
    PermittivityData,
)
from .components.data.sim_data import SimulationData

# --- EME ------------------------------------------------------------------- #
from .components.eme.data import (
    EMECoefficientData,
    EMEFieldData,
    EMEModeSolverData,
    EMESimulationData,
    EMESMatrixDataset,
)
from .components.eme.monitor import (
    EMECoefficientMonitor,
    EMEFieldMonitor,
    EMEModeSolverMonitor,
)
from .components.eme.grid import (
    EMECompositeGrid,
    EMEExplicitGrid,
    EMEModeSpec,
    EMEUniformGrid,
)
from .components.eme.simulation import EMESimulation
from .components.eme.sweep import EMEFreqSweep, EMELengthSweep, EMEModeSweep

# --- heat ------------------------------------------------------------------ #
from .components.heat.boundary import (
    ConvectionBC,
    HeatBoundarySpec,
    HeatFluxBC,
    MediumMediumInterface,
    SimulationBoundary,
    StructureBoundary,
    StructureSimulationBoundary,
    StructureStructureInterface,
    TemperatureBC,
)
from .components.heat.data import HeatSimulationData, TemperatureData
from .components.heat.heat_spec import FluidSpec, SolidSpec
from .components.heat.monitor import TemperatureMonitor
from .components.heat.simulation import HeatSimulation
from .components.heat.source import UniformHeatSource

# --- lumped elements / perturbations / modulation -------------------------- #
from .components.lumped_element import CoaxialLumpedResistor, LumpedResistor
from .components.parameter_perturbation import (
    CustomChargePerturbation,
    CustomHeatPerturbation,
    IndexPerturbation,
    LinearChargePerturbation,
    LinearHeatPerturbation,
    ParameterPerturbation,
    PermittivityPerturbation,
)
from .components.time_modulation import (
    ContinuousWaveTimeModulation,
    ModulationSpec,
    SpaceTimeModulation,
    SpatialModulationCustom,
    SpatialModulationUniform,
)
from .components.run_time_spec import RunTimeSpec
from .updater import Updater

from .components.data.unstructured import (
    CellDataArray,
    IndexedDataArray,
    PointDataArray,
    TetrahedralGridDataset,
    TriangularGridDataset,
)

# --- material library ------------------------------------------------------ #
from .material_library.material_library import material_library
from .material_library.parametric_materials import Graphene

# --- execution ------------------------------------------------------------- #
from . import web
