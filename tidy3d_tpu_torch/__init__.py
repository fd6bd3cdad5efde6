"""tidy3d_tpu_torch — the PyTorch/CUDA port of the tidy3d_tpu FDTD solver.

The schema, the lowering to a ``SimulationPlan`` and the data layers are the
JAX-free modules of ``tidy3d_tpu``, reused by import (see ``_reference``).
What runs on the device — the time-stepping runner and its kernels — is
this package's own: PyTorch around hand-written CUDA kernels for Hopper.

    import tidy3d_tpu_torch as td
    sim = td.Simulation(...)
    data = td.web.run(sim)            # on the GPU; device="cpu" for the
                                      # plain PyTorch path
"""

from . import _reference  # noqa: F401  (must precede every tidy3d_tpu import)

from tidy3d_tpu.components.boundary import (  # noqa: E402
    PML,
    Boundary,
    BoundarySpec,
    PECBoundary,
    Periodic,
    PMCBoundary,
)
from tidy3d_tpu.components.data.sim_data import SimulationData  # noqa: E402
from tidy3d_tpu.components.geometry.base import Box  # noqa: E402
from tidy3d_tpu.components.grid.grid_spec import GridSpec  # noqa: E402
from tidy3d_tpu.components.medium import (  # noqa: E402
    Debye,
    Drude,
    Lorentz,
    Medium,
    PoleResidue,
    Sellmeier,
)
from tidy3d_tpu.components.monitor import (  # noqa: E402
    FieldMonitor,
    FieldTimeMonitor,
    FluxMonitor,
    FluxTimeMonitor,
)
from tidy3d_tpu.components.simulation import Simulation  # noqa: E402
from tidy3d_tpu.components.source import (  # noqa: E402
    GaussianPulse,
    PlaneWave,
    PointDipole,
)
from tidy3d_tpu.components.structure import Structure  # noqa: E402
from tidy3d_tpu.constants import C_0, inf  # noqa: E402
from tidy3d_tpu.material_library import material_library  # noqa: E402

from . import web  # noqa: E402

__all__ = [
    "PML", "Boundary", "BoundarySpec", "PECBoundary", "Periodic",
    "PMCBoundary", "SimulationData", "Box", "GridSpec", "Medium",
    "Debye", "Drude", "Lorentz", "PoleResidue", "Sellmeier", "PlaneWave",
    "material_library",
    "FieldMonitor", "FieldTimeMonitor", "FluxMonitor", "FluxTimeMonitor",
    "Simulation", "GaussianPulse", "PointDipole", "Structure", "C_0", "inf",
    "web",
]
