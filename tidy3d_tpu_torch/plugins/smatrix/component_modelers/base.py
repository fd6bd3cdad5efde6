"""Base of S-matrix component modelers.

Behavioral model: tidy3d v2.7.6 plugins/smatrix/component_modelers/
base.py (AbstractComponentModeler:28 — one simulation per excited port/mode
via Batch, S-matrix assembly with normalization and symmetry mappings).

The runs go through this package's ``web.container.Batch`` on a device:
``run(path_dir=None, device="cuda")`` and ``make_batch(device)`` take it
as a keyword (not a field, so that a modeler's JSON stays the
reference's); the ``batch`` and ``batch_data`` properties run on CUDA.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import pydantic

from ....components.base import Tidy3dBaseModel, cached_property
from ....components.simulation import Simulation
from ....components.types import Complex, FreqArray
from ....exceptions import SetupError
from ....log import log
from ....web.container import Batch, BatchData

# element of the S matrix: (port_out, mode_out), (port_in, mode_in)
MatrixIndex = Tuple[str, int]
Element = Tuple[MatrixIndex, MatrixIndex]


class AbstractComponentModeler(Tidy3dBaseModel, ABC):
    """Tool for modeling devices and computing scattering-matrix parameters."""

    simulation: Simulation = pydantic.Field(
        ..., title="Simulation", description="Base simulation (without ports/sources)."
    )
    freqs: FreqArray = pydantic.Field(..., title="Frequencies")
    folder_name: str = pydantic.Field("default", title="Folder Name")
    verbose: bool = pydantic.Field(False, title="Verbose")
    callback_url: Optional[str] = pydantic.Field(None, title="Callback URL")
    path_dir: str = pydantic.Field(".", title="Data directory")
    solver_version: Optional[str] = pydantic.Field(None, title="Solver version")
    run_only: Optional[Tuple[MatrixIndex, ...]] = pydantic.Field(
        None, title="Run only",
        description="Restrict which source indices are actually run.",
    )
    element_mappings: Tuple = pydantic.Field(
        (), title="Element mappings",
        description="Symmetry relations filling S-matrix elements from computed "
        "ones: ((row_in, col_in), (row_out, col_out), mult).",
    )

    @pydantic.field_validator("freqs")
    @classmethod
    def _freqs_nonempty(cls, val):
        if len(val) == 0:
            raise SetupError("freqs must not be empty")
        return val

    @abstractmethod
    def sim_dict(self) -> Dict[str, Simulation]:
        """One simulation per excitation."""

    def make_batch(self, device="cuda") -> Batch:
        """The ``Batch`` of the excitations' simulations on ``device``."""
        return Batch(
            simulations=self.sim_dict(), folder_name=self.folder_name,
            verbose=self.verbose, callback_url=self.callback_url,
            solver_version=self.solver_version, device=str(device),
        )

    @cached_property
    def batch(self) -> Batch:
        return self.make_batch()

    @cached_property
    def batch_data(self) -> BatchData:
        return self.batch.run(path_dir=self.path_dir)

    def get_path_dir(self, path_dir: str) -> str:
        return path_dir

    @staticmethod
    def s_to_z(s_matrix, reference: complex):
        """Convert an S-matrix DataArray to an impedance (Z) matrix."""
        s = np.asarray(s_matrix.values if hasattr(s_matrix, "values") else s_matrix)
        eye = np.eye(s.shape[-1])
        z = reference * np.linalg.solve(
            (eye - s).reshape(-1, *s.shape[-2:]),
            (eye + s).reshape(-1, *s.shape[-2:]),
        ).reshape(s.shape)
        return z

    @abstractmethod
    def _construct_smatrix(self, batch_data: BatchData):
        """Assemble the S matrix from the batch results."""

    def run(self, path_dir: str = None, device="cuda"):
        """Run all simulations on ``device`` and construct the S-matrix."""
        batch_data = self.make_batch(device).run(
            path_dir=path_dir or self.path_dir)
        return self._construct_smatrix(batch_data)

    def load(self, path_dir: str = None):
        return self._construct_smatrix(self.batch_data)
