"""Topology design region for inverse design: the counterpart of
``tidy3d_tpu/plugins/invdes/region.py``, its transformation and penalty on
torch tensors.

Behavioral model: tidy3d's ``plugins/invdes/region.py``
(TopologyDesignRegion:131 — pixellated density region with filter+project
transformation and fabrication penalties).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import pydantic

from ...components.base import Tidy3dBaseModel, cached_property
from ...components.data.data_array import SpatialDataArray
from ...components.geometry.base import Box
from ...components.medium import CustomMedium, Medium
from ...components.structure import Structure
from ...components.types import Coordinate, Size


class TopologyDesignRegion(Tidy3dBaseModel):
    """Density-parametrized rectangular design region."""

    center: Coordinate = pydantic.Field(..., title="Center")
    size: Size = pydantic.Field(..., title="Size")
    eps_bounds: Tuple[float, float] = pydantic.Field(
        (1.0, 4.0), title="(eps_min, eps_max)")
    pixel_size: Optional[float] = pydantic.Field(
        None, title="Pixel size (defaults to the simulation grid)")
    radius: float = pydantic.Field(
        0.0, title="Smoothing filter radius (um)")
    beta: float = pydantic.Field(1.0, title="Projection strength")
    eta: float = pydantic.Field(0.5, title="Projection threshold")
    penalty_weight: float = pydantic.Field(
        0.0, title="Erosion-dilation penalty weight")
    seed: Optional[int] = pydantic.Field(0, title="Random seed for init")

    @cached_property
    def geometry(self) -> Box:
        return Box(center=self.center, size=self.size)

    def params_shape(self, simulation) -> Tuple[int, int, int]:
        grid = simulation.grid
        (i0, i1), (j0, j1), (k0, k1) = grid.discretize_inds(self.geometry)
        return (i1 - i0, j1 - j0, k1 - k0)

    def initial_parameters(self, simulation, value: float = 0.5) -> np.ndarray:
        return np.full(self.params_shape(simulation), value)

    def random_parameters(self, simulation) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.uniform(0, 1, self.params_shape(simulation))

    def transform(self, params, dl: float = None):
        """Filter + project the raw parameters into a physical density (a
        tensor that autograd differentiates with respect to ``params``)."""
        from ..autograd.functions import _clip01, _tensor
        from ..autograd.invdes import make_filter_and_project

        params = _clip01(_tensor(params))
        if self.radius > 0:
            fp = make_filter_and_project(
                radius=self.radius, dl=dl or self.radius / 2, beta=self.beta,
                eta=self.eta)
            return fp(params)
        return params

    def penalty(self, params, dl: float = None):
        if self.penalty_weight == 0 or self.radius == 0:
            return 0.0
        from ..autograd.functions import _tensor
        from ..autograd.invdes import make_erosion_dilation_penalty

        pen = make_erosion_dilation_penalty(radius=self.radius,
                                            dl=dl or self.radius / 2)
        return self.penalty_weight * pen(_tensor(params))

    def to_structure(self, density: np.ndarray, simulation) -> Structure:
        """CustomMedium structure from a (physical) density array."""
        grid = simulation.grid
        (i0, i1), (j0, j1), (k0, k1) = grid.discretize_inds(self.geometry)
        xs = np.asarray(grid.centers.x)[i0:i1]
        ys = np.asarray(grid.centers.y)[j0:j1]
        zs = np.asarray(grid.centers.z)[k0:k1]
        eps_min, eps_max = self.eps_bounds
        eps = eps_min + np.asarray(density) * (eps_max - eps_min)
        arr = SpatialDataArray(eps, coords=dict(x=xs, y=ys, z=zs))
        return Structure(geometry=self.geometry,
                         medium=CustomMedium(permittivity=arr))
