"""InverseDesign: bundles simulation + design region + objective: the
counterpart of ``tidy3d_tpu/plugins/invdes/design.py``.

Behavioral model: tidy3d's ``plugins/invdes/design.py`` (InverseDesign:118).
Two gradient methods, as the JAX package's: ``adjoint`` (two ``web.run``
solves on the kernels, the production route) and ``autodiff`` (autograd
through the checkpointed time loop, ``plugins/adjoint/topology.py``). The
transformation's VJP and the penalty's gradient are taken by
``torch.autograd`` on ``device`` too.

``device`` (default ``"cuda"``, as every entry point of the port) is where
the solves, the region's transformation and its penalty run; the JAX
package's ``InverseDesign`` has no such field, it runs on the one device
JAX was given. The Adam update of ``optimizer.py`` stays in numpy on the
host, as a few float32 operations on the parameters.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import pydantic

from ...components.base import Tidy3dBaseModel, cached_property
from ...components.simulation import Simulation
from ...components.types import Direction
from ...exceptions import SetupError
from .region import TopologyDesignRegion


class InverseDesign(Tidy3dBaseModel):
    """An inverse-design problem definition."""

    simulation: Simulation = pydantic.Field(..., title="Base simulation")
    design_region: TopologyDesignRegion = pydantic.Field(..., title="Design region")
    output_monitor_name: str = pydantic.Field(
        ..., title="Objective monitor name",
        description="ModeMonitor whose |amp|^2 is maximized (custom objectives "
        "via the metric field).")
    direction: Direction = pydantic.Field("+", title="Objective mode direction")
    mode_index: int = pydantic.Field(0, title="Objective mode index")
    task_name: str = pydantic.Field("invdes", title="Task name")
    verbose: bool = pydantic.Field(False)
    device: str = pydantic.Field(
        "cuda", title="Device",
        description="Where both methods' solves run (web.run's device).")
    method: str = pydantic.Field(
        "adjoint", title="Gradient method",
        description="'adjoint': two forward solves on the kernel path "
        "(CustomMedium per-cell VJPs through run_structure_gradients — the "
        "production route, both solves run on the kernels); "
        "'autodiff': exact reverse-mode autograd through the checkpointed "
        "time loop (no kernel; research/verification route).")

    @pydantic.field_validator("method")
    @classmethod
    def _check_method(cls, val):
        if val not in ("adjoint", "autodiff"):
            raise ValueError("method must be 'adjoint' or 'autodiff'")
        return val

    @cached_property
    def _topology(self):
        from ..adjoint import TopologyObjective

        eps_min, eps_max = self.design_region.eps_bounds
        return TopologyObjective(
            self.simulation, self.design_region.geometry,
            eps_min=eps_min, eps_max=eps_max,
            mode_monitor_name=self.output_monitor_name,
            direction=self.direction, mode_index=self.mode_index,
            device=self.device,
        )

    @cached_property
    def _dl(self) -> float:
        sizes = self.simulation.grid.sizes
        return float(np.min([np.min(np.asarray(s)) for s in sizes.to_list[:2]]))

    def _density_value_and_grad_adjoint(self, density):
        """(value, dJ/d density) via TWO forward solves on the kernel path:
        the design realized as a CustomMedium structure, mode-amp objective
        differentiated through the adjoint-simulation protocol
        (web.autograd.run_structure_gradients), per-cell gradients from
        CustomMedium.compute_derivatives. Both solves are ordinary forward
        runs — no autograd, so the kernels stay engaged (the reference's
        two-cloud-solve architecture, autograd/autograd.py:86, mapped to
        in-process execution)."""
        import torch

        from ...web.autograd import run_structure_gradients

        structure = self.design_region.to_structure(
            np.asarray(density), self.simulation)
        sim2 = self.simulation.copy(update=dict(
            structures=tuple(self.simulation.structures) + (structure,)))
        si = len(sim2.structures) - 1
        name = self.output_monitor_name
        dir_idx = list("+-").index(self.direction)
        mode_idx = self.mode_index

        def obj(fields):
            amps = fields[name]["amps"]  # (direction, f, mode_index)
            sel = amps[dir_idx, :, mode_idx]
            return torch.sum(torch.abs(sel) ** 2)

        value, grads, _ = run_structure_gradients(
            sim2, obj, {si: [("medium", "permittivity")]},
            monitor_names=[name], device=self.device)
        eps_min, eps_max = self.design_region.eps_bounds
        g_eps = grads[si][("medium", "permittivity")]
        return float(value), (eps_max - eps_min) * np.asarray(g_eps)

    def objective_fn(self, params) -> Tuple[float, np.ndarray]:
        """(value, gradient wrt raw params): maximize |amp|^2 - penalties.
        ``params`` are taken as float32, as the JAX package takes them; the
        transformation, the penalty and their gradients run on
        ``device``."""
        import torch

        from ..autograd.functions import full_f32_conv

        region = self.design_region

        def leaf():
            return torch.as_tensor(np.asarray(params, np.float32),
                                   device=self.device).requires_grad_(True)

        with full_f32_conv():
            p = leaf()
            density = region.transform(p, dl=self._dl)
            rho = density.detach().cpu().numpy()
            if self.method == "adjoint":
                value, grad_density = \
                    self._density_value_and_grad_adjoint(rho)
            else:
                value, grad_density = self._topology.value_and_grad(rho)
            (grad_params,) = torch.autograd.grad(
                density, p, torch.as_tensor(
                    np.asarray(grad_density, np.float32), device=p.device))
            penalty_val = 0.0
            if region.penalty_weight > 0:
                p = leaf()
                pen = region.penalty(p, dl=self._dl)
                if torch.is_tensor(pen):
                    (pen_grad,) = torch.autograd.grad(pen, p)
                    penalty_val = float(pen.detach())
                    grad_params = grad_params - pen_grad
        return value - penalty_val, grad_params.cpu().numpy()

    def initial_parameters(self) -> np.ndarray:
        return self.design_region.initial_parameters(self.simulation)

    def to_simulation(self, params) -> Simulation:
        """Simulation with the design structure realized from params."""
        density = self.design_region.transform(
            np.asarray(params, np.float32), dl=self._dl).detach().numpy()
        structure = self.design_region.to_structure(density, self.simulation)
        return self.simulation.copy(update=dict(
            structures=tuple(self.simulation.structures) + (structure,)))
