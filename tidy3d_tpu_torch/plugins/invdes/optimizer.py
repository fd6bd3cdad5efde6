"""Adam optimizer driving an InverseDesign: the counterpart of
``tidy3d_tpu/plugins/invdes/optimizer.py``, whose Adam is optax's.

Behavioral model: tidy3d's ``plugins/invdes/optimizer.py``
(AdamOptimizer:260 with history/serialization). The update is optax's
``adam`` written out in float32 numpy, operation for operation
(``adam_step``), so the iterates are the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import pydantic

from ...components.base import Tidy3dBaseModel
from ...log import log
from .design import InverseDesign


class OptimizeResult(Tidy3dBaseModel):
    """Optimization history."""

    params: object = pydantic.Field(..., title="Final parameters")
    objective_history: Tuple[float, ...] = pydantic.Field((), title="Objective values")
    params_history: Tuple = pydantic.Field((), title="Parameter snapshots")

    @property
    def final_objective(self) -> float:
        return self.objective_history[-1] if self.objective_history else np.nan


def adam_init(params: np.ndarray) -> tuple:
    """optax ``adam``'s state: ``(count, mu, nu)``."""
    return 0, np.zeros_like(params), np.zeros_like(params)


def adam_step(grad: np.ndarray, state: tuple, learning_rate: float,
              b1: float, b2: float, eps: float) -> tuple:
    """``(updates, state)`` of one optax ``adam`` update (``scale_by_adam``
    with ``eps_root = 0``, then ``scale_by_learning_rate``), in the types
    and order of optax's operations: the moments ``(1 - b) g^k + b m``, the
    bias corrections ``1 - b^count`` in float32, ``mu_hat / (sqrt(nu_hat) +
    eps)`` and ``-lr`` times it."""
    count, mu, nu = state
    count += 1
    mu = (1 - b1) * grad + b1 * mu
    nu = (1 - b2) * (grad * grad) + b2 * nu
    one = np.float32(1)
    mu_hat = mu / (one - np.float32(b1) ** np.float32(count))
    nu_hat = nu / (one - np.float32(b2) ** np.float32(count))
    updates = -learning_rate * (mu_hat / (np.sqrt(nu_hat) + eps))
    return updates, (count, mu, nu)


class AdamOptimizer(Tidy3dBaseModel):
    """Adam gradient-ascent optimizer."""

    design: InverseDesign = pydantic.Field(..., title="Inverse design problem")
    learning_rate: pydantic.PositiveFloat = pydantic.Field(0.1)
    num_steps: pydantic.PositiveInt = pydantic.Field(10)
    beta1: float = pydantic.Field(0.9)
    beta2: float = pydantic.Field(0.999)
    eps: float = pydantic.Field(1e-8)
    store_history: bool = pydantic.Field(True)
    results_cache_fname: Optional[str] = pydantic.Field(None)

    def run(self, params0=None) -> OptimizeResult:
        params = np.asarray(params0 if params0 is not None
                            else self.design.initial_parameters(), dtype=np.float32)
        state = adam_init(params)
        history: List[float] = []
        snapshots = []
        for step in range(self.num_steps):
            value, grad = self.design.objective_fn(params)
            history.append(float(value))
            if self.store_history:
                snapshots.append(np.array(params))
            # gradient ASCENT on the objective
            updates, state = adam_step(
                -np.asarray(grad, np.float32), state, self.learning_rate,
                self.beta1, self.beta2, self.eps)
            params = np.clip((params + updates).astype(params.dtype),
                             0.0, 1.0)
            log.info(f"invdes step {step + 1}/{self.num_steps}: J = {value:.4e}")
        result = OptimizeResult(params=params, objective_history=tuple(history),
                                params_history=tuple(snapshots))
        if self.results_cache_fname:
            np.savez(self.results_cache_fname, params=params,
                     objective_history=np.asarray(history))
        return result

    continue_run = run
