"""The torch bridge, ``tidy3d_tpu_torch.plugins.pytorch.to_torch``, against
the JAX package's (``tidy3d_tpu.plugins.pytorch.to_torch``) on the objective
of ``tests/test_plugins/test_aux_plugins.py:215-236``, written in ``jnp``
for the one and on tensors for the other: the same value and the same
``backward()`` gradient, to that test's tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidy3d_tpu_torch.plugins.pytorch import to_torch

# first: where h5py is missing it makes the JAX package importable
import tests.torch_cases  # noqa: F401
from tidy3d_tpu.plugins.pytorch import to_torch as jax_to_torch


def objective_jnp(x):
    return jnp.sum(jnp.sin(x) ** 2 + 0.5 * x)


def objective_torch(x):
    return torch.sum(torch.sin(x) ** 2 + 0.5 * x)


def _value_and_grad(fn, x_np, scale=1.0):
    x = torch.tensor(x_np, requires_grad=True, dtype=torch.float32)
    val = fn(x)
    (scale * val).backward()
    return float(val), x.grad.numpy()


@pytest.mark.parametrize("scale", [1.0, -2.5])
def test_bridge_matches_the_jax_bridge(scale):
    x_np = np.linspace(-1.0, 2.0, 5)
    val_ref, grad_ref = _value_and_grad(jax_to_torch(objective_jnp), x_np,
                                        scale)
    val, grad = _value_and_grad(to_torch(objective_torch), x_np, scale)
    assert val == pytest.approx(val_ref, rel=1e-5)
    np.testing.assert_allclose(grad, grad_ref, rtol=1e-4, atol=1e-6)
    # and the JAX package's own values (test_aux_plugins.py)
    assert val == pytest.approx(float(objective_jnp(jnp.asarray(x_np))),
                                rel=1e-5)
    np.testing.assert_allclose(
        grad / scale, np.asarray(jax.grad(objective_jnp)(jnp.asarray(x_np))),
        rtol=1e-4, atol=1e-6)


def test_bridge_takes_several_arguments_and_an_unused_one():
    """Several arguments, one unused: each gradient is ``jax.grad``'s over
    every argument (the JAX package's bridge differentiates the first
    argument only and its backward then raises: ROADMAP.md queue 3)."""
    def fn_jnp(a, b, c):
        return jnp.sum(a * jnp.cos(b)) + 0.0 * jnp.sum(c)

    def fn_torch(a, b, c):
        return torch.sum(a * torch.cos(b))

    rng = np.random.default_rng(3)
    args = [rng.standard_normal(4).astype(np.float32) for _ in range(3)]
    want = jax.grad(fn_jnp, argnums=(0, 1, 2))(*map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    value = to_torch(fn_torch)(*ts)
    value.backward()
    assert float(value) == pytest.approx(float(fn_jnp(*args)), rel=1e-5)
    for t, ref in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-6)
    assert not np.any(ts[2].grad.numpy())
