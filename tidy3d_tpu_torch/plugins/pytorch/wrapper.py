"""Torch bridge: a scalar function wrapped as a ``torch.autograd.Function``.

The counterpart of ``tidy3d_tpu/plugins/pytorch/wrapper.py:12-37``, which
wraps a JAX function: there the value and the gradient come from
``jax.value_and_grad`` in the forward pass, and the backward pass scales
the saved gradient by the incoming one. Here the function is written on
the port's tensors, and ``torch.autograd.grad`` takes the place of
``jax.value_and_grad``, with the same forward/backward split.
"""

from __future__ import annotations

import torch


def to_torch(fn):
    """Convert a scalar-output function of tensors into a
    torch-differentiable one: ``to_torch(fn)(*args)`` returns ``fn``'s
    value, and its ``backward()`` gives each argument ``fn``'s gradient
    (zeros where ``fn`` does not depend on it) times the incoming
    gradient."""

    class _Function(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            with torch.enable_grad():
                leaves = [a.detach().requires_grad_(True) for a in args]
                value = fn(*leaves)
                grads = torch.autograd.grad(value, leaves, allow_unused=True)
            ctx.save_for_backward(*[
                torch.zeros_like(a) if g is None else g
                for a, g in zip(leaves, grads)])
            return value.detach()

        @staticmethod
        def backward(ctx, grad_output):
            return tuple(grad_output * g for g in ctx.saved_tensors)

    def wrapped(*args):
        return _Function.apply(*args)

    return wrapped
