"""Differentiable operations toolbox for inverse design, on torch tensors:
the counterpart of ``tidy3d_tpu/plugins/autograd/functions.py``.

Every function takes a tensor (or an array-like, which becomes one) and
returns a tensor that autograd differentiates; results follow the JAX
package's: ``pad`` has numpy's modes, ``convolve`` is a true convolution
(the flipped kernel), the grey morphology takes ties of the maximum as
``jnp.maximum`` does (half the gradient to each side), and
``value_and_grad`` / ``grad`` return in JAX's order. A tensor on the card
is computed on the card; convolutions there run in full float32
(``full_f32_conv``), as the JAX package's float32 ones.
"""

from __future__ import annotations

import contextlib
from typing import Literal, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

PaddingType = Literal["constant", "edge", "reflect", "symmetric", "wrap"]

_PAD_MODES = {
    "constant": "constant",
    "edge": "edge",
    "reflect": "reflect",
    "symmetric": "symmetric",
    "wrap": "wrap",
}


def _tensor(array) -> torch.Tensor:
    return array if torch.is_tensor(array) else torch.as_tensor(
        np.asarray(array))


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """``x`` clipped to [0, 1] with ``jnp.clip``'s gradient: its maximum
    and minimum give half the gradient at a bound, as ``torch.maximum`` and
    ``torch.minimum`` do (``torch.clamp`` gives all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(0.0)),
                         x.new_tensor(1.0))


def pad(array, pad_width, *, mode: PaddingType = "constant",
        constant_value=0.0):
    """Pad an array along all axes, as ``jnp.pad`` (numpy's modes). The
    non-constant modes gather each axis by the index map numpy's own
    ``np.pad`` gives ``arange(n)``, so widths beyond the axis behave as
    numpy's do."""
    array = _tensor(array)
    if np.isscalar(pad_width):
        pad_width = [(pad_width, pad_width)] * array.ndim
    pad_width = [(int(lo), int(hi)) for lo, hi in pad_width]
    np_mode = _PAD_MODES[mode]
    if np_mode == "constant":
        flat = [p for lo, hi in reversed(pad_width) for p in (lo, hi)]
        return F.pad(array, flat, mode="constant", value=constant_value)
    out = array
    for axis, (lo, hi) in enumerate(pad_width):
        if lo or hi:
            idx = np.pad(np.arange(array.shape[axis]), (lo, hi), mode=np_mode)
            out = out.index_select(axis, torch.as_tensor(idx,
                                                         device=out.device))
    return out


@contextlib.contextmanager
def full_f32_conv():
    """Float32 convolutions in full precision inside the block (cuDNN's
    TF32 off), whatever the process set outside it. A caller that takes a
    convolution's gradient holds the block over the backward pass too."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def convolve(array, kernel, *, padding: PaddingType = "constant",
             mode: str = "same"):
    """N-D convolution (N = 1, 2, 3) with selectable padding, as
    ``jax.scipy.signal.convolve``: the flipped kernel through
    ``conv{N}d``. ``same`` pads ``(k // 2, k - 1 - k // 2)`` per axis
    (zeros for ``constant``), ``full`` pads ``k - 1`` zeros each side."""
    array = _tensor(array)
    kernel = _tensor(kernel).to(array.device)
    if array.is_floating_point():
        kernel = kernel.to(array.dtype)
    if mode == "same":
        pw = [(k // 2, k - 1 - k // 2) for k in kernel.shape]
        array = pad(array, pw, mode=padding)
    elif mode == "full":
        array = pad(array, [(k - 1, k - 1) for k in kernel.shape])
    elif mode != "valid":
        raise ValueError(f"mode {mode!r}: 'same', 'valid' or 'full'")
    nd = array.ndim
    if nd not in (1, 2, 3) or kernel.ndim != nd:
        raise NotImplementedError(
            f"convolution of a {nd}-D array with a {kernel.ndim}-D kernel: "
            "the port convolves 1-, 2- and 3-D arrays")
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    flipped = torch.flip(kernel, dims=tuple(range(nd)))
    with full_f32_conv():
        return conv(array[None, None], flipped[None, None])[0, 0]


# --------------------------------------------------------------------------- #
# morphology
# --------------------------------------------------------------------------- #


def _structuring_kernel(radius: Union[int, Tuple[int, ...]], ndim: int,
                        structure: str = "circular") -> np.ndarray:
    if np.isscalar(radius):
        radius = (radius,) * ndim
    shape = tuple(2 * r + 1 for r in radius)
    if structure == "square":
        return np.ones(shape)
    grids = np.meshgrid(*[np.arange(-r, r + 1) / max(r, 1) for r in radius],
                        indexing="ij")
    dist = sum(g**2 for g in grids)
    return (dist <= 1.0).astype(float)


def grey_dilation(array, size=None, structure=None,
                  mode: PaddingType = "reflect"):
    """Grey-scale dilation (max filter) via padded max pooling."""
    array = _tensor(array)
    kern = structure if structure is not None else _structuring_kernel(
        size if size is not None else 1, array.ndim)
    kern = np.asarray(kern) > 0
    pw = [(s // 2, s - 1 - s // 2) for s in kern.shape]
    padded = pad(array, pw, mode=mode)
    out = torch.full(array.shape, -torch.inf, dtype=array.dtype,
                     device=array.device)
    for idx in np.ndindex(kern.shape):
        if not kern[idx]:
            continue
        slices = tuple(slice(i, i + s) for i, s in zip(idx, array.shape))
        out = torch.maximum(out, padded[slices])
    return out


def grey_erosion(array, size=None, structure=None,
                 mode: PaddingType = "reflect"):
    return -grey_dilation(-_tensor(array), size=size, structure=structure,
                          mode=mode)


def grey_opening(array, size=None, structure=None,
                 mode: PaddingType = "reflect"):
    return grey_dilation(grey_erosion(array, size, structure, mode),
                         size, structure, mode)


def grey_closing(array, size=None, structure=None,
                 mode: PaddingType = "reflect"):
    return grey_erosion(grey_dilation(array, size, structure, mode),
                        size, structure, mode)


def morphological_gradient(array, size=None, structure=None,
                           mode: PaddingType = "reflect"):
    return grey_dilation(array, size, structure, mode) - grey_erosion(
        array, size, structure, mode)


def morphological_gradient_internal(array, size=None, structure=None,
                                    mode: PaddingType = "reflect"):
    return _tensor(array) - grey_erosion(array, size, structure, mode)


def morphological_gradient_external(array, size=None, structure=None,
                                    mode: PaddingType = "reflect"):
    return grey_dilation(array, size, structure, mode) - _tensor(array)


# --------------------------------------------------------------------------- #
# filters / projections
# --------------------------------------------------------------------------- #


def make_kernel(kernel_type: Literal["circular", "conic"],
                size: Tuple[int, ...], normalize: bool = True) -> np.ndarray:
    """Circular (top-hat) or conic filter kernel."""
    grids = np.meshgrid(*[np.linspace(-1, 1, s) for s in size], indexing="ij")
    dist = np.sqrt(sum(g**2 for g in grids))
    if kernel_type == "circular":
        kern = (dist <= 1.0).astype(float)
    else:
        kern = np.maximum(1.0 - dist, 0.0)
    if normalize and kern.sum() > 0:
        kern = kern / kern.sum()
    return kern


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """A scalar as a tensor of ``like``'s floating type and device."""
    dtype = like.dtype if like.is_floating_point() \
        else torch.get_default_dtype()
    return torch.as_tensor(value, dtype=dtype, device=like.device)


def threshold(array, vmin: float = 0.0, vmax: float = 1.0, level=None):
    """Hard threshold an array to binary {vmin, vmax}."""
    array = _tensor(array)
    if level is None:
        level = (vmin + vmax) / 2
    return torch.where(array < level, _scalar(vmin, array),
                       _scalar(vmax, array))


def rescale(array, out_min: float, out_max: float, in_min: float = 0.0,
            in_max: float = 1.0):
    array = _tensor(array)
    scaled = (array - in_min) / (in_max - in_min)
    return scaled * (out_max - out_min) + out_min


def tanh_projection(array, beta: float = 1.0, eta: float = 0.5):
    """Smooth binarization projection (Wang et al. 2011)."""
    array = _tensor(array)
    num = torch.tanh(_scalar(beta * eta, array)) \
        + torch.tanh(beta * (array - eta))
    den = torch.tanh(_scalar(beta * eta, array)) \
        + torch.tanh(_scalar(beta * (1.0 - eta), array))
    return num / den


def smooth_min(values, tau: float = 1.0):
    values = _tensor(values)
    return -tau * torch.logsumexp((-values / tau).reshape(-1), 0)


def smooth_max(values, tau: float = 1.0):
    values = _tensor(values)
    return tau * torch.logsumexp((values / tau).reshape(-1), 0)


def least_squares(fn, x_data, y_data, init_params, max_iterations: int = 100,
                  tol: float = 1e-12):
    """Simple least-squares fit via Gauss-Newton, in float64: each step
    solves ``J step = -r`` with the Jacobian of ``torch.func.jacrev``."""
    params = torch.as_tensor(np.asarray(init_params), dtype=torch.float64)
    x_data = _tensor(x_data).to(torch.float64)
    y_data = _tensor(y_data).to(torch.float64)

    def resid(p):
        return fn(x_data, *p) - y_data

    jac = torch.func.jacrev(resid)
    for _ in range(max_iterations):
        r = resid(params)
        J = jac(params)
        try:
            step = torch.linalg.lstsq(J, -r[:, None]).solution[:, 0]
        except RuntimeError:
            break
        params = params + step
        if float(torch.max(torch.abs(step))) < tol:
            break
    return params


def _tensor_args(args):
    return tuple(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                 for a in args)


def value_and_grad(fn, argnums=0, has_aux: bool = False):
    """``fn``'s value and gradient in ``jax.value_and_grad``'s order,
    ``(value, grad)`` (``((value, aux), grad)`` with ``has_aux``), through
    ``torch.func.grad_and_value``; numpy arguments become tensors."""
    inner = torch.func.grad_and_value(fn, argnums=argnums, has_aux=has_aux)

    def wrapped(*args, **kwargs):
        grads, value = inner(*_tensor_args(args), **kwargs)
        return value, grads

    return wrapped


def grad(fn, argnums=0, has_aux: bool = False):
    """``torch.func.grad`` with numpy arguments made tensors (``jax.grad``'s
    returns: the gradient, or ``(grad, aux)``)."""
    inner = torch.func.grad(fn, argnums=argnums, has_aux=has_aux)

    def wrapped(*args, **kwargs):
        return inner(*_tensor_args(args), **kwargs)

    return wrapped
