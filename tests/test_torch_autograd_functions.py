"""``tidy3d_tpu_torch.plugins.autograd`` against the JAX package's.

Each function of ``functions.py`` and ``invdes.py`` runs on the same seeded
float32 numpy inputs in both packages; values must agree to ``TOL_VALUE``
of the largest magnitude and gradients (``torch.autograd`` of ``sum(w *
f(x))`` for a seeded weight ``w``, against ``jax.grad``) to ``TOL_GRAD``.
Measured on the CPU (``-s`` prints each check's errors), value /
gradient: ``pad`` 0 / 3.6e-8 (a gather; the gradient sums repeated
indices in another order), morphology 0 / 5.9e-8, convolutions 2.3e-7 /
1.6e-7, projections 1.2e-7 / 4.8e-7, filters 5.7e-7 / 4.2e-7,
filter-and-project 6.8e-7 / 3.9e-7, the erosion-dilation penalty 3.2e-7 /
2.3e-6 (float32 sums in another order); ``least_squares`` (the JAX package
fits in float32, the port in float64) 4.2e-8.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidy3d_tpu_torch.plugins import autograd as port

# first: where h5py is missing it makes the JAX package importable
import tests.torch_cases  # noqa: F401
from tidy3d_tpu.plugins import autograd as ref

TOL_VALUE = 1e-6
TOL_GRAD = 1e-5
PAD_MODES = ["constant", "edge", "reflect", "symmetric", "wrap"]
KERNELS = ["circular", "conic"]
RADII = [1, 2]


def _x(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _err(ref_v, got) -> float:
    ref_v = np.asarray(ref_v, np.float64)
    got = np.asarray(got, np.float64)
    assert ref_v.shape == got.shape, (ref_v.shape, got.shape)
    return float(np.max(np.abs(ref_v - got))
                 / (np.max(np.abs(ref_v)) + 1e-30))


def check(ref_fn, port_fn, x, grad: bool = True):
    """Holds ``port_fn(x)`` to ``ref_fn(x)`` and, with ``grad``, the
    gradients of ``sum(w * f(x))``; returns (value error, gradient
    error)."""
    want = np.asarray(ref_fn(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = port_fn(xt)
    e_val = _err(want, got.detach().numpy())
    assert e_val <= TOL_VALUE, f"value rel err {e_val:.2e}"
    if not grad:
        return e_val, None
    w = np.random.default_rng(7).standard_normal(want.shape).astype(
        np.float32)
    g_ref = jax.grad(lambda a: jnp.sum(jnp.asarray(w) * ref_fn(a)))(
        jnp.asarray(x))
    (g_got,) = torch.autograd.grad(torch.sum(torch.as_tensor(w) * got), xt)
    e_grad = _err(np.asarray(g_ref), g_got.numpy())
    test = os.environ.get("PYTEST_CURRENT_TEST", "").split("::")[-1]
    print(f"{test.split()[0]}: value {e_val:.1e} grad {e_grad:.1e}")
    assert e_grad <= TOL_GRAD, f"gradient rel err {e_grad:.2e}"
    return e_val, e_grad


@pytest.mark.parametrize("mode", PAD_MODES)
@pytest.mark.parametrize("width", [2, [(1, 3), (4, 0)]])
def test_pad(mode, width):
    check(lambda a: ref.pad(a, width, mode=mode),
          lambda a: port.pad(a, width, mode=mode), _x((6, 5)))


def test_pad_constant_value_and_3d():
    check(lambda a: ref.pad(a, 1, mode="constant", constant_value=0.3),
          lambda a: port.pad(a, 1, mode="constant", constant_value=0.3),
          _x((4, 5, 3)))


@pytest.mark.parametrize("padding", PAD_MODES)
@pytest.mark.parametrize("mode", ["same", "valid"])
@pytest.mark.parametrize("kernel_type", KERNELS)
@pytest.mark.parametrize("radius", RADII)
def test_convolve(padding, mode, kernel_type, radius):
    kern = port.make_kernel(kernel_type, (2 * radius + 1, 2 * radius + 3))
    assert np.array_equal(kern, ref.make_kernel(
        kernel_type, (2 * radius + 1, 2 * radius + 3)))
    check(lambda a: ref.convolve(a, jnp.asarray(kern), padding=padding,
                                 mode=mode),
          lambda a: port.convolve(a, kern, padding=padding, mode=mode),
          _x((9, 11)))


@pytest.mark.parametrize("ndim", [1, 3])
def test_convolve_1d_3d_and_full(ndim):
    shape = (7, 8, 6)[:ndim]
    kern = _x((3, 2, 3)[:ndim], seed=5)
    for mode in ("same", "valid", "full"):
        check(lambda a: ref.convolve(a, jnp.asarray(kern), mode=mode),
              lambda a: port.convolve(a, kern, mode=mode), _x(shape))


MORPHOLOGY = ["grey_dilation", "grey_erosion", "grey_opening",
              "grey_closing", "morphological_gradient",
              "morphological_gradient_internal",
              "morphological_gradient_external"]


@pytest.mark.parametrize("name", MORPHOLOGY)
@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("mode", ["reflect", "symmetric", "edge"])
def test_morphology(name, radius, mode):
    from tidy3d_tpu.plugins.autograd import functions as ref_f
    from tidy3d_tpu_torch.plugins.autograd import functions as port_f

    check(lambda a: getattr(ref_f, name)(a, size=radius, mode=mode),
          lambda a: getattr(port_f, name)(a, size=radius, mode=mode),
          _x((8, 7)))


def test_morphology_square_structure():
    struct = np.ones((3, 5))
    check(lambda a: ref.grey_dilation(a, structure=struct),
          lambda a: port.grey_dilation(a, structure=struct), _x((6, 9)))


@pytest.mark.parametrize("name, args", [
    ("threshold", {}), ("threshold", {"vmin": -1.0, "vmax": 2.0,
                                      "level": 0.3}),
    ("rescale", {"out_min": -2.0, "out_max": 3.0}),
    ("rescale", {"out_min": 1.0, "out_max": 12.0, "in_min": 0.2,
                 "in_max": 0.9}),
    ("tanh_projection", {}), ("tanh_projection", {"beta": 8.0, "eta": 0.4}),
    ("smooth_min", {}), ("smooth_min", {"tau": 0.05}),
    ("smooth_max", {}), ("smooth_max", {"tau": 0.05}),
])
def test_projections(name, args):
    check(lambda a: getattr(ref, name)(a, **args),
          lambda a: getattr(port, name)(a, **args), _x((5, 6)),
          grad=name != "threshold")


def test_least_squares():
    """A Gauss-Newton fit of y = a exp(-b x) + c on exact data: the JAX
    package fits in float32, the port in float64."""
    from tidy3d_tpu.plugins.autograd.functions import least_squares as ref_ls
    from tidy3d_tpu_torch.plugins.autograd.functions import least_squares

    x = np.linspace(0, 3, 20)
    y = 1.7 * np.exp(-0.8 * x) + 0.3
    want = ref_ls(lambda x, a, b, c: a * jnp.exp(-b * x) + c, x, y,
                  [1.0, 1.0, 0.0])
    got = least_squares(lambda x, a, b, c: a * torch.exp(-b * x) + c, x, y,
                        [1.0, 1.0, 0.0])
    err = _err(np.asarray(want), got.numpy())
    print(f"least squares {err:.1e}")
    assert err <= TOL_VALUE, err
    assert np.allclose(got.numpy(), [1.7, 0.8, 0.3], rtol=1e-10)


def test_value_and_grad_order():
    """``value_and_grad`` returns (value, grad), with ``has_aux`` ((value,
    aux), grad), and ``grad`` the gradient, as JAX's do."""
    x = _x((4,))

    def f_ref(a, b):
        return jnp.sum(a ** 2 * b), jnp.max(a)

    def f_port(a, b):
        return torch.sum(a ** 2 * b), torch.max(a)

    (v_r, aux_r), g_r = ref.value_and_grad(f_ref, argnums=1, has_aux=True)(
        x, 2.0 * x)
    (v_p, aux_p), g_p = port.value_and_grad(f_port, argnums=1, has_aux=True)(
        x, 2.0 * x)
    assert _err(v_r, v_p) <= TOL_VALUE and _err(aux_r, aux_p) == 0.0
    assert _err(g_r, g_p) <= TOL_GRAD
    v_r, g_r = ref.value_and_grad(lambda a: f_ref(a, a)[0])(x)
    v_p, g_p = port.value_and_grad(lambda a: f_port(a, a)[0])(x)
    assert _err(v_r, v_p) <= TOL_VALUE and _err(g_r, g_p) <= TOL_GRAD
    g_p2 = port.grad(lambda a: f_port(a, a)[0])(x)
    assert _err(ref.grad(lambda a: f_ref(a, a)[0])(x), g_p2) <= TOL_GRAD


@pytest.mark.parametrize("kernel_type", KERNELS)
@pytest.mark.parametrize("radius", [0.15, 0.3])
@pytest.mark.parametrize("padding", ["reflect", "constant"])
def test_filters(kernel_type, radius, padding):
    make = {"circular": "make_circ_filter", "conic": "make_conic_filter"}[
        kernel_type]
    for dl, shape in ((0.05, (12, 10)), (0.1, (9, 8, 7))):
        check(getattr(ref.invdes, make)(radius, dl=dl, padding=padding),
              getattr(port.invdes, make)(radius, dl=dl, padding=padding),
              _x(shape))


@pytest.mark.parametrize("filter_type", KERNELS)
@pytest.mark.parametrize("radius", [0.15, 0.3])
def test_filter_and_project(filter_type, radius):
    kw = dict(dl=0.05, beta=6.0, eta=0.45, filter_type=filter_type)
    check(ref.invdes.make_filter_and_project(radius, **kw),
          port.invdes.make_filter_and_project(radius, **kw), _x((12, 10)))


@pytest.mark.parametrize("radius", [0.15, 0.3])
def test_erosion_dilation_penalty(radius):
    check(ref.invdes.make_erosion_dilation_penalty(radius, dl=0.05,
                                                   beta=20.0),
          port.invdes.make_erosion_dilation_penalty(radius, dl=0.05,
                                                    beta=20.0),
          _x((12, 10)))
    assert ref.invdes.get_kernel_size_px(radius, 0.05) == \
        port.invdes.get_kernel_size_px(radius, 0.05)
