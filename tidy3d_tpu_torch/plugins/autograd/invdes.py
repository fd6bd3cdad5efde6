"""Inverse-design helper transformations and penalties, on torch tensors:
the counterpart of ``tidy3d_tpu/plugins/autograd/invdes.py``.

Behavioral model: tidy3d's ``plugins/autograd/invdes/`` (conic and
circular filters in filters.py, filter-and-project parametrizations, and the
erosion-dilation penalty in penalties.py).
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch

from .functions import (
    _tensor,
    convolve,
    grey_closing,
    grey_opening,
    make_kernel,
    tanh_projection,
)


def make_filter(kernel_type: str, radius: Union[int, Tuple[int, ...]],
                dl: Union[float, Tuple[float, ...]] = 1.0,
                normalize: bool = True, padding: str = "reflect") -> Callable:
    """A convolution filter fn with a circular/conic kernel of given radius."""

    def _filter(array):
        array = _tensor(array)
        if np.isscalar(radius):
            radii = (radius,) * array.ndim
        else:
            radii = radius
        dls = (dl,) * array.ndim if np.isscalar(dl) else dl
        size = tuple(max(int(np.ceil(2 * r / d)) // 2 * 2 + 1, 1)
                     for r, d in zip(radii, dls))
        kern = make_kernel(kernel_type, size, normalize=normalize)
        return convolve(array, torch.as_tensor(kern), padding=padding,
                        mode="same")

    return _filter


def make_circ_filter(radius, **kwargs) -> Callable:
    return make_filter("circular", radius, **kwargs)


def make_conic_filter(radius, **kwargs) -> Callable:
    return make_filter("conic", radius, **kwargs)


def make_filter_and_project(radius, dl=1.0, beta: float = 1.0, eta: float = 0.5,
                            filter_type: str = "conic", padding: str = "reflect"
                            ) -> Callable:
    """density -> filtered -> tanh-projected parametrization."""
    filt = make_filter(filter_type, radius, dl=dl, padding=padding)

    def parametrization(density, beta=beta, eta=eta):
        return tanh_projection(filt(density), beta=beta, eta=eta)

    return parametrization


def make_erosion_dilation_penalty(radius, dl=1.0, beta: float = 100.0,
                                  eta: float = 0.5, delta_eta: float = 0.01
                                  ) -> Callable:
    """Minimum-feature-size penalty: difference between eroded-dilated and
    dilated-eroded versions of the projected density."""
    filt = make_filter("conic", radius, dl=dl)

    def penalty(density):
        density = _tensor(density)
        filtered = filt(density)
        eroded = tanh_projection(filtered, beta=beta, eta=eta + delta_eta)
        dilated = tanh_projection(filtered, beta=beta, eta=eta - delta_eta)
        opened = tanh_projection(filt(eroded), beta=beta, eta=eta - delta_eta)
        closed = tanh_projection(filt(dilated), beta=beta, eta=eta + delta_eta)
        diff1 = (density - opened) ** 2
        diff2 = (density - closed) ** 2
        return torch.mean(torch.minimum(diff1, diff2))

    return penalty


def get_kernel_size_px(radius: float, dl: float) -> int:
    return max(int(np.ceil(2 * radius / dl)) // 2 * 2 + 1, 1)
