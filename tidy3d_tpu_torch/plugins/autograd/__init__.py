from . import invdes
from .functions import (
    convolve,
    grad,
    grey_closing,
    grey_dilation,
    grey_erosion,
    grey_opening,
    make_kernel,
    morphological_gradient,
    pad,
    rescale,
    smooth_max,
    smooth_min,
    tanh_projection,
    threshold,
    value_and_grad,
)
