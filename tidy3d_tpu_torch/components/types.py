"""Type aliases and pydantic helper types used across the schema layer.

Behavioral model: /root/reference/tidy3d/components/types.py — re-built for
pydantic v2 (the reference uses pydantic.v1).
"""

from __future__ import annotations

from typing import Annotated, Any, List, Literal, Tuple, Union

import numpy as np
import pydantic
from pydantic import BeforeValidator

# name of the discriminator field in serialized models
TYPE_TAG_STR = "type"


def annotate_type(UnionType):  # noqa: N803
    """Annotated union type using TYPE_TAG_STR as discriminator."""
    return Annotated[UnionType, pydantic.Field(discriminator=TYPE_TAG_STR)]


# --------------------------------------------------------------------------- #
# numpy-array field types
# --------------------------------------------------------------------------- #


def _array_validator(dtype, ndim):
    def validate(v):
        if v is None:
            return None
        if isinstance(v, (list, tuple)) and len(v) and isinstance(v[0], str):
            # e.g. "Infinity" markers from json round-trip
            v = [float(x) if isinstance(x, str) else x for x in v]
        arr = np.asarray(v, dtype=dtype)
        if ndim is not None and arr.ndim != ndim:
            if arr.ndim == 0 and ndim == 1:
                arr = arr.reshape(1)
            else:
                raise ValueError(f"expected {ndim}-dimensional array, got ndim={arr.ndim}")
        return arr

    return validate


def constrained_array(dtype=None, ndim=None):
    """An Annotated field type validating to a numpy array of given dtype/ndim."""
    return Annotated[Any, BeforeValidator(_array_validator(dtype, ndim))]


ArrayLike = constrained_array()
ArrayFloat1D = constrained_array(dtype=np.float64, ndim=1)
ArrayFloat2D = constrained_array(dtype=np.float64, ndim=2)
ArrayFloat3D = constrained_array(dtype=np.float64, ndim=3)
ArrayFloat4D = constrained_array(dtype=np.float64, ndim=4)
ArrayComplex1D = constrained_array(dtype=np.complex128, ndim=1)
ArrayComplex2D = constrained_array(dtype=np.complex128, ndim=2)
ArrayComplex3D = constrained_array(dtype=np.complex128, ndim=3)
ArrayComplex4D = constrained_array(dtype=np.complex128, ndim=4)
ArrayInt1D = constrained_array(dtype=np.int64, ndim=1)

TensorReal = constrained_array(dtype=np.float64, ndim=2)
MatrixReal4x4 = constrained_array(dtype=np.float64, ndim=2)

# --------------------------------------------------------------------------- #
# complex number support
# --------------------------------------------------------------------------- #


def _complex_validator(v):
    if v is None:
        return None
    if isinstance(v, dict):
        if "real" in v:
            return complex(v.get("real", 0.0), v.get("imag", 0.0))
        raise ValueError(f"cannot interpret dict {v} as complex")
    return complex(v)


Complex = Annotated[Any, BeforeValidator(_complex_validator)]

# --------------------------------------------------------------------------- #
# geometry-ish aliases
# --------------------------------------------------------------------------- #

Size1D = pydantic.NonNegativeFloat
Size = Tuple[Size1D, Size1D, Size1D]
Coordinate = Tuple[float, float, float]
Coordinate2D = Tuple[float, float]
Bound = Tuple[Coordinate, Coordinate]

Axis = Literal[0, 1, 2]
Axis2D = Literal[0, 1]
Shapely = Any  # we have no shapely; plane intersections use our own polygon type
PlanePosition = Literal["bottom", "middle", "top"]
ClipOperationType = Literal["union", "intersection", "difference", "symmetric_difference"]

Vertices = constrained_array(dtype=np.float64, ndim=2)

Symmetry = Literal[0, -1, 1]

# --------------------------------------------------------------------------- #
# medium / source aliases
# --------------------------------------------------------------------------- #

PoleAndResidue = Tuple[Complex, Complex]
FreqBound = Tuple[float, float]
FreqArray = constrained_array(dtype=np.float64, ndim=1)
ObsGridArray = constrained_array(dtype=np.float64, ndim=1)

Direction = Literal["+", "-"]
Polarization = Literal["Ex", "Ey", "Ez", "Hx", "Hy", "Hz"]
PolarizationBasis = Literal["linear", "circular"]

EMField = Literal["Ex", "Ey", "Ez", "Hx", "Hy", "Hz"]
FieldType = Literal["Ex", "Ey", "Ez", "Hx", "Hy", "Hz"]

GridSize = Union[pydantic.PositiveFloat, List[pydantic.PositiveFloat]]

# monitor aliases
EpsSpecType = Literal["diagonal", "tensorial_real", "tensorial_complex"]
ModeSolverType = Literal["diagonal", "tensorial"]

TrackFreq = Literal["central", "lowest", "highest"]

# plotting
Ax = Any
PlotVal = Literal["real", "imag", "abs"]
FieldVal = Literal["real", "imag", "abs", "abs^2", "phase"]
PlotScale = Literal["lin", "dB"]
ColormapType = Any

# misc
Numpy = np.ndarray
InterpMethod = Literal["nearest", "linear"]
Literal_ = Literal

# web-ish
TaskName = str
TaskId = str


def Literal1(val):  # helper to build Literal of a single runtime string
    return Literal[val]  # type: ignore[valid-type]
