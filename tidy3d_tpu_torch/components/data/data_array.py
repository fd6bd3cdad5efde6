"""Labeled N-D arrays with fixed dimension names.

The reference builds on ``xarray.DataArray`` (/root/reference/tidy3d/components/
data/data_array.py:65-1208). xarray is not available in this environment, and a
heavyweight host-side dependency is undesirable for a TPU-native framework, so
this module implements a small, fast, numpy-backed labeled array with the
subset of the xarray API the framework uses (``sel``/``isel``/``interp``/
arithmetic/reductions), plus reference-compatible HDF5 (de)serialization
(group = ``__xarray_dataarray_variable__`` dataset + one dataset per coord).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ...exceptions import DataError
from ..base import register_data_array

DATA_ARRAY_VALUE_NAME = "__xarray_dataarray_variable__"


class DataArray:
    """A numpy array with named dimensions and 1D coordinate arrays."""

    _is_tidy_data_array = True
    # fixed, ordered dimension names for concrete subclasses; () = free-form
    _dims: Tuple[str, ...] = ()
    # metadata attrs (units etc.)
    _data_attrs: Dict[str, str] = {}

    __slots__ = ("values", "coords", "dims", "attrs", "name")

    def __init__(self, data: Any = None, coords: Dict[str, Any] = None,
                 dims: Tuple[str, ...] = None, name: str = None, attrs: dict = None):
        if isinstance(data, DataArray):
            coords = coords or data.coords
            dims = dims or data.dims
            data = data.values

        if dims is None:
            dims = self._dims if self._dims else tuple(coords.keys())
        dims = tuple(dims)

        if coords is None:
            raise DataError(f"{type(self).__name__} requires coords.")

        # allow coords given in any order; reorder axes into class dims
        coords = {k: _as_coord_array(v) for k, v in coords.items()}
        if self._dims and set(dims) != set(self._dims):
            raise DataError(
                f"wrong dims for {type(self).__name__}: expected {self._dims}, got {dims}"
            )
        values = np.asarray(data)
        if values.ndim != len(dims):
            # allow scalar broadcast
            if values.ndim == 0:
                values = np.broadcast_to(values, tuple(len(coords[d]) for d in dims)).copy()
            else:
                raise DataError(
                    f"data ndim {values.ndim} does not match dims {dims} "
                    f"for {type(self).__name__}"
                )
        if self._dims and dims != tuple(self._dims):
            # transpose into canonical order
            perm = [dims.index(d) for d in self._dims]
            values = np.transpose(values, perm)
            dims = tuple(self._dims)

        shape_expected = tuple(len(coords[d]) for d in dims)
        if values.shape != shape_expected:
            raise DataError(
                f"data shape {values.shape} does not match coords shape {shape_expected} "
                f"(dims {dims}) for {type(self).__name__}"
            )

        object.__setattr__(self, "values", values)
        object.__setattr__(self, "coords", {d: coords[d] for d in dims})
        object.__setattr__(self, "dims", dims)
        object.__setattr__(self, "attrs", dict(self._data_attrs) if attrs is None else dict(attrs))
        object.__setattr__(self, "name", name)

    def __setattr__(self, key, value):
        # mimic pydantic-frozen style: values array itself stays mutable,
        # but rebinding attributes is blocked except via object.__setattr__
        if key in self.__slots__:
            object.__setattr__(self, key, value)
        else:
            raise AttributeError(f"cannot set attribute {key} on DataArray")

    # ------------------------------------------------------------------ #
    # basic protocol
    # ------------------------------------------------------------------ #

    @property
    def data(self) -> np.ndarray:
        return self.values

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.values.shape

    @property
    def size(self) -> int:
        return int(self.values.size)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def ndim(self) -> int:
        return self.values.ndim

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self.values)
        return arr.astype(dtype) if dtype is not None else arr

    def item(self):
        return self.values.item()

    def __len__(self):
        return len(self.values)

    def __repr__(self):
        coord_str = ", ".join(f"{k}: {len(v)}" for k, v in self.coords.items())
        return f"<{type(self).__name__} ({coord_str})>\n{self.values!r}"

    def __hash__(self):
        return hash((type(self).__name__, self.values.tobytes(),
                     tuple((k, v.tobytes() if isinstance(v, np.ndarray) else tuple(v))
                           for k, v in self.coords.items())))

    def __eq__(self, other):
        if isinstance(other, DataArray):
            return (
                self.dims == other.dims
                and all(np.array_equal(self.coords[d], other.coords[d]) for d in self.dims)
                and np.array_equal(self.values, other.values)
            )
        return self.values == other  # elementwise vs scalar/array

    # ------------------------------------------------------------------ #
    # construction helpers
    # ------------------------------------------------------------------ #

    def _with_values(self, values: np.ndarray, coords: dict = None, cls=None) -> DataArray:
        cls = cls or type(self)
        coords = coords if coords is not None else self.coords
        if cls._dims and tuple(coords.keys()) != tuple(cls._dims):
            cls = DataArray
        if cls is DataArray:
            out = DataArray(values, coords=coords, dims=tuple(coords.keys()))
        else:
            out = cls(values, coords=coords)
        return out

    def copy(self, deep: bool = True) -> DataArray:
        return self._with_values(self.values.copy() if deep else self.values)

    def rename(self, name: str = None, **dims_map) -> DataArray:
        if dims_map:
            new_dims = tuple(dims_map.get(d, d) for d in self.dims)
            new_coords = {dims_map.get(d, d): v for d, v in self.coords.items()}
            out = DataArray(self.values, coords=new_coords, dims=new_dims)
            return out
        out = self.copy(deep=False)
        object.__setattr__(out, "name", name)
        return out

    def assign_coords(self, coords: dict = None, **kwargs) -> DataArray:
        updates = dict(coords or {})
        updates.update(kwargs)
        new_coords = dict(self.coords)
        for k, v in updates.items():
            new_coords[k] = _as_coord_array(v)
        return self._with_values(self.values, coords=new_coords)

    def expand_dims(self, dim: Union[str, dict] = None, axis: int = 0, **kwargs) -> DataArray:
        if isinstance(dim, dict):
            updates = dim
        else:
            updates = kwargs if dim is None else {dim: kwargs.get(dim, [0])}
        values = self.values
        coords = dict(self.coords)
        dims = list(self.dims)
        for name, coord in updates.items():
            coord = _as_coord_array(coord)
            values = np.expand_dims(values, axis)
            values = np.broadcast_to(
                values, values.shape[:axis] + (len(coord),) + values.shape[axis + 1:]
            ).copy()
            dims.insert(axis, name)
            coords[name] = coord
        return DataArray(values, coords={d: coords[d] for d in dims}, dims=tuple(dims))

    def transpose(self, *dims) -> DataArray:
        if not dims:
            dims = tuple(reversed(self.dims))
        perm = [self.dims.index(d) for d in dims]
        values = np.transpose(self.values, perm)
        coords = {d: self.coords[d] for d in dims}
        return DataArray(values, coords=coords, dims=dims)

    # ------------------------------------------------------------------ #
    # selection / interpolation
    # ------------------------------------------------------------------ #

    def get_axis_num(self, dim: str) -> int:
        return self.dims.index(dim)

    def isel(self, indexers: dict = None, drop: bool = False, **kwargs) -> DataArray:
        sel = dict(indexers or {})
        sel.update(kwargs)
        values = self.values
        coords = dict(self.coords)
        dims = list(self.dims)
        for dim, idx in sel.items():
            axis = dims.index(dim)
            if isinstance(idx, (int, np.integer)):
                values = np.take(values, int(idx), axis=axis)
                dims.pop(axis)
                coords.pop(dim)
            else:
                idx = np.asarray(idx)
                values = np.take(values, idx, axis=axis)
                coords[dim] = np.asarray(coords[dim])[idx]
        if dims == list(self.dims):
            return self._with_values(values, coords=coords)
        return DataArray(values, coords={d: coords[d] for d in dims}, dims=tuple(dims))

    def sel(self, indexers: dict = None, method: str = None, drop: bool = False, **kwargs):
        sel = dict(indexers or {})
        sel.update(kwargs)
        isel_kwargs = {}
        for dim, val in sel.items():
            coord = np.asarray(self.coords[dim])
            scalar = np.ndim(val) == 0
            vals = np.atleast_1d(val)
            if np.issubdtype(coord.dtype, np.number):
                inds = []
                for v in vals:
                    if method == "nearest":
                        inds.append(int(np.argmin(np.abs(coord - v))))
                    else:
                        matches = np.nonzero(np.isclose(coord, v, rtol=1e-12, atol=0.0))[0]
                        if len(matches) == 0:
                            # exact float equality fallback with tolerance
                            matches = np.nonzero(np.isclose(coord, v))[0]
                        if len(matches) == 0:
                            raise KeyError(f"value {v} not found in coordinate '{dim}'")
                        inds.append(int(matches[0]))
            else:
                clist = coord.tolist()
                inds = [clist.index(v) for v in vals]
            isel_kwargs[dim] = inds[0] if scalar else np.asarray(inds)
        return self.isel(**isel_kwargs)

    def interp(self, coords: dict = None, method: str = "linear",
               kwargs: dict = None, assume_sorted: bool = False, **coords_kwargs) -> DataArray:
        """Linear interpolation onto new coordinates, one named axis at a time."""
        targets = dict(coords or {})
        targets.update(coords_kwargs)
        fill_value = (kwargs or {}).get("fill_value", None)
        values = self.values
        new_coords = dict(self.coords)
        dims = list(self.dims)
        for dim, tgt in targets.items():
            axis = dims.index(dim)
            old = np.asarray(self.coords[dim], dtype=float)
            scalar = np.ndim(tgt) == 0
            new = np.atleast_1d(np.asarray(tgt, dtype=float))
            if method == "nearest" or len(old) == 1:
                idx = np.clip(np.searchsorted(old, new), 0, len(old) - 1)
                idx_lo = np.clip(idx - 1, 0, len(old) - 1)
                use_lo = np.abs(old[idx_lo] - new) < np.abs(old[idx] - new)
                idx = np.where(use_lo, idx_lo, idx)
                values = np.take(values, idx, axis=axis)
            else:
                values = _interp_axis(values, old, new, axis, fill_value=fill_value)
            new_coords[dim] = new
            if scalar:
                values = np.take(values, 0, axis=axis)
                dims.pop(axis)
                new_coords.pop(dim)
        if dims == list(self.dims):
            return self._with_values(values, coords=new_coords)
        return DataArray(values, coords={d: new_coords[d] for d in dims}, dims=tuple(dims))

    def interp_like(self, other: DataArray, **kwargs) -> DataArray:
        targets = {d: other.coords[d] for d in self.dims if d in other.coords}
        return self.interp(coords=targets, **kwargs)

    def sel_inside(self, bounds) -> DataArray:
        """Select the part of the array inside spatial bounds (x/y/z dims only)."""
        isel_kwargs = {}
        for axis, dim in enumerate("xyz"):
            if dim not in self.dims:
                continue
            coord = np.asarray(self.coords[dim])
            lo, hi = bounds[0][axis], bounds[1][axis]
            mask = (coord >= lo) & (coord <= hi)
            # keep one point on either side for interpolation fidelity
            idx = np.nonzero(mask)[0]
            if len(idx) == 0:
                idx = np.array([int(np.argmin(np.abs(coord - 0.5 * (lo + hi))))])
            start = max(int(idx[0]) - 1, 0)
            stop = min(int(idx[-1]) + 2, len(coord))
            isel_kwargs[dim] = np.arange(start, stop)
        return self.isel(**isel_kwargs)

    def does_cover(self, bounds) -> bool:
        for axis, dim in enumerate("xyz"):
            if dim not in self.dims:
                continue
            coord = np.asarray(self.coords[dim])
            if len(coord) == 1:
                continue
            if coord.min() > bounds[0][axis] or coord.max() < bounds[1][axis]:
                return False
        return True

    # ------------------------------------------------------------------ #
    # math
    # ------------------------------------------------------------------ #

    def _binary_op(self, other, op):
        if isinstance(other, DataArray):
            a, b, coords, dims = _broadcast_arrays(self, other)
            values = op(a, b)
            return DataArray(values, coords=coords, dims=dims)
        values = op(self.values, other)
        return self._maybe_same_cls(values)

    def _maybe_same_cls(self, values):
        try:
            return self._with_values(values)
        except Exception:
            return DataArray(values, coords=self.coords, dims=self.dims)

    def __add__(self, other):
        return self._binary_op(other, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary_op(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._binary_op(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._binary_op(other, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary_op(other, lambda a, b: a / b)

    def __rtruediv__(self, other):
        return self._binary_op(other, lambda a, b: b / a)

    def __pow__(self, exponent):
        return self._maybe_same_cls(self.values**exponent)

    def __neg__(self):
        return self._maybe_same_cls(-self.values)

    def __abs__(self):
        return self._maybe_same_cls(np.abs(self.values))

    def __getitem__(self, item):
        return self.values[item]

    @property
    def real(self):
        return self._maybe_same_cls(np.real(self.values))

    @property
    def imag(self):
        return self._maybe_same_cls(np.imag(self.values))

    def conj(self):
        return self._maybe_same_cls(np.conj(self.values))

    @property
    def abs(self):
        return abs(self)

    def _reduce(self, fn, dim=None, **kwargs):
        if dim is None:
            return fn(self.values)
        dims = [dim] if isinstance(dim, str) else list(dim)
        axes = tuple(self.dims.index(d) for d in dims)
        values = fn(self.values, axis=axes)
        new_dims = tuple(d for d in self.dims if d not in dims)
        coords = {d: self.coords[d] for d in new_dims}
        if not new_dims:
            return values
        return DataArray(values, coords=coords, dims=new_dims)

    def sum(self, dim=None, **kwargs):
        return self._reduce(np.sum, dim)

    def mean(self, dim=None, **kwargs):
        return self._reduce(np.mean, dim)

    def max(self, dim=None, **kwargs):
        return self._reduce(np.max, dim)

    def min(self, dim=None, **kwargs):
        return self._reduce(np.min, dim)

    def squeeze(self, dim=None, drop=True):
        if dim is None:
            sel = {d: 0 for d in self.dims if len(self.coords[d]) == 1}
        else:
            sel = {dim: 0}
        return self.isel(**sel) if sel else self

    def integrate(self, coord: Union[str, Tuple[str, ...]]):
        """Trapezoidal integration along named coordinate(s)."""
        dims = [coord] if isinstance(coord, str) else list(coord)
        out = self
        for dim in dims:
            axis = out.dims.index(dim)
            x = np.asarray(out.coords[dim], dtype=float)
            values = np.trapezoid(out.values, x=x, axis=axis)
            new_dims = tuple(d for d in out.dims if d != dim)
            coords = {d: out.coords[d] for d in new_dims}
            if not new_dims:
                return values
            out = DataArray(values, coords=coords, dims=new_dims)
        return out

    def dot(self, other: DataArray, dims=None):
        a, b, coords, all_dims = _broadcast_arrays(self, other)
        values = a * b
        if dims is None:
            return np.sum(values)
        red = [dims] if isinstance(dims, str) else list(dims)
        axes = tuple(all_dims.index(d) for d in red)
        values = np.sum(values, axis=axes)
        new_dims = tuple(d for d in all_dims if d not in red)
        return DataArray(values, coords={d: coords[d] for d in new_dims}, dims=new_dims)

    def multiply_at(self, value: complex, coord_name: str, indices: List[int]) -> DataArray:
        """Multiply self by value at selected indices along a coordinate."""
        values = self.values.copy()
        if np.iscomplexobj(np.asarray(value)) and not np.iscomplexobj(values):
            values = values.astype(np.complex128)
        axis = self.dims.index(coord_name)
        idx = [slice(None)] * values.ndim
        idx[axis] = np.asarray(indices)
        values[tuple(idx)] = values[tuple(idx)] * value
        return self._maybe_same_cls(values)

    # ------------------------------------------------------------------ #
    # hdf5 IO (layout-compatible with the reference)
    # ------------------------------------------------------------------ #

    def to_hdf5(self, fname: Union[str, h5py.File], group_path: str) -> None:
        if isinstance(fname, str):
            import h5py  # deferred: only file I/O needs it

            with h5py.File(fname, "w") as f_handle:
                self.to_hdf5_handle(f_handle=f_handle, group_path=group_path)
        else:
            self.to_hdf5_handle(f_handle=fname, group_path=group_path)

    def to_hdf5_handle(self, f_handle: h5py.File, group_path: str) -> None:
        sub_group = f_handle.create_group(group_path)
        sub_group[DATA_ARRAY_VALUE_NAME] = self.values
        for key, val in self.coords.items():
            val = np.asarray(val)
            if val.dtype.kind in ("U", "S", "O"):
                sub_group[key] = [str(v) for v in val.tolist()]
            else:
                sub_group[key] = val

    @classmethod
    def from_hdf5(cls, fname: Union[str, h5py.File], group_path: str) -> DataArray:
        def load(f):
            sub_group = f[group_path]
            values = np.array(sub_group[DATA_ARRAY_VALUE_NAME])
            dims = cls._dims if cls._dims else tuple(
                k for k in sub_group.keys() if k != DATA_ARRAY_VALUE_NAME
            )
            coords = {dim: np.array(sub_group[dim]) for dim in dims if dim in sub_group}
            for key, val in coords.items():
                if val.dtype == object or val.dtype.kind == "S":
                    coords[key] = np.array([
                        v.decode() if isinstance(v, bytes) else str(v) for v in val.tolist()
                    ])
            # dims with default integer-range coords carry no coord dataset in
            # reference-written files (xarray omits coordless dims,
            # reference data_array.py:260-269); synthesize the range
            for i, dim in enumerate(dims):
                if dim not in coords and i < values.ndim:
                    coords[dim] = np.arange(values.shape[i])
            return cls(values, coords=coords, dims=dims)

        if isinstance(fname, str):
            import h5py  # deferred: only file I/O needs it

            with h5py.File(fname, "r") as f:
                return load(f)
        return load(fname)

    @classmethod
    def from_file(cls, fname: str, group_path: str) -> DataArray:
        if ".hdf5" not in fname and ".h5" not in fname:
            raise DataError(
                f"DataArray objects must be written to '.hdf5' format, given {fname}."
            )
        return cls.from_hdf5(fname=fname, group_path=group_path)


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #


def _as_coord_array(v) -> np.ndarray:
    arr = np.asarray(v)
    if arr.ndim == 0:
        arr = arr.reshape(1)
    return arr


def _interp_axis(values: np.ndarray, old: np.ndarray, new: np.ndarray, axis: int,
                 fill_value=None) -> np.ndarray:
    """Vectorized linear interpolation of `values` along `axis` from coords
    `old` to `new` (both 1D, old sorted ascending)."""
    old = np.asarray(old, dtype=float)
    n = len(old)
    if n == 1:
        reps = [1] * values.ndim
        reps[axis] = len(new)
        return np.repeat(np.take(values, [0], axis=axis), len(new), axis=axis)
    idx_hi = np.clip(np.searchsorted(old, new, side="left"), 1, n - 1)
    idx_lo = idx_hi - 1
    x_lo, x_hi = old[idx_lo], old[idx_hi]
    w_hi = (new - x_lo) / (x_hi - x_lo)
    w_hi = np.asarray(w_hi)
    if fill_value == "extrapolate":
        pass
    else:
        w_hi = np.clip(w_hi, 0.0, 1.0)
    lo_vals = np.take(values, idx_lo, axis=axis)
    hi_vals = np.take(values, idx_hi, axis=axis)
    shape = [1] * values.ndim
    shape[axis] = len(new)
    w = w_hi.reshape(shape)
    out = lo_vals * (1 - w) + hi_vals * w
    if fill_value is not None and fill_value != "extrapolate":
        mask = ((new < old[0]) | (new > old[-1])).reshape(shape)
        out = np.where(mask, fill_value, out)
    return out


def _broadcast_arrays(a: DataArray, b: DataArray):
    """Align two DataArrays by dimension names (xarray-style outer broadcast,
    assuming shared dims have identical coords)."""
    all_dims = list(a.dims) + [d for d in b.dims if d not in a.dims]
    coords = {}
    for d in all_dims:
        coords[d] = a.coords[d] if d in a.coords else b.coords[d]

    def expand(arr: DataArray):
        values = arr.values
        # add missing dims at the end then transpose into all_dims order
        missing = [d for d in all_dims if d not in arr.dims]
        for _ in missing:
            values = values[..., None]
        cur_dims = list(arr.dims) + missing
        perm = [cur_dims.index(d) for d in all_dims]
        return np.transpose(values, perm)

    return expand(a), expand(b), coords, tuple(all_dims)


# --------------------------------------------------------------------------- #
# the typed zoo (reference: data_array.py:526-1208)
# --------------------------------------------------------------------------- #


@register_data_array
class FreqDataArray(DataArray):
    """Frequency-domain scalar."""

    _dims = ("f",)


@register_data_array
class TimeDataArray(DataArray):
    """Time-domain scalar."""

    _dims = ("t",)


@register_data_array
class FreqModeDataArray(DataArray):
    _dims = ("f", "mode_index")


@register_data_array
class SpatialDataArray(DataArray):
    """Spatially-varying scalar (custom media, permittivity maps)."""

    _dims = ("x", "y", "z")

    def reflect(self, axis: int, center: float, reflection_only: bool = False) -> SpatialDataArray:
        """Reflect data across plane at `center` along axis."""
        dim = "xyz"[axis]
        coord = np.asarray(self.coords[dim], dtype=float)
        refl_coord = 2 * center - coord[::-1]
        ax = self.dims.index(dim)
        refl_vals = np.flip(self.values, axis=ax)
        if reflection_only:
            return SpatialDataArray(refl_vals, coords={**self.coords, dim: refl_coord})
        new_coord = np.concatenate([refl_coord[:-1] if np.isclose(refl_coord[-1], coord[0]) else refl_coord, coord])
        take_n = len(new_coord) - len(coord)
        new_vals = np.concatenate([refl_vals[(slice(None),) * ax + (slice(0, take_n),)], self.values], axis=ax)
        return SpatialDataArray(new_vals, coords={**self.coords, dim: new_coord})


@register_data_array
class ScalarFieldDataArray(DataArray):
    """E/H field component in frequency domain on spatial grid."""

    _dims = ("x", "y", "z", "f")
    _data_attrs = {"long_name": "field value"}


@register_data_array
class ScalarFieldTimeDataArray(DataArray):
    _dims = ("x", "y", "z", "t")
    _data_attrs = {"long_name": "field value"}


@register_data_array
class ScalarModeFieldDataArray(DataArray):
    _dims = ("x", "y", "z", "f", "mode_index")
    _data_attrs = {"long_name": "field value"}


@register_data_array
class FluxDataArray(DataArray):
    _dims = ("f",)
    _data_attrs = {"units": "W", "long_name": "flux"}


@register_data_array
class FluxTimeDataArray(DataArray):
    _dims = ("t",)
    _data_attrs = {"units": "W", "long_name": "flux"}


@register_data_array
class ModeAmpsDataArray(DataArray):
    _dims = ("direction", "f", "mode_index")
    _data_attrs = {"units": "sqrt(W)", "long_name": "mode amplitudes"}


@register_data_array
class ModeIndexDataArray(DataArray):
    _dims = ("f", "mode_index")
    _data_attrs = {"long_name": "Propagation index"}


@register_data_array
class GroupIndexDataArray(DataArray):
    _dims = ("f", "mode_index")
    _data_attrs = {"long_name": "Group index"}


@register_data_array
class ModeDispersionDataArray(DataArray):
    _dims = ("f", "mode_index")
    _data_attrs = {"long_name": "Dispersion parameter", "units": "ps/(nm km)"}


@register_data_array
class DiffractionDataArray(DataArray):
    _dims = ("orders_x", "orders_y", "f", "polarization")
    _data_attrs = {"units": "sqrt(W)", "long_name": "diffraction amplitude"}


@register_data_array
class FieldProjectionAngleDataArray(DataArray):
    _dims = ("r", "theta", "phi", "f")
    _data_attrs = {"long_name": "projected field"}


@register_data_array
class FieldProjectionCartesianDataArray(DataArray):
    _dims = ("x", "y", "z", "f")
    _data_attrs = {"long_name": "projected field"}


@register_data_array
class FieldProjectionKSpaceDataArray(DataArray):
    _dims = ("ux", "uy", "r", "f")
    _data_attrs = {"long_name": "projected field"}


@register_data_array
class HeatDataArray(DataArray):
    _dims = ("T",)


@register_data_array
class ChargeDataArray(DataArray):
    _dims = ("n", "p")


@register_data_array
class PointDataArray(DataArray):
    """Point coordinates of an unstructured grid: (index, axis)."""

    _dims = ("index", "axis")


@register_data_array
class CellDataArray(DataArray):
    """Cell connectivity of an unstructured grid."""

    _dims = ("cell_index", "vertex_index")


@register_data_array
class TriangleMeshDataArray(DataArray):
    """Surface-mesh triangles as in the STL format (reference
    data_array.py:999: dims (face_index, vertex_index, axis))."""

    _dims = ("face_index", "vertex_index", "axis")


@register_data_array
class IndexedDataArray(DataArray):
    """Values at indexed points of an unstructured grid."""

    _dims = ("index",)


@register_data_array
class EMEScalarFieldDataArray(DataArray):
    _dims = ("x", "y", "z", "f", "sweep_index", "eme_port_index", "mode_index")


@register_data_array
class EMEScalarModeFieldDataArray(DataArray):
    """Per-cell EME expansion mode fields (reference data_array.py:1037)."""

    _dims = ("x", "y", "z", "f", "sweep_index", "eme_cell_index",
             "mode_index")


@register_data_array
class EMESMatrixDataArray(DataArray):
    _dims = ("f", "sweep_index", "mode_index_out", "mode_index_in")


@register_data_array
class EMECoefficientDataArray(DataArray):
    _dims = ("f", "sweep_index", "eme_cell_index", "mode_index_out", "mode_index_in")


@register_data_array
class EMEModeIndexDataArray(DataArray):
    _dims = ("f", "sweep_index", "eme_cell_index", "mode_index")


# convenience: map of dims tuple -> class for generic construction
DIMS_TO_DATA_ARRAY = {
    cls._dims: cls
    for cls in [
        FreqDataArray, TimeDataArray, FreqModeDataArray, SpatialDataArray,
        ScalarFieldDataArray, ScalarFieldTimeDataArray, ScalarModeFieldDataArray,
        FluxDataArray, FluxTimeDataArray, ModeAmpsDataArray, ModeIndexDataArray,
        GroupIndexDataArray, ModeDispersionDataArray, DiffractionDataArray,
        FieldProjectionAngleDataArray, FieldProjectionCartesianDataArray,
        FieldProjectionKSpaceDataArray, HeatDataArray, ChargeDataArray,
        PointDataArray, CellDataArray, IndexedDataArray,
    ]
}
