"""Base model for all tidy3d_tpu schema components.

Behavioral model: /root/reference/tidy3d/components/base.py (Tidy3dBaseModel:
frozen pydantic models, hashing, ``updated_copy``, JSON/HDF5(+gz) IO with
DataArray groups, auto ``type`` discriminator tags) — re-designed for
pydantic v2. Serialized layout is reference-compatible:

* JSON: a dict with a ``type`` tag per model; DataArray fields are replaced by
  their class-name tag string (data lives in HDF5 only).
* HDF5: the JSON string in a ``JSON_STRING`` dataset (chunked if large) and one
  group per DataArray at its JSON path (lists indexed by position), where each
  group holds ``__xarray_dataarray_variable__`` plus one dataset per coord
  (reference: components/data/data_array.py:248-281, base.py:565-741).
"""

from __future__ import annotations

import gzip
import json
import os
import pathlib
import shutil
import tempfile
from functools import cached_property  # noqa: F401  (re-exported)
from math import isinf, isnan
from typing import Any, Callable, Dict, List, Literal, Optional, Tuple, Union

import numpy as np
import pydantic
from pydantic._internal._model_construction import ModelMetaclass

from ..exceptions import FileError, Tidy3dKeyError
from ..log import log
from ..version import __version__

JSON_TAG = "JSON_STRING"
# maximum dataset size for a single hdf5 string dataset chunk
MAX_STRING_LENGTH = 1_000_000_000
INDENT_JSON_FILE = 4
INDENT = None

# registry of DataArray subclasses by name, populated by data_array module
DATA_ARRAY_MAP: Dict[str, type] = {}


def register_data_array(cls):
    """Register a DataArray subclass for (de)serialization dispatch."""
    DATA_ARRAY_MAP[cls.__name__] = cls
    return cls


def _is_data_array(value: Any) -> bool:
    return getattr(type(value), "_is_tidy_data_array", False)


class _Tidy3dBaseModelMeta(ModelMetaclass):
    """Metaclass injecting a ``type: Literal[<ClassName>] = <ClassName>`` field
    into every subclass, so serialized dicts carry a discriminator tag."""

    def __new__(mcs, name, bases, namespace, **kwargs):
        if bases and name != "Tidy3dBaseModel":
            ann = namespace.setdefault("__annotations__", {})
            if "type" not in ann:
                ann["type"] = Literal[name]  # type: ignore[valid-type]
                namespace["type"] = name
        return super().__new__(mcs, name, bases, namespace, **kwargs)


class Tidy3dBaseModel(pydantic.BaseModel, metaclass=_Tidy3dBaseModelMeta):
    """Base for all tidy3d_tpu schema components: frozen, hashable, serializable."""

    model_config = pydantic.ConfigDict(
        frozen=True,
        extra="allow",
        arbitrary_types_allowed=True,
        populate_by_name=True,
        validate_default=True,
    )

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)

    # ------------------------------------------------------------------ #
    # identity
    # ------------------------------------------------------------------ #

    def __hash__(self) -> int:
        try:
            return hash(self._json_string)
        except Exception:
            return hash(repr(self))

    def __eq__(self, other) -> bool:
        if other is None:
            return False
        if not isinstance(other, Tidy3dBaseModel):
            return False
        if self._json_string != other._json_string:
            return False
        mine, theirs = self._data_arrays(), other._data_arrays()
        if len(mine) != len(theirs):
            return False
        for (pa, a), (pb, b) in zip(mine, theirs):
            if pa != pb:
                return False
            if not np.array_equal(np.asarray(a.values), np.asarray(b.values)):
                return False
        return True

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({', '.join(f'{k}=...' for k in self.__pydantic_fields__)})"

    def __str__(self) -> str:
        return self._json(indent=2)

    # ------------------------------------------------------------------ #
    # copy / update
    # ------------------------------------------------------------------ #

    def copy(self, update: dict = None, deep: bool = True, validate: bool = True) -> Tidy3dBaseModel:
        """Return a (re-validated) copy of this model with optional field updates."""
        field_values = {k: getattr(self, k) for k in self.__pydantic_fields__ if k != "type"}
        if update:
            field_values.update(update)
        if validate:
            return type(self)(**field_values)
        return self.model_copy(update=update or {})

    def updated_copy(self, path: str = None, validate: bool = True, **kwargs) -> Tidy3dBaseModel:
        """Copy with fields updated; ``path='structures/0/geometry'`` targets a sub-model."""
        if path is None or path == "":
            return self.copy(update=kwargs, validate=validate)
        tokens = [t for t in path.split("/") if t]
        return self._updated_copy_path(tokens, kwargs, validate=validate)

    def _updated_copy_path(self, tokens: List[str], kwargs: dict, validate: bool = True):
        token = tokens[0]
        rest = tokens[1:]
        attr = getattr(self, token, None)
        if attr is None:
            raise Tidy3dKeyError(f"Cannot find field '{token}' in {type(self).__name__}.")
        if rest and rest[0].isdigit():
            index = int(rest[0])
            rest2 = rest[1:]
            items = list(attr)
            sub = items[index]
            if rest2:
                new_sub = sub._updated_copy_path(rest2, kwargs, validate=validate)
            else:
                new_sub = sub.copy(update=kwargs, validate=validate)
            items[index] = new_sub
            return self.copy(update={token: tuple(items)}, validate=validate)
        if rest:
            new_attr = attr._updated_copy_path(rest, kwargs, validate=validate)
        else:
            new_attr = attr.copy(update=kwargs, validate=validate)
        return self.copy(update={token: new_attr}, validate=validate)

    # ------------------------------------------------------------------ #
    # serialization: python dict / json
    # ------------------------------------------------------------------ #

    @staticmethod
    def _serialize_value(value: Any) -> Any:
        """Recursively convert a field value into JSON-compatible python objects.
        DataArrays become their class-name tag string (data lives in HDF5)."""
        ser = Tidy3dBaseModel._serialize_value
        if value is None:
            return None
        if _is_data_array(value):
            return type(value).__name__
        if isinstance(value, Tidy3dBaseModel):
            return {k: ser(getattr(value, k)) for k in value.__pydantic_fields__}
        if isinstance(value, (np.ndarray, np.generic)):
            return ser(value.tolist())
        if isinstance(value, (list, tuple)):
            return [ser(v) for v in value]
        if isinstance(value, dict):
            return {k: ser(v) for k, v in value.items()}
        if isinstance(value, complex):
            return {"real": value.real, "imag": value.imag}
        if isinstance(value, bool):
            return value
        if isinstance(value, float):
            if isnan(value):
                return None
            return value
        if isinstance(value, (int, str)):
            return value
        if isinstance(value, pathlib.PurePath):
            return str(value)
        return str(value)

    def dict_td(self) -> dict:
        """Model as a JSON-compatible dict (the serialization source of truth)."""
        return self._serialize_value(self)

    # keep the pydantic-v1-style name used widely in reference code/tests
    def dict(self) -> dict:  # type: ignore[override]
        return self.dict_td()

    def _json(self, indent=INDENT, **kwargs) -> str:
        string = json.dumps(self.dict_td(), indent=indent)
        # strict-JSON compat with reference files: Infinity tokens as strings
        string = string.replace("-Infinity", '"-Infinity"')
        string = string.replace("Infinity", '"Infinity"')
        string = string.replace('"-"Infinity""', '"-Infinity"')
        return string

    @property
    def _json_string(self) -> str:
        return self._json()

    def json(self, **kwargs) -> str:  # type: ignore[override]
        return self._json(**kwargs)

    @classmethod
    def _parse_json_string(cls, string: str) -> dict:
        string = string.replace('"-Infinity"', "-Infinity")
        string = string.replace('"Infinity"', "Infinity")
        return json.loads(string)

    @classmethod
    def parse_obj(cls, obj: dict, **kwargs) -> Tidy3dBaseModel:
        return cls.model_validate(obj, **kwargs)

    @classmethod
    def parse_raw(cls, string: str, **kwargs) -> Tidy3dBaseModel:
        return cls.model_validate(cls._parse_json_string(string))

    # ------------------------------------------------------------------ #
    # data-array discovery (for hdf5 and equality)
    # ------------------------------------------------------------------ #

    def _data_arrays(self) -> List[Tuple[str, Any]]:
        """All (json_path, DataArray) pairs inside this model, in traversal order."""
        found: List[Tuple[str, Any]] = []

        def traverse(value: Any, path: str):
            if _is_data_array(value):
                found.append((path, value))
            elif isinstance(value, Tidy3dBaseModel):
                for k in value.__pydantic_fields__:
                    traverse(getattr(value, k), f"{path}/{k}")
            elif isinstance(value, (list, tuple)):
                for ind, v in enumerate(value):
                    traverse(v, f"{path}/{ind}")
            elif isinstance(value, dict):
                for k, v in value.items():
                    traverse(v, f"{path}/{k}")

        traverse(self, "")
        return found

    # ------------------------------------------------------------------ #
    # file IO
    # ------------------------------------------------------------------ #

    @classmethod
    def from_file(cls, fname: str, group_path: str = None, **parse_obj_kwargs) -> Tidy3dBaseModel:
        """Load a model from .json, .yaml, .hdf5, or .hdf5.gz file."""
        model_dict = cls.dict_from_file(fname=fname, group_path=group_path)
        return cls.model_validate(model_dict, **parse_obj_kwargs)

    @classmethod
    def dict_from_file(cls, fname: str, group_path: str = None) -> dict:
        if ".hdf5.gz" in fname or fname.endswith(".h5.gz"):
            return cls.dict_from_hdf5_gz(fname=fname, group_path=group_path or "")
        if ".hdf5" in fname or fname.endswith(".h5"):
            return cls.dict_from_hdf5(fname=fname, group_path=group_path or "")
        if ".json" in fname:
            return cls.dict_from_json(fname=fname)
        if ".yaml" in fname or ".yml" in fname:
            return cls.dict_from_yaml(fname=fname)
        raise FileError(f"File {fname} must be .json, .yaml, .hdf5, or .hdf5.gz")

    def to_file(self, fname: str) -> None:
        """Export model to .json, .yaml, .hdf5, or .hdf5.gz file."""
        if ".hdf5.gz" in fname or fname.endswith(".h5.gz"):
            return self.to_hdf5_gz(fname=fname)
        if ".hdf5" in fname or fname.endswith(".h5"):
            return self.to_hdf5(fname=fname)
        if ".json" in fname:
            return self.to_json(fname=fname)
        if ".yaml" in fname or ".yml" in fname:
            return self.to_yaml(fname=fname)
        raise FileError(f"File {fname} must be .json, .yaml, .hdf5, or .hdf5.gz")

    # --- json ---------------------------------------------------------- #

    @classmethod
    def from_json(cls, fname: str, **parse_obj_kwargs) -> Tidy3dBaseModel:
        return cls.model_validate(cls.dict_from_json(fname), **parse_obj_kwargs)

    @classmethod
    def dict_from_json(cls, fname: str) -> dict:
        with open(fname, encoding="utf-8") as f:
            return cls._parse_json_string(f.read())

    def to_json(self, fname: str) -> None:
        json_string = self._json(indent=INDENT_JSON_FILE)
        self._warn_if_contains_data(json_string)
        with open(fname, "w", encoding="utf-8") as f:
            f.write(json_string)

    @staticmethod
    def _warn_if_contains_data(json_str: str) -> None:
        if any(f'"{tag}"' in json_str for tag in DATA_ARRAY_MAP):
            log.warning(
                "Data contents are not stored in .json or .yaml files; "
                "use the .hdf5 format to save data.",
                log_once=True,
            )

    # --- yaml ---------------------------------------------------------- #

    @classmethod
    def from_yaml(cls, fname: str, **parse_obj_kwargs) -> Tidy3dBaseModel:
        return cls.model_validate(cls.dict_from_yaml(fname), **parse_obj_kwargs)

    @classmethod
    def dict_from_yaml(cls, fname: str) -> dict:
        import yaml

        with open(fname, encoding="utf-8") as f:
            return yaml.safe_load(f)

    def to_yaml(self, fname: str) -> None:
        import yaml

        json_string = self._json()
        self._warn_if_contains_data(json_string)
        model_dict = self._parse_json_string(json_string)
        with open(fname, "w", encoding="utf-8") as f:
            yaml.dump(model_dict, f, indent=INDENT_JSON_FILE)

    # --- hdf5 ---------------------------------------------------------- #

    @staticmethod
    def _json_string_key(index: int) -> str:
        return f"{JSON_TAG}_{index}" if index else JSON_TAG

    @classmethod
    def _json_string_from_hdf5(cls, fname: str) -> str:
        import h5py  # deferred: only file I/O needs it

        with h5py.File(fname, "r") as f:
            num_parts = len([key for key in f.keys() if JSON_TAG in key])
            json_string = b""
            for ind in range(num_parts):
                json_string += f[cls._json_string_key(ind)][()]
        return json_string.decode("utf-8")

    @classmethod
    def tuple_to_dict(cls, tuple_values: tuple) -> dict:
        return {str(i): v for i, v in enumerate(tuple_values)}

    @classmethod
    def get_sub_model(cls, group_path: str, model_dict: Union[dict, list]) -> dict:
        """Index into a model dict by a 'a/0/b'-style group path."""
        for key in [k for k in group_path.split("/") if k]:
            if isinstance(model_dict, list):
                model_dict = model_dict[int(key)]
            else:
                model_dict = model_dict[key]
        return model_dict

    @classmethod
    def dict_from_hdf5(cls, fname: str, group_path: str = "",
                       custom_decoders: List[Callable] = None) -> dict:
        """Load model dict from hdf5, replacing DataArray tags with loaded arrays."""

        def is_data_array_tag(value: Any) -> bool:
            return isinstance(value, str) and value in DATA_ARRAY_MAP

        def load_data(model_dict: dict, group_path: str = "") -> None:
            for key, value in model_dict.items():
                subpath = f"{group_path}/{key}"
                if custom_decoders:
                    for dec in custom_decoders:
                        dec(fname=fname, group_path=subpath, model_dict=model_dict,
                            key=key, value=value)
                if is_data_array_tag(value):
                    model_dict[key] = DATA_ARRAY_MAP[value].from_hdf5(
                        fname=fname, group_path=subpath)
                    continue
                if isinstance(value, (list, tuple)):
                    value_dict = cls.tuple_to_dict(tuple(value))
                    load_data(model_dict=value_dict, group_path=subpath)
                    for ind, item in enumerate(value_dict.values()):
                        model_dict[key] = list(model_dict[key])
                        if is_data_array_tag(model_dict[key][ind]):
                            model_dict[key][ind] = item
                elif isinstance(value, dict):
                    load_data(model_dict=value, group_path=subpath)

        model_dict = cls._parse_json_string(cls._json_string_from_hdf5(fname=fname))
        model_dict = cls.get_sub_model(group_path=group_path, model_dict=model_dict)
        if isinstance(model_dict, dict):
            load_data(model_dict=model_dict, group_path=group_path)
        return model_dict

    @classmethod
    def from_hdf5(cls, fname: str, group_path: str = "", **parse_obj_kwargs) -> Tidy3dBaseModel:
        return cls.model_validate(
            cls.dict_from_hdf5(fname=fname, group_path=group_path), **parse_obj_kwargs
        )

    def to_hdf5(self, fname: Union[str, h5py.File]) -> None:
        """Write model to hdf5: JSON string + one group per DataArray."""
        import h5py  # deferred: only file I/O needs it

        def write(f_handle: h5py.File) -> None:
            json_str = self._json_string
            for ind in range(0, len(json_str), MAX_STRING_LENGTH):
                f_handle[self._json_string_key(ind // MAX_STRING_LENGTH)] = json_str[
                    ind: ind + MAX_STRING_LENGTH
                ]
            for path, data_array in self._data_arrays():
                data_array.to_hdf5_handle(f_handle=f_handle, group_path=path)

        if isinstance(fname, str):
            with h5py.File(fname, "w") as f_handle:
                write(f_handle)
        else:
            write(fname)

    # --- hdf5.gz ------------------------------------------------------- #

    def to_hdf5_gz(self, fname: str) -> None:
        with tempfile.NamedTemporaryFile(suffix=".hdf5", delete=False) as tmp:
            tmp_name = tmp.name
        try:
            self.to_hdf5(tmp_name)
            with open(tmp_name, "rb") as fin, gzip.open(fname, "wb") as fout:
                shutil.copyfileobj(fin, fout)
        finally:
            os.unlink(tmp_name)

    @classmethod
    def dict_from_hdf5_gz(cls, fname: str, group_path: str = "",
                          custom_decoders: List[Callable] = None) -> dict:
        with tempfile.NamedTemporaryFile(suffix=".hdf5", delete=False) as tmp:
            tmp_name = tmp.name
        try:
            with gzip.open(fname, "rb") as fin, open(tmp_name, "wb") as fout:
                shutil.copyfileobj(fin, fout)
            return cls.dict_from_hdf5(tmp_name, group_path=group_path,
                                      custom_decoders=custom_decoders)
        finally:
            os.unlink(tmp_name)

    @classmethod
    def from_hdf5_gz(cls, fname: str, group_path: str = "", **parse_obj_kwargs):
        return cls.model_validate(
            cls.dict_from_hdf5_gz(fname=fname, group_path=group_path), **parse_obj_kwargs
        )

    # ------------------------------------------------------------------ #
    # misc
    # ------------------------------------------------------------------ #

    def help(self, methods: bool = False) -> None:
        import rich

        rich.inspect(self, methods=methods)

    @classmethod
    def add_type_field(cls):  # compat no-op (metaclass already injects `type`)
        return cls

    def get_submodels_by_hash(self) -> Dict[int, List[str]]:
        """Map of hash -> field paths, used for deduplication in upload layers."""
        out: Dict[int, List[str]] = {}
        for key in self.__pydantic_fields__:
            field = getattr(self, key)
            if isinstance(field, Tidy3dBaseModel):
                out.setdefault(hash(field), []).append(key)
            elif isinstance(field, (list, tuple)):
                for ind, sub in enumerate(field):
                    if isinstance(sub, Tidy3dBaseModel):
                        out.setdefault(hash(sub), []).append(f"{key}/{ind}")
        return out


def skip_if_fields_missing(fields: List[str], root: bool = False):
    """Decorator for pydantic-v1-style validators: no-op shim for v2 port."""

    def decorator(validator):
        return validator

    return decorator
