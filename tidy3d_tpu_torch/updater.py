"""Schema version migration of serialized simulations.

Behavioral model: /root/reference/tidy3d/updater.py (Updater:86 with a
registry of ``updates_from_version`` dict-to-dict upgraders). This framework
writes schema version 2.7.6-compatible files; the updater passes through
current-version dicts and hosts migration hooks for older ones.
"""

from __future__ import annotations

import functools
import json
from typing import Callable, Dict

import pydantic

from .components.base import Tidy3dBaseModel
from .exceptions import FileError, SetupError
from .log import log
from .version import SCHEMA_VERSION

UPDATE_MAP: Dict[str, Callable] = {}


def updates_from_version(version_from_string: str):
    """Register an update function mapping one schema version to the next."""

    def decorator(update_fn):
        UPDATE_MAP[version_from_string] = update_fn

        @functools.wraps(update_fn)
        def wrapper(sim_dict):
            return update_fn(sim_dict)

        return wrapper

    return decorator


class Version(Tidy3dBaseModel):
    """Parsed semantic version."""

    major: int
    minor: int

    @classmethod
    def from_string(cls, string: str = None) -> "Version":
        if string is None:
            return cls.from_string(SCHEMA_VERSION)
        try:
            major, minor, *_ = string.split(".")
            return cls(major=int(major), minor=int(minor))
        except Exception as exc:
            raise SetupError(f"version string '{string}' can't be parsed") from exc

    @property
    def as_tuple(self):
        return (self.major, self.minor)

    def __eq__(self, other):
        return self.as_tuple == other.as_tuple

    def __lt__(self, other):
        return self.as_tuple < other.as_tuple

    def __hash__(self):
        return hash(self.as_tuple)


class Updater(Tidy3dBaseModel):
    """Updates a serialized simulation dict to the current schema version."""

    sim_dict: dict = pydantic.Field(..., title="Simulation dict")

    @classmethod
    def from_file(cls, fname: str) -> "Updater":
        with open(fname, encoding="utf-8") as f:
            if fname.endswith((".yaml", ".yml")):
                import yaml

                sim_dict = yaml.safe_load(f)
            else:
                sim_dict = json.load(f)
        return cls(sim_dict=sim_dict)

    @classmethod
    def from_string(cls, sim_dict_str: str) -> "Updater":
        return cls(sim_dict=json.loads(sim_dict_str))

    @property
    def version(self) -> Version:
        version_string = self.sim_dict.get("version")
        if version_string is None:
            log.warning("Could not find a version in the supplied dict.")
            return Version.from_string(SCHEMA_VERSION)
        return Version.from_string(version_string)

    def update_to_current(self) -> dict:
        """Apply registered migrations until the current schema version."""
        sim_dict = dict(self.sim_dict)
        current = Version.from_string(SCHEMA_VERSION)
        if self.version == current:
            sim_dict["version"] = SCHEMA_VERSION
            return sim_dict
        version = self.version
        seen = set()
        while version < current:
            key = f"{version.major}.{version.minor}"
            if key in seen:
                break
            seen.add(key)
            update_fn = UPDATE_MAP.get(key)
            if update_fn is None:
                break
            sim_dict = update_fn(sim_dict)
            version = Version.from_string(sim_dict.get("version", SCHEMA_VERSION))
        sim_dict["version"] = SCHEMA_VERSION
        return sim_dict


def _iterate_update_dict(update_dict, update_types: Dict[str, Callable]):
    """Recursively apply per-``type`` fixers to every tagged sub-dict."""
    if isinstance(update_dict, dict):
        type_name = update_dict.get("type")
        if type_name in update_types:
            update_types[type_name](update_dict)
        for val in list(update_dict.values()):
            _iterate_update_dict(val, update_types)
    elif isinstance(update_dict, (list, tuple)):
        for item in update_dict:
            _iterate_update_dict(item, update_types)


def _bump(sim_dict: dict, version: str) -> dict:
    sim_dict = dict(sim_dict)
    sim_dict["version"] = version
    return sim_dict


# ---- migration chain for genuinely old reference-written files ----
# (behavioral model: the reference's chain, tidy3d/updater.py:207-345)


@updates_from_version("1.3")
def _update_1_3(sim_dict: dict) -> dict:
    """1.3 -> 1.4: per-axis pml_layers became the BoundarySpec schema."""
    sim_dict = dict(sim_dict)
    if "pml_layers" in sim_dict:
        bspec = {}
        for dim, layer in zip("xyz", sim_dict.pop("pml_layers")):
            bspec[dim] = {"plus": layer, "minus": layer}
        sim_dict["boundary_spec"] = bspec
    return _bump(sim_dict, "1.4")


@updates_from_version("1.4")
def _update_1_4(sim_dict: dict) -> dict:
    """1.4 -> 1.5: PolySlab/GeometryGroup lost derived fields; ModeSpec
    lost sort_by."""

    def fix_polyslab(d):
        d.pop("length", None)
        d.pop("center", None)

    def fix_modespec(d):
        sort_by = d.pop("sort_by", None)
        if sort_by and sort_by != "largest_neff":
            log.warning("ModeSpec.sort_by was removed; sorting by largest "
                        "effective index (use filter_pol instead).")

    def fix_group(d):
        d.pop("center", None)

    _iterate_update_dict(sim_dict, {"PolySlab": fix_polyslab,
                                    "ModeSpec": fix_modespec,
                                    "GeometryGroup": fix_group})
    return _bump(sim_dict, "1.5")


@updates_from_version("1.5")
def _update_1_5(sim_dict: dict) -> dict:
    """1.5 -> 1.6: ModeFieldMonitor renamed to ModeSolverMonitor."""

    def fix(d):
        d["type"] = "ModeSolverMonitor"

    _iterate_update_dict(sim_dict, {"ModeFieldMonitor": fix})
    return _bump(sim_dict, "1.6")


@updates_from_version("1.6")
def _update_1_6(sim_dict: dict) -> dict:
    """1.6 -> 1.7: Simulation.grid_size replaced by grid_spec."""
    sim_dict = dict(sim_dict)
    sim_dict.pop("grid_size", None)
    return _bump(sim_dict, "1.7")


@updates_from_version("1.7")
def _update_1_7(sim_dict: dict) -> dict:
    """1.7 -> 1.8: Near2Far* monitors became FieldProjection* monitors;
    BlochBoundary.bloch_vec became a plain float."""

    def fix_angle(d):
        d["type"] = "FieldProjectionAngleMonitor"
        d.pop("fields", None)
        d.pop("medium", None)
        d["proj_distance"] = 1e6

    def fix_cartesian(d):
        d["type"] = "FieldProjectionCartesianMonitor"
        d.pop("fields", None)
        d.pop("medium", None)
        d["proj_distance"] = d.pop("plane_distance", 1e6)
        if "plane_axis" in d:
            d["proj_axis"] = d.pop("plane_axis")

    def fix_kspace(d):
        d["type"] = "FieldProjectionKSpaceMonitor"
        d.pop("fields", None)
        d.pop("medium", None)
        d["proj_distance"] = 1e6
        if "u_axis" in d:
            d["proj_axis"] = d.pop("u_axis")

    def fix_diffraction(d):
        d.pop("medium", None)
        d.pop("orders_x", None)
        d.pop("orders_y", None)

    def fix_bloch(d):
        if isinstance(d.get("bloch_vec"), dict):
            d["bloch_vec"] = d["bloch_vec"]["real"]

    _iterate_update_dict(sim_dict, {
        "Near2FarAngleMonitor": fix_angle,
        "Near2FarCartesianMonitor": fix_cartesian,
        "Near2FarKSpaceMonitor": fix_kspace,
        "DiffractionMonitor": fix_diffraction,
        "BlochBoundary": fix_bloch,
    })
    return _bump(sim_dict, "1.8")


@updates_from_version("1.8")
def _update_1_8(sim_dict: dict) -> dict:
    """1.8 -> 1.9: placeholder DataArray tags got concrete names."""

    def fix(d):
        for key, val in d.get("field_dataset", {}).items():
            if val == "XR.DATAARRAY":
                d["field_dataset"][key] = "ScalarFieldDataArray"

    _iterate_update_dict(sim_dict, {"CustomFieldSource": fix})
    return _bump(sim_dict, "1.9")


@updates_from_version("1.9")
def _update_1_9(sim_dict: dict) -> dict:
    """1.9 -> 2.6: no structural changes load-relevant here."""
    return _bump(sim_dict, "2.6")


for _v in ("2.0", "2.1", "2.2", "2.3", "2.4", "2.5"):
    UPDATE_MAP[_v] = _update_1_9


@updates_from_version("2.6")
def _update_2_6(sim_dict: dict) -> dict:
    """2.6 -> 2.7: no structural changes required by this framework."""
    return _bump(sim_dict, "2.7.6")
