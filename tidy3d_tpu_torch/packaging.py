"""Optional-dependency gating (reference: tidy3d/packaging.py, 152 LoC).

The TPU build keeps heavy optional imports (matplotlib for plotting, torch
for the autograd bridge) out of the import path and raises actionable errors
at point-of-use. Unlike the reference we need no vtk/trimesh/gdstk gates —
the unstructured datasets, STL mesh handling, and GDSII IO are implemented
natively (numpy + the C++ geometry kernels)."""

from __future__ import annotations

import functools
import importlib
from typing import Callable

from .exceptions import Tidy3dImportError

_IMPORT_CACHE: dict = {}


def check_import(module_name: str) -> bool:
    """True if `module_name` is importable (result cached)."""
    if module_name in _IMPORT_CACHE:
        return _IMPORT_CACHE[module_name]
    try:
        importlib.import_module(module_name)
        ok = True
    except ImportError:
        ok = False
    _IMPORT_CACHE[module_name] = ok
    return ok


def requires_package(module_name: str, extra_hint: str = "") -> Callable:
    """Decorator: raise a clear Tidy3dImportError when the wrapped feature is
    used without its optional dependency installed."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not check_import(module_name):
                raise Tidy3dImportError(
                    f"'{fn.__name__}' requires the optional package "
                    f"'{module_name}', which is not installed. {extra_hint}")
            return fn(*args, **kwargs)

        return wrapper

    return decorator


def verify_packages_import(module_names: list, required: str = "any") -> str:
    """Check that the listed optional packages import; returns the first
    importable name. required='any' needs one, 'all' needs every one."""
    available = [m for m in module_names if check_import(m)]
    if required == "all" and len(available) != len(module_names):
        missing = sorted(set(module_names) - set(available))
        raise Tidy3dImportError(
            f"Missing required optional packages: {', '.join(missing)}")
    if not available:
        raise Tidy3dImportError(
            "None of the optional packages "
            f"{', '.join(module_names)} are installed.")
    return available[0]
