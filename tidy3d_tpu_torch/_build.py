"""Builds the CUDA kernel libraries of ``csrc/`` with nvcc and loads them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/kernels/lib<name>_<hash>.so`` (beside the package, git-ignored),
where ``<hash>`` covers the source and the flags: an edited source builds
anew, an unchanged one loads the library already built. The build happens at
first use, in the process that needs it; nothing is built at import.
``load_all`` compiles several sources at once, one nvcc process each.

A *variant* of a source is the source built with preprocessor defines (the
kernels' storage types, ``-DT3D_FIELD_BF16`` and the like): it is a library
of its own, named ``label(name, defines)`` (``kstep[T3D_Q_BF16]``), whose
hash covers the defines, so that a run builds only the variants it uses.

The library is bound with ``ctypes``; the wrappers set ``argtypes`` and pass
every pointer and the stream as ``ctypes.c_void_p``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class BuildInfo:
    """How a kernel library got loaded in this process."""

    path: str
    built: bool           # compiled in this process (else loaded as built)
    seconds: float        # wall time of the (parallel) build, or the load
    ptxas: str            # nvcc's -Xptxas -v report of the build


_LIBS: dict = {}
BUILDS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of tidy3d_tpu_torch cannot be built")


def label(name: str, defines=()) -> str:
    """The name of a source's variant: ``name``, with its defines in
    brackets (``kstep[T3D_PSI_BF16,T3D_Q_BF16]``)."""
    return f"{name}[{','.join(defines)}]" if defines else name


def _spec(item):
    """``(name, defines)`` of a ``load_all`` item: a source's name, or a
    ``(name, defines)`` pair."""
    if isinstance(item, str):
        return item, ()
    name, defines = item
    return name, tuple(defines)


def _target(name: str, defines=()):
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so", flags


def load_all(items) -> dict:
    """The loaded library of each item, a source's name (``csrc/<name>.cu``)
    or a ``(name, defines)`` variant, keyed by ``label``. The libraries not
    built yet are compiled together, one nvcc process each, all started at
    once."""
    t0 = time.perf_counter()
    specs = {label(*_spec(item)): _spec(item) for item in items}
    jobs = {}
    for key, (name, defines) in specs.items():
        if key in _LIBS:
            continue
        src, so, flags = _target(name, defines)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *flags, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs[key] = (proc, src, so, tmp)
    failed = []
    for key, (proc, src, so, tmp) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {key} "
                          f"(exit {proc.returncode}):\n{err}")
            continue
        so.with_suffix(".ptxas.txt").write_text(out + err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0
    for key, (name, defines) in specs.items():
        if key in _LIBS:
            continue
        _, so, _ = _target(name, defines)
        report = so.with_suffix(".ptxas.txt")
        _LIBS[key] = ctypes.CDLL(str(so))
        BUILDS[key] = BuildInfo(
            path=str(so), built=key in jobs, seconds=seconds,
            ptxas=report.read_text() if report.exists() else "")
    return {key: _LIBS[key] for key in specs}


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``defines``,
    built first if needed."""
    return load_all([(name, defines)])[label(name, defines)]


def check_struct(lib: ctypes.CDLL, size_fn: str, struct) -> None:
    """Raises unless the library's ``sizeof`` of a parameter struct equals
    its ``ctypes`` mirror's."""
    fn = getattr(lib, size_fn)
    fn.argtypes = []
    fn.restype = ctypes.c_int
    if fn() != ctypes.sizeof(struct):
        raise RuntimeError(
            f"{struct.__name__}: {ctypes.sizeof(struct)} bytes in Python, "
            f"{fn()} in the kernel library")
