"""Builds the CUDA kernel libraries of ``csrc/`` with nvcc and loads them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/kernels/lib<name>_<hash>.so`` (beside the package, git-ignored),
where ``<hash>`` covers the source and the flags: an edited source builds
anew, an unchanged one loads the library already built. The build happens at
first use, in the process that needs it; nothing is built at import.
``load_all`` compiles several sources at once, one nvcc process each.

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


def _target(name: str):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def load_all(names) -> dict:
    """The loaded libraries of ``csrc/<name>.cu`` for each name, keyed by
    name. The libraries not built yet are compiled together, one nvcc
    process per source, all started at once."""
    t0 = time.perf_counter()
    jobs = {}
    for name in names:
        if name in _LIBS or name in jobs:
            continue
        src, so = _target(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs[name] = (proc, src, so, tmp)
    failed = []
    for name, (proc, src, so, tmp) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {src.name} "
                          f"(exit {proc.returncode}):\n{err}")
            continue
        so.with_suffix(".ptxas.txt").write_text(out + err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0
    for name in names:
        if name in _LIBS:
            continue
        _, so = _target(name)
        report = so.with_suffix(".ptxas.txt")
        _LIBS[name] = ctypes.CDLL(str(so))
        BUILDS[name] = BuildInfo(
            path=str(so), built=name in jobs, seconds=seconds,
            ptxas=report.read_text() if report.exists() else "")
    return {name: _LIBS[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return load_all([name])[name]


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
