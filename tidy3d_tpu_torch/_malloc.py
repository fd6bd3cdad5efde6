"""glibc malloc tuning for paged-memory hosts.

On virtualized hosts with on-demand memory (e.g. microVMs backing TPU
pods), first-touch page faults on freshly mmap'd regions can run at only
tens of MB/s, making every large numpy allocation (solver lowering
rasterizes multi-hundred-MB coefficient grids) take tens of seconds.
glibc by default serves allocations above 128 kB via mmap and returns
them to the OS on free, so the fault cost is paid on EVERY allocation.

Raising M_MMAP_THRESHOLD and M_TRIM_THRESHOLD keeps big buffers on the
main heap where freed pages stay resident and are reused warm: measured
here, a repeated 227 MB ``np.full`` drops from ~6 s to ~0.03 s. The
trade-off is that the process holds its high-water-mark RSS, which is the
right call for a solver process.

Disable with ``TIDY3D_TPU_MALLOC_TUNE=0``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import sys

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_THRESHOLD = 2**31 - 1  # mallopt takes int; effectively "never"


def tune_malloc() -> bool:
    """Apply the glibc tuning; returns True when applied."""
    if os.environ.get("TIDY3D_TPU_MALLOC_TUNE", "1") in ("0", "false", "off"):
        return False
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, _THRESHOLD)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, _THRESHOLD)
        return bool(ok1) and bool(ok2)
    except Exception:  # pragma: no cover - non-glibc platforms
        return False


_APPLIED = tune_malloc()
