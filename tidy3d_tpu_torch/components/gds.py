"""Native GDSII export (no gdstk/gdspy dependency).

Behavioral model: the upstream tidy3d components/geometry/base.py
(Geometry.to_gds:392, Simulation/Structure to_gds_file) — the reference
delegates polygonization to gdstk/gdspy; here cross-sections are extracted
from the geometry's `inside` field with marching squares (matplotlib
contour) and written directly in the GDSII stream format.
"""

from __future__ import annotations

import struct
from datetime import datetime
from typing import List, Sequence, Tuple

import numpy as np

# GDSII record types
_HEADER = 0x0002
_BGNLIB = 0x0102
_LIBNAME = 0x0206
_UNITS = 0x0305
_ENDLIB = 0x0400
_BGNSTR = 0x0502
_STRNAME = 0x0606
_ENDSTR = 0x0700
_BOUNDARY = 0x0800
_LAYER = 0x0D02
_DATATYPE = 0x0E02
_XY = 0x1003
_ENDEL = 0x1100


def _record(rec_type: int, data: bytes = b"") -> bytes:
    return struct.pack(">HH", 4 + len(data), rec_type) + data


def _real8(value: float) -> bytes:
    """GDSII 8-byte excess-64 floating point."""
    if value == 0:
        return b"\x00" * 8
    sign = 0
    if value < 0:
        sign = 0x80
        value = -value
    exponent = 0
    while value >= 1.0:
        value /= 16.0
        exponent += 1
    while value < 1.0 / 16.0:
        value *= 16.0
        exponent -= 1
    mantissa = int(value * (1 << 56))
    return struct.pack(">B", sign | (exponent + 64)) + mantissa.to_bytes(7, "big")


def _ascii(text: str) -> bytes:
    raw = text.encode("ascii")
    if len(raw) % 2:
        raw += b"\x00"
    return raw


def write_gds(fname: str, polygons: Sequence[Tuple[np.ndarray, int, int]],
              cell_name: str = "MAIN", unit: float = 1e-6,
              precision: float = 1e-9) -> None:
    """Write polygons [(Nx2 vertices in um, layer, datatype), ...] to a GDSII
    file."""
    now = datetime(2000, 1, 1)
    ts = struct.pack(">12H", now.year, now.month, now.day, now.hour,
                     now.minute, now.second, now.year, now.month, now.day,
                     now.hour, now.minute, now.second)
    scale = unit / precision  # db units per um
    out = [
        _record(_HEADER, struct.pack(">H", 600)),
        _record(_BGNLIB, ts),
        _record(_LIBNAME, _ascii("TIDY3D_TPU")),
        _record(_UNITS, _real8(precision / unit) + _real8(precision)),
        _record(_BGNSTR, ts),
        _record(_STRNAME, _ascii(cell_name)),
    ]
    for verts, layer, dtype in polygons:
        verts = np.asarray(verts, dtype=float)
        if len(verts) < 3:
            continue
        # GDSII closes the polygon explicitly: repeat the first vertex
        pts = np.vstack([verts, verts[:1]])
        ints = np.round(pts * scale).astype(np.int64)
        # XY records hold at most 8190 bytes => 1023 points per record
        if len(ints) > 1023:
            ints = ints[:1023]
        data = b"".join(struct.pack(">ii", int(x), int(y)) for x, y in ints)
        out.extend([
            _record(_BOUNDARY),
            _record(_LAYER, struct.pack(">H", layer)),
            _record(_DATATYPE, struct.pack(">H", dtype)),
            _record(_XY, data),
            _record(_ENDEL),
        ])
    out.extend([_record(_ENDSTR), _record(_ENDLIB)])
    with open(fname, "wb") as f:
        f.write(b"".join(out))


def polygons_of_geometry(geometry, normal_axis: int = 2, position: float = 0.0,
                         bounds=None, resolution: int = 512
                         ) -> List[np.ndarray]:
    """Cross-section polygons of a geometry at a plane, via marching squares
    on the `inside` field (works for every geometry type uniformly)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    b_ax, c_ax = (normal_axis + 1) % 3, (normal_axis + 2) % 3
    if bounds is None:
        rmin, rmax = geometry.bounds
        lo = [min(v, 1e9) for v in rmin]
        hi = [max(v, -1e9) for v in rmax]
        # clip infinities to a generous box around the finite extent
        span = [max(h - l, 1.0) if np.isfinite(h - l) and h - l < 1e9 else 1.0
                for l, h in zip(lo, hi)]
        lo = [l if np.isfinite(l) and abs(l) < 1e9 else -s
              for l, s in zip(lo, span)]
        hi = [h if np.isfinite(h) and abs(h) < 1e9 else s
              for h, s in zip(hi, span)]
    else:
        lo, hi = [list(b) for b in bounds]
    pad_b = (hi[b_ax] - lo[b_ax]) * 0.01 + 1e-6
    pad_c = (hi[c_ax] - lo[c_ax]) * 0.01 + 1e-6
    bs = np.linspace(lo[b_ax] - pad_b, hi[b_ax] + pad_b, resolution)
    cs = np.linspace(lo[c_ax] - pad_c, hi[c_ax] + pad_c, resolution)
    coords = [None, None, None]
    coords[normal_axis] = np.array([position])
    coords[b_ax] = bs
    coords[c_ax] = cs
    xg, yg, zg = np.meshgrid(coords[0], coords[1], coords[2], indexing="ij",
                             sparse=True)
    mask = np.broadcast_to(
        geometry.inside(xg, yg, zg),
        (len(coords[0]), len(coords[1]), len(coords[2]))).astype(float)
    field = np.moveaxis(mask, normal_axis, 0)[0]  # (b, c)

    fig = plt.figure()
    try:
        cset = plt.contour(bs, cs, field.T, levels=[0.5])
        polys = []
        paths = getattr(cset, "get_paths", None)
        all_paths = cset.get_paths() if paths else [
            p for coll in cset.collections for p in coll.get_paths()]
        for path in all_paths:
            for verts in path.to_polygons(closed_only=False):
                if len(verts) >= 3:
                    polys.append(np.asarray(verts))
    finally:
        plt.close(fig)
    return polys


def structure_to_gds_polygons(structure, normal_axis: int = 2,
                              position: float = 0.0, layer: int = 0,
                              dtype: int = 0, bounds=None
                              ) -> List[Tuple[np.ndarray, int, int]]:
    return [(p, layer, dtype) for p in polygons_of_geometry(
        structure.geometry, normal_axis, position, bounds=bounds)]


def simulation_to_gds_file(simulation, fname: str, z: float = None,
                           y: float = None, x: float = None,
                           gds_layer_dtype_map=None) -> None:
    """Export structure cross-sections of a simulation to a GDSII file
    (reference: Simulation.to_gds_file behavior)."""
    if z is not None:
        axis, pos = 2, z
    elif y is not None:
        axis, pos = 1, y
    elif x is not None:
        axis, pos = 0, x
    else:
        axis, pos = 2, simulation.center[2]
    polys: List[Tuple[np.ndarray, int, int]] = []
    gmap = gds_layer_dtype_map or {}
    for si, structure in enumerate(simulation.structures):
        layer, dtype = gmap.get(structure.medium, (si, 0)) \
            if gmap else (si, 0)
        polys.extend(structure_to_gds_polygons(
            structure, axis, pos, layer, dtype, bounds=simulation.bounds))
    write_gds(fname, polys)
