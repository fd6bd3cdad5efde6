"""The reference's mode solver: the guided modes of a waveguide cross
section, for a mode source's sheet.

A finite-difference eigenproblem on the plane's Yee cells (transverse E,
``beta^2`` eigenvalues, walls of PEC at the plane's edges), with the plane's
permittivity from polarised subpixel averaging of the structures' signed
distances, the modes normalised to unit power along the normal and phased so
that their largest transverse E value is real and positive.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spl

from .yee import C_0, ETA_0, Box, Grid, Problem, _interp1, sheet_plane

DENSE_CUTOFF = 600


def _plane(grid: Grid, box: Box):
    a = box.size.index(0.0)
    b, c = (a + 1) % 3, (a + 2) % 3
    span = grid.span(box, extend=False)
    return a, b, c, [grid.bounds[ax][span[ax][0]:span[ax][1] + 1]
                     for ax in (b, c)]


def _local_positions(xb, yb):
    cb, cc = 0.5 * (xb[1:] + xb[:-1]), 0.5 * (yb[1:] + yb[:-1])
    return {"Ex": (cb, yb[:-1]), "Ey": (xb[:-1], cc), "Ez": (xb[:-1], yb[:-1]),
            "Hx": (xb[:-1], cc), "Hy": (cb, yb[:-1]), "Hz": (cb, cc)}


def plane_eps(pb: Problem, grid: Grid, box: Box, freq: float):
    """The diagonal permittivity at the plane's local Ex, Ey, Ez points,
    each an array (n_b, n_c)."""
    a, b, c, (xb, yb) = _plane(grid, box)
    pos = _local_positions(xb, yb)
    dl = float(np.mean([np.mean(np.diff(v)) for v in (xb, yb)
                        if len(v) > 2]))
    half = dl / 2.0
    out = []
    for local, row_axis in (("Ex", b), ("Ey", c), ("Ez", a)):
        coords = [None] * 3
        coords[a] = np.array([box.center[a]])
        coords[b], coords[c] = pos[local]
        shape = tuple(len(v) for v in coords)
        row = np.full(shape, pb.medium.eps, dtype=complex)
        for sbox, mat in pb.structures:
            if mat.poles:
                raise NotImplementedError("dispersive media on a mode plane")
            rmin, rmax = sbox.bounds
            idx = [np.nonzero((v >= rmin[k] - dl) & (v <= rmax[k] + dl))[0]
                   for k, v in enumerate(coords)]
            if any(len(ii) == 0 for ii in idx):
                continue
            sl = np.ix_(*idx)
            pts, cut = [], []
            for v, ii in zip(coords, idx):
                v = v[ii]
                if len(v) == 1:
                    pts.append(np.array([v[0] - half, v[0], v[0] + half]))
                    cut.append(slice(1, 2))
                else:
                    pts.append(v)
                    cut.append(slice(None))
            g = np.meshgrid(*pts, indexing="ij", sparse=True)
            sdf = np.broadcast_to(sbox.sdf(*g), tuple(len(p) for p in pts))
            grads = [np.gradient(sdf, pts[k], axis=k, edge_order=1)
                     if len(pts[k]) > 1 else np.zeros_like(sdf)
                     for k in range(3)]
            gnorm = np.sqrt(sum(gr ** 2 for gr in grads)) + 1e-30
            w_n = ((grads[row_axis] / gnorm)[tuple(cut)]) ** 2
            frac = np.clip(0.5 - sdf / dl, 0.0, 1.0)[tuple(cut)]
            if np.all(frac == 0):
                continue
            old = row[sl]
            arith = frac * mat.eps + (1 - frac) * old
            safe = np.where(np.abs(old) < 1e-6, 1e-6, old)
            harm = 1.0 / (frac / mat.eps + (1 - frac) / safe)
            row[sl] = (1 - w_n) * arith + w_n * harm
        arr = np.squeeze(row, axis=a)
        out.append(arr.T if b > c else arr)
    return out


def _diff_mats(bounds):
    n = len(bounds) - 1
    cen = 0.5 * (bounds[1:] + bounds[:-1])
    prim = np.diff(bounds)
    dual = np.empty(n)
    dual[0] = prim[0]
    dual[1:] = cen[1:] - cen[:-1]
    i = np.arange(n)
    Df = sp.csr_matrix((np.concatenate([-1 / prim, 1 / prim[:-1]]),
                        (np.concatenate([i, i[:-1]]),
                         np.concatenate([i, i[1:]]))), shape=(n, n),
                       dtype=complex)
    Db = sp.csr_matrix((np.concatenate([1 / dual, -1 / dual[1:]]),
                        (np.concatenate([i, i[1:]]),
                         np.concatenate([i, i[:-1]]))), shape=(n, n),
                       dtype=complex)
    return Df, Db


def solve_mode(eps, xb, yb, freq, mode_index):
    """``(fields, n_eff)`` of mode ``mode_index`` (by falling effective
    index) on the plane: local ``Ex ... Hz`` arrays (n_b, n_c)."""
    exx, eyy, ezz = [np.asarray(e, complex) for e in eps]
    nx, ny = exx.shape
    k0 = 2 * np.pi * freq / C_0
    Dxf1, Dxb1 = _diff_mats(xb)
    Dyf1, Dyb1 = _diff_mats(yb)
    Ix, Iy = sp.identity(nx, dtype=complex), sp.identity(ny, dtype=complex)
    Dxf, Dxb = sp.kron(Dxf1, Iy).tocsr(), sp.kron(Dxb1, Iy).tocsr()
    Dyf, Dyb = sp.kron(Ix, Dyf1).tocsr(), sp.kron(Ix, Dyb1).tocsr()
    mz, mx, my = np.ones((nx, ny)), np.ones((nx, ny)), np.ones((nx, ny))
    mz[0, :] = mz[:, 0] = 0.0
    my[0, :] = 0.0
    mx[:, 0] = 0.0
    Pz = sp.diags(mz.ravel())
    inv_ez = Pz @ sp.diags(1.0 / ezz.ravel())
    I = sp.identity(nx * ny, dtype=complex)
    ik0 = 1j * k0
    A = sp.bmat([[(1 / ik0) * (Dxf @ inv_ez @ Dyb),
                  ik0 * I - (1 / ik0) * (Dxf @ inv_ez @ Dxb)],
                 [-ik0 * I + (1 / ik0) * (Dyf @ inv_ez @ Dyb),
                  -(1 / ik0) * (Dyf @ inv_ez @ Dxb)]]).tocsr()
    B = sp.bmat([[-(1 / ik0) * (Dxb @ Dyf),
                  -ik0 * sp.diags(eyy.ravel()) + (1 / ik0) * (Dxb @ Dxf)],
                 [ik0 * sp.diags(exx.ravel()) - (1 / ik0) * (Dyb @ Dyf),
                  (1 / ik0) * (Dyb @ Dxf)]]).tocsr()
    Pt = sp.diags(np.concatenate([mx.ravel(), my.ravel()]))
    M = (Pt @ (-(A @ B)) @ Pt).tocsr()
    n_max = float(np.sqrt(np.max(np.real(np.stack([exx, eyy, ezz]))
                                 .clip(min=1.0))))
    N = nx * ny
    if 2 * N <= DENSE_CUTOFF:
        vals, vecs = np.linalg.eig(M.toarray())
    else:
        vals, vecs = spl.eigs(M, k=min(mode_index + 5, 2 * N - 2),
                              sigma=(n_max * k0) ** 2, which="LM")
    beta = np.sqrt(vals.astype(complex))
    beta[np.real(beta) < 0] *= -1
    neff = beta / k0
    keep = [i for i in np.argsort(-np.real(neff))
            if 0 < np.real(neff[i]) <= n_max * (1 + 1e-6)
            and abs(np.imag(neff[i])) / abs(np.real(neff[i])) <= 1e-4]
    m = keep[mode_index]
    ex, ey, bt = vecs[:N, m], vecs[N:, m], beta[m]
    hz = (Dxf @ ey - Dyf @ ex) / ik0
    lhs = sp.diags(-(k0 ** 2) * ezz.ravel()) + Dxb @ Dxf + Dyb @ Dyf
    lhs = Pz @ lhs @ Pz + sp.diags(1.0 - mz.ravel())
    rhs = mz.ravel() * (1j * bt * (Dxb @ ex + Dyb @ ey))
    ez = spl.spsolve(lhs.tocsc(), rhs)
    hx = (Dyf @ ez - 1j * bt * ey) / ik0
    hy = (1j * bt * ex - Dxf @ ez) / ik0
    f = {"Ex": ex, "Ey": ey, "Ez": ez, "Hx": hx / ETA_0, "Hy": hy / ETA_0,
         "Hz": hz / ETA_0}
    f = {k: v.reshape(nx, ny) for k, v in f.items()}
    sz = np.real(f["Ex"] * np.conj(f["Hy"]) - f["Ey"] * np.conj(f["Hx"]))
    power = 0.5 * float(np.sum(sz * np.diff(xb)[:, None]
                               * np.diff(yb)[None, :]))
    e_t = np.stack([f["Ex"], f["Ey"]])
    val = e_t[np.unravel_index(np.argmax(np.abs(e_t)), e_t.shape)]
    scale = (1.0 / np.sqrt(abs(power))) * (np.abs(val) / val)
    return {k: v * scale for k, v in f.items()}, complex(neff[m])


def mode_source_fields(pb: Problem, grid: Grid, src):
    """The sheet fields of a mode source (``("mode", box, direction,
    mode_index)``): ``({comp: (slices, profile)}, normal axis)``."""
    _, box, direction, mode_index = src[:4]
    a, b, c, (xb, yb) = _plane(grid, box)
    freq = pb.pulse.freq0
    fields, neff = solve_mode(plane_eps(pb, grid, box, freq), xb, yb, freq,
                              mode_index)
    pos = _local_positions(xb, yb)
    to_global = {"x": "xyz"[b], "y": "xyz"[c], "z": "xyz"[a]}
    beta = 2 * np.pi * freq / C_0 * neff
    sign = 1.0 if direction == "+" else -1.0
    out = {}
    sheet = sheet_plane(grid, box, a)
    for local, arr in fields.items():
        comp = local[0] + to_global[local[1]]
        sl, crd = sheet[comp]
        pb_, pc_ = pos[local]
        vals = _interp1(_interp1(arr, pb_, crd[b], 0), pc_, crd[c], 1)
        vals = np.expand_dims(vals if b < c else vals.T, axis=a)
        phase = np.exp(1j * sign * beta * (float(crd[a][0]) - box.center[a]))
        out[comp] = (sl, (vals * phase).astype(np.complex64))
    return out, a
