"""Shape-derivative adjoint inputs: forward/adjoint fields near a structure.

Behavioral model: the reference's ``DerivativeInfo``
(/root/reference/tidy3d/components/autograd/derivative_utils.py:19), which
carries forward and adjoint E fields, permittivity data, inside/outside
permittivities and structure bounds into ``Geometry.compute_derivatives`` /
``Medium.compute_derivatives``. The math here is the standard continuum
shape derivative of a dielectric interface:

    dJ/d(outward shift) = Re{ pref * [ (eps_in - eps_out) E_par,f . E_par,a
                                - (1/eps_out - 1/eps_in) D_n,f . D_n,a ] } dA

with D = eps_r E (relative units) and pref = 2 k0^2 per frequency
(derivation in web/autograd.py; the discrete half-step offsets cancel
because the DFT timestamps reference the true sample times).

All fields are evaluated by trilinear interpolation from the adjoint
gradient monitors' raw (non-colocated) Yee samples.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ...constants import C_0

E_COMPS = ("Ex", "Ey", "Ez")


class _Field3:
    """Trilinear interpolator over a (nx, ny, nz) complex array."""

    def __init__(self, values: np.ndarray, coords: Dict[str, np.ndarray]):
        self.values = np.asarray(values)
        self.coords = {d: np.asarray(coords[d], dtype=float) for d in "xyz"}

    def __call__(self, x, y, z) -> np.ndarray:
        """Evaluate at broadcastable point arrays (clamped at edges)."""
        pts = np.broadcast_arrays(np.asarray(x, float), np.asarray(y, float),
                                  np.asarray(z, float))
        out_shape = pts[0].shape
        idx = []
        frac = []
        for d, p in zip("xyz", pts):
            c = self.coords[d]
            if len(c) == 1:
                idx.append((np.zeros(p.shape, int), np.zeros(p.shape, int)))
                frac.append(np.zeros(p.shape))
                continue
            i = np.clip(np.searchsorted(c, p) - 1, 0, len(c) - 2)
            f = (p - c[i]) / (c[i + 1] - c[i])
            idx.append((i, i + 1))
            frac.append(np.clip(f, 0.0, 1.0))
        v = self.values
        out = np.zeros(out_shape, dtype=v.dtype)
        for bx in (0, 1):
            wx = frac[0] if bx else (1 - frac[0])
            for by in (0, 1):
                wy = frac[1] if by else (1 - frac[1])
                for bz in (0, 1):
                    wz = frac[2] if bz else (1 - frac[2])
                    out = out + (wx * wy * wz) * v[idx[0][bx], idx[1][by],
                                                   idx[2][bz]]
        return out


def quad_weights(coords: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Cell-integration weights of sample points covering [lo, hi]."""
    coords = np.asarray(coords, dtype=float)
    if len(coords) == 0:
        return coords
    if len(coords) == 1:
        return np.array([max(hi - lo, 0.0)])
    mids = 0.5 * (coords[1:] + coords[:-1])
    edges = np.clip(np.concatenate([[lo], mids, [hi]]), lo, hi)
    return np.maximum(np.diff(edges), 0.0)


class DerivativeInfo:
    """Forward/adjoint fields and permittivities for one traced structure
    at one frequency.

    ``E_fwd`` / ``E_adj``: dict comp -> (complex ndarray, coords dict) on
    the gradient FieldMonitor's raw Yee grids. ``eps_data``: same layout
    from the PermittivityMonitor. ``eps_in`` / ``eps_out``: complex
    relative permittivities inside/outside the structure.
    """

    def __init__(self, E_fwd: Dict[str, Tuple[np.ndarray, dict]],
                 E_adj: Dict[str, Tuple[np.ndarray, dict]],
                 eps_data: Optional[Dict[str, Tuple[np.ndarray, dict]]],
                 eps_in: complex, eps_out: complex, frequency: float,
                 bounds: Tuple[Tuple[float, float, float],
                               Tuple[float, float, float]],
                 dt: float = 0.0, dl_loc: float = None, avg_dls=None):
        self.fwd = {c: _Field3(*E_fwd[c]) for c in E_fwd}
        self.adj = {c: _Field3(*E_adj[c]) for c in E_adj}
        self.eps = {c: _Field3(*eps_data[c]) for c in eps_data} \
            if eps_data else None
        # relative-D fields: the product eps_r * E is formed PER SAMPLE and
        # then interpolated — D_n is continuous across the interface while
        # eps and E_n each jump, so interpolating the factors separately
        # and multiplying is wrong exactly where the face integrals look
        avg_eps = 0.5 * (complex(eps_in) + complex(eps_out))
        self.dfwd = {}
        self.dadj = {}
        for c in self.fwd:
            if eps_data and c in eps_data \
                    and np.shape(eps_data[c][0]) == np.shape(E_fwd[c][0]):
                eps_vals = eps_data[c][0]
            else:
                eps_vals = avg_eps
            self.dfwd[c] = _Field3(eps_vals * E_fwd[c][0], E_fwd[c][1])
            self.dadj[c] = _Field3(eps_vals * E_adj[c][0], E_adj[c][1])
        self.eps_in = complex(eps_in)
        self.eps_out = complex(eps_out)
        self.frequency = float(frequency)
        self.bounds = bounds
        if dl_loc is None:
            # fall back to the mean sample spacing (matches the rasterizer's
            # dl_loc = mean over axes of the mean cell size on uniform grids)
            spacings = []
            for fld in self.fwd.values():
                for d in "xyz":
                    c = fld.coords[d]
                    if len(c) > 1:
                        spacings.append(float(np.mean(np.diff(c))))
                break
            dl_loc = float(np.mean(spacings)) if spacings else 1.0
        self.dl_loc = float(dl_loc)
        self.avg_dls = tuple(avg_dls) if avg_dls is not None \
            else (self.dl_loc,) * 3
        omega = 2 * np.pi * self.frequency
        k0 = omega / C_0
        # 2 k0^2 from the shape-derivative chain. No discrete-time phase
        # correction: the monitor DFT timestamps (tmesh + dt for E) and the
        # source-spectrum time base (tmesh) both reference the actual sample
        # times, so the half-step injection offset cancels exactly (verified
        # numerically against jax.grad through the solver: phase fit 0.0 +-
        # 0.1 deg, scale 1.000 +- 0.008, scripts/adjoint_map_check.py)
        self.prefactor = 2.0 * k0**2

    # ------------------------------------------------------------------ #
    # sampled products
    # ------------------------------------------------------------------ #

    def sample_coords(self, comp: str) -> Dict[str, np.ndarray]:
        return self.fwd[comp].coords

    def e_prod(self, comp: str, x, y, z) -> np.ndarray:
        """E_fwd(comp) * E_adj(comp) at the given points (complex)."""
        return self.fwd[comp](x, y, z) * self.adj[comp](x, y, z)

    def d_prod(self, comp: str, x, y, z) -> np.ndarray:
        """(eps_r E)_fwd * (eps_r E)_adj at the given points (each factor
        is a per-sample product interpolated as a whole — D continuity)."""
        return self.dfwd[comp](x, y, z) * self.dadj[comp](x, y, z)

    def e_vec(self, which: str, x, y, z) -> np.ndarray:
        """Stacked (3, ...) E vector of the fwd/adj run at the points."""
        fields = self.fwd if which == "fwd" else self.adj
        return np.stack([fields[c](x, y, z) for c in E_COMPS])

    def d_vec(self, which: str, x, y, z) -> np.ndarray:
        """Stacked (3, ...) relative-D vector (eps_r E) at the points."""
        fields = self.dfwd if which == "fwd" else self.dadj
        return np.stack([fields[c](x, y, z) for c in E_COMPS])

    # ------------------------------------------------------------------ #
    # interface integrand
    # ------------------------------------------------------------------ #

    def surface_integrand(self, normal: np.ndarray, x, y, z) -> np.ndarray:
        """The interface shape-derivative integrand at surface points.

        ``normal``: (3,) or (3, ...) outward unit normal(s). Returns the
        complex integrand per unit area (prefactor NOT applied):
        delta_eps * E_par.E_par - delta_inv_eps * D_n.D_n.
        """
        normal = np.asarray(normal)
        if normal.ndim == 1:
            normal = normal.reshape((3,) + (1,) * np.ndim(
                np.broadcast_arrays(np.asarray(x), np.asarray(y),
                                    np.asarray(z))[0]))
        ef = self.e_vec("fwd", x, y, z)
        ea = self.e_vec("adj", x, y, z)
        df = self.d_vec("fwd", x, y, z)
        da = self.d_vec("adj", x, y, z)
        dn_f = np.sum(normal * df, axis=0)
        dn_a = np.sum(normal * da, axis=0)
        # parallel E = E - n (n . E)
        en_f = np.sum(normal * ef, axis=0)
        en_a = np.sum(normal * ea, axis=0)
        epar = np.sum(ef * ea, axis=0) - en_f * en_a
        d_eps = self.eps_in - self.eps_out
        d_inv = 1.0 / self.eps_out - 1.0 / self.eps_in
        return d_eps * epar - d_inv * dn_f * dn_a

    def real_grad(self, integral: np.ndarray) -> np.ndarray:
        """Fold the physics prefactor and take the real part."""
        return np.real(self.prefactor * integral)


def raster_eps(geometry, cs, ci: int, dl_loc: float,
               eps_in: float, eps_out: float,
               avg_dls=None) -> np.ndarray:
    """The rasterizer's polarized-subpixel eps for component ``ci`` on the
    tensor grid ``cs = [xs, ys, zs]`` — the exact formula of
    solver/lowering.py (frac from the SDF, normal from the SDF gradient,
    harmonic along the normal / arithmetic transverse), INCLUDING its
    per-structure crop to bounds +- avg_dl: band cells can land on the
    crop edge where np.gradient falls back to one-sided differences, and
    matching those normals exactly is required for the adjoint to equal
    finite differences of the solve."""
    if avg_dls is None:
        avg_dls = (dl_loc, dl_loc, dl_loc)
    rmin, rmax = geometry.bounds
    sels = []
    crop = []
    for ax, c in enumerate(cs):
        sel = np.nonzero((c >= rmin[ax] - avg_dls[ax])
                         & (c <= rmax[ax] + avg_dls[ax]))[0]
        sels.append(sel)
        crop.append(np.asarray(c, float)[sel])
    out = np.full(tuple(len(c) for c in cs), float(eps_out))
    if any(len(c) == 0 for c in crop):
        return out
    X, Y, Z = np.meshgrid(*crop, indexing="ij")
    sdf = np.broadcast_to(np.asarray(geometry.sdf(X, Y, Z), float), X.shape)
    frac = np.clip(0.5 - sdf / dl_loc, 0.0, 1.0)
    if min(len(c) for c in crop) > 1:
        grads = np.gradient(sdf, *crop, edge_order=1)
    else:
        grads = [np.zeros_like(sdf)] * 3
    gnorm = np.sqrt(sum(g**2 for g in grads)) + 1e-30
    w_n = (grads[ci] / gnorm) ** 2
    eps_arith = frac * eps_in + (1.0 - frac) * eps_out
    eps_harm = 1.0 / (frac / eps_in + (1.0 - frac) / max(eps_out, 1e-6))
    out[np.ix_(*sels)] = (1.0 - w_n) * eps_arith + w_n * eps_harm
    return out


def raster_grad(info: DerivativeInfo, perturbed_geos: Dict,
                dl_loc: float) -> Dict:
    """Shape gradients as the exact discrete adjoint of the SDF rasterizer.

    dJ/dp = sum_cells sum_c dJ/deps_c(cell) * deps_c/dp, where
    dJ/deps_c(cell) = Re[pref E_fwd,c E_adj,c] dV (verified to match
    jax.grad through the solver, scripts/adjoint_map_check.py) and
    deps_c/dp is a central difference of the rasterizer's full
    polarized-averaging formula (``raster_eps``) under the perturbed
    geometries — capturing frac, clip AND interface-normal-rotation
    sensitivity (the normal term dominates at box edges/corners and is
    missed by continuum face integrals).

    ``perturbed_geos``: param name -> (geometry_plus, geometry_minus, 2h).
    """
    eps_in = float(np.real(info.eps_in))
    eps_out = float(np.real(info.eps_out))
    out = {name: 0.0 for name in perturbed_geos}
    for ci, comp in enumerate(E_COMPS):
        coords = info.sample_coords(comp)
        cs = [np.asarray(coords[d], dtype=float) for d in "xyz"]
        if any(len(c) == 0 for c in cs):
            continue
        X, Y, Z = np.meshgrid(*cs, indexing="ij")
        ws = [quad_weights(c, c[0] - 1e-12, c[-1] + 1e-12)
              if len(c) > 1 else np.array([dl_loc]) for c in cs]
        w3 = ws[0][:, None, None] * ws[1][None, :, None] * ws[2][None, None, :]
        g_eps = info.real_grad(info.e_prod(comp, X, Y, Z)) * w3
        avg_dls = getattr(info, "avg_dls", None)
        for name, (gp, gm, span) in perturbed_geos.items():
            ep = raster_eps(gp, cs, ci, dl_loc, eps_in, eps_out, avg_dls)
            em = raster_eps(gm, cs, ci, dl_loc, eps_in, eps_out, avg_dls)
            out[name] = out[name] + np.sum(g_eps * (ep - em)) / span
    return out
