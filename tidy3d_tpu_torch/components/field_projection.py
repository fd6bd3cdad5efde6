"""Near-field to far-field projection.

Behavioral model: the upstream tidy3d components/field_projection.py
(FieldProjector:48 — equivalence currents from tangential near fields,
phase-weighted surface integration into radiation vectors, projection to
angles / cartesian points / k-space). Implemented with vectorized numpy
over (pts x angles); the DFT-like integrals are small compared to the solve.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import pydantic

from ..constants import C_0, EPSILON_0, ETA_0, MU_0
from ..exceptions import DataError, SetupError
from ..log import log
from .base import Tidy3dBaseModel, cached_property
from .data.data_array import (
    FieldProjectionAngleDataArray,
    FieldProjectionCartesianDataArray,
    FieldProjectionKSpaceDataArray,
)
from .geometry.utils import car_2_sph_field, sph_2_car
from .monitor import (
    AbstractFieldProjectionMonitor,
    FieldProjectionAngleMonitor,
    FieldProjectionCartesianMonitor,
    FieldProjectionKSpaceMonitor,
)

# points per wavelength used when resampling near fields before integration
PTS_PER_WVL = 10


class FieldProjector(Tidy3dBaseModel):
    """Projects near-field surface data to the far zone."""

    sim_data: Optional[object] = pydantic.Field(None, title="Simulation data")
    surfaces: Tuple = pydantic.Field(..., title="Surface field data",
                                     description="List of FieldData on the "
                                     "tangential surfaces with normal info.")
    medium_n: float = pydantic.Field(1.0, title="Background index")

    @classmethod
    def from_near_field_monitors(cls, sim_data, near_monitors, normal_dirs,
                                 medium_n: float = 1.0):
        surfaces = []
        for monitor, normal_dir in zip(near_monitors, normal_dirs):
            surfaces.append((sim_data[monitor.name], normal_dir))
        return cls(sim_data=sim_data, surfaces=tuple(surfaces), medium_n=medium_n)

    # ------------------------------------------------------------------ #
    # radiation vectors
    # ------------------------------------------------------------------ #

    def _surface_currents(self, field_data, normal_dir: str):
        """Equivalence currents J = n x H, M = -n x E at colocated points."""
        from .data.monitor_data import _colocated_tangential_fields

        monitor = field_data.monitor
        axis = tuple(monitor.size).index(0.0)
        comps, (b_dim, c_dim) = _colocated_tangential_fields(field_data, axis)
        sign = 1.0 if normal_dir == "+" else -1.0
        # enforce (b, c, f) memory layout: the colocated arrays keep the
        # original xyz dim order, which is transposed relative to the cyclic
        # (b, c) ordering for y-normal surfaces
        def _ordered(arr):
            want = tuple(d for d in (b_dim, c_dim, "f") if d in arr.dims)
            if tuple(arr.dims) != want:
                arr = arr.transpose(*want)
            return arr

        e_b, e_c = _ordered(comps[f"E{b_dim}"]), _ordered(comps[f"E{c_dim}"])
        h_b, h_c = _ordered(comps[f"H{b_dim}"]), _ordered(comps[f"H{c_dim}"])
        # n = sign * e_a with (a, b, c) cyclic:
        # (n x H)_b = -sign*H_c ; (n x H)_c = +sign*H_b
        j_b = -sign * h_c.values
        j_c = sign * h_b.values
        m_b = sign * e_c.values
        m_c = -sign * e_b.values
        coords = {b_dim: np.asarray(e_b.coords[b_dim], dtype=float),
                  c_dim: np.asarray(e_b.coords[c_dim], dtype=float)}
        freqs = np.asarray(e_b.coords["f"], dtype=float)
        pos_normal = float(monitor.center[axis])
        return dict(axis=axis, b_dim=b_dim, c_dim=c_dim, coords=coords,
                    freqs=freqs, j_b=j_b, j_c=j_c, m_b=m_b, m_c=m_c,
                    pos=pos_normal)

    def _integrate_surface(self, surf, k: np.ndarray, rx, ry, rz):
        """N, L radiation integrals for one surface at unit vectors (rx,ry,rz).

        Returns (N_x, N_y, N_z, L_x, L_y, L_z) with shape (npts, nf)."""
        axis = surf["axis"]
        b_ax = (axis + 1) % 3
        c_ax = (axis + 2) % 3
        b_coords = surf["coords"][surf["b_dim"]]
        c_coords = surf["coords"][surf["c_dim"]]
        # integration weights (trapezoid)
        wb = _trapz_weights(b_coords)
        wc = _trapz_weights(c_coords)
        w2d = wb[:, None] * wc[None, :]  # (nb, nc)

        # position vectors of surface points
        pos = [None, None, None]
        pos[axis] = np.array([surf["pos"]])
        pos[b_ax] = b_coords
        pos[c_ax] = c_coords
        xb = pos[0][:, None] if 0 == b_ax else None
        # build r' coordinates on the (b, c) grid
        coords3 = {}
        coords3[axis] = np.full((len(b_coords), len(c_coords)), surf["pos"])
        coords3[b_ax] = np.broadcast_to(b_coords[:, None],
                                        (len(b_coords), len(c_coords)))
        coords3[c_ax] = np.broadcast_to(c_coords[None, :],
                                        (len(b_coords), len(c_coords)))

        r_obs = (rx, ry, rz)
        npts = rx.shape[0]
        nf = len(surf["freqs"])
        out = []
        # phase = exp(+i k rhat . r') ; loop over freqs (k varies)
        NL = {name: np.zeros((npts, nf), dtype=complex)
              for name in ("Nx", "Ny", "Nz", "Lx", "Ly", "Lz")}
        # currents as 3-vectors on the surface
        J = [np.zeros_like(surf["j_b"])] * 3
        J = {b_ax: surf["j_b"], c_ax: surf["j_c"]}
        M = {b_ax: surf["m_b"], c_ax: surf["m_c"]}

        rdotrp = (r_obs[0][:, None, None] * coords3[0][None]
                  + r_obs[1][:, None, None] * coords3[1][None]
                  + r_obs[2][:, None, None] * coords3[2][None])  # (npts, nb, nc)
        # e^{-i w t} convention: outgoing G ~ e^{+ikr}, integrand e^{-ik rhat.r'}
        for fi in range(nf):
            phase = np.exp(-1j * k[fi] * rdotrp) * w2d[None]  # (npts, nb, nc)
            for ax in (b_ax, c_ax):
                j_f = J[ax][..., fi]  # (nb, nc)
                m_f = M[ax][..., fi]
                NL[f"N{'xyz'[ax]}"][:, fi] += np.einsum("pbc,bc->p", phase, j_f)
                NL[f"L{'xyz'[ax]}"][:, fi] += np.einsum("pbc,bc->p", phase, m_f)
        return NL

    def _project(self, monitor: AbstractFieldProjectionMonitor,
                 theta: np.ndarray, phi: np.ndarray, r_proj, freqs) -> Dict[str, np.ndarray]:
        """Far-zone spherical fields at flattened (theta, phi) observation
        directions; returns components with shape (npts, nf)."""
        n_med = self.medium_n
        k = 2 * np.pi * np.asarray(freqs) * n_med / C_0
        eta = ETA_0 / n_med

        sin_t, cos_t = np.sin(theta), np.cos(theta)
        sin_p, cos_p = np.sin(phi), np.cos(phi)
        rx, ry, rz = sin_t * cos_p, sin_t * sin_p, cos_t

        total = None
        for field_data, normal_dir in self.surfaces:
            surf = self._surface_currents(field_data, normal_dir)
            NL = self._integrate_surface(surf, k, rx, ry, rz)
            if total is None:
                total = NL
            else:
                for key in total:
                    total[key] = total[key] + NL[key]

        # spherical components of N, L
        def to_sph(vx, vy, vz):
            v_r = (vx * (sin_t * cos_p)[:, None] + vy * (sin_t * sin_p)[:, None]
                   + vz * cos_t[:, None])
            v_t = (vx * (cos_t * cos_p)[:, None] + vy * (cos_t * sin_p)[:, None]
                   - vz * sin_t[:, None])
            v_p = -vx * sin_p[:, None] + vy * cos_p[:, None]
            return v_r, v_t, v_p

        _, N_t, N_p = to_sph(total["Nx"], total["Ny"], total["Nz"])
        _, L_t, L_p = to_sph(total["Lx"], total["Ly"], total["Lz"])

        # far-zone fields (Balanis radiation integrals mapped to e^{-iwt};
        # signs match the reference: propagation factor -ik e^{ikr}/(4 pi r)
        # times Etheta = -(Lphi + eta Ntheta), Ephi = (Ltheta - eta Nphi)
        # — reference field_projection.py:514-515, monitor_data.py:2178 —
        # and independently cross-checked against the analytic dipole by
        # the exact-projection test):
        if r_proj is None:
            scalar = 1j * k[None, :] / (4 * np.pi)
        else:
            scalar = (1j * k[None, :] * np.exp(1j * k[None, :] * r_proj)
                      / (4 * np.pi * r_proj))
        e_theta = scalar * (L_p + eta * N_t)
        e_phi = -scalar * (L_t - eta * N_p)
        h_theta = -e_phi / eta
        h_phi = e_theta / eta
        zeros = np.zeros_like(e_theta)
        return dict(Er=zeros, Etheta=e_theta, Ephi=e_phi,
                    Hr=zeros, Htheta=h_theta, Hphi=h_phi)

    # ------------------------------------------------------------------ #
    # exact (non-far-field-approx) projection
    # ------------------------------------------------------------------ #

    def _project_exact(self, xs, ys, zs, freqs) -> Dict[str, np.ndarray]:
        """Exact homogeneous-medium dyadic-Green's-function projection —
        no geometric far-field approximation, valid in the near zone:

            E = iw (A + grad div A / k^2) - curl F / eps
            H = iw (F + grad div F / k^2) + curl A / mu0

        with vector potentials A = mu0 ∮ J G dS', F = eps ∮ M G dS' and
        the full G = e^{ikr}/(4 pi r) including the 1/r^2 and 1/r^3
        derivative terms (reference field_projection.py:831
        ``_fields_for_surface_exact``, Taflove eqs. 8.24-8.28).

        xs/ys/zs: flattened observation coordinates. Returns spherical
        components with shape (npts, nf)."""
        xs = np.asarray(xs, float).ravel()
        ys = np.asarray(ys, float).ravel()
        zs = np.asarray(zs, float).ravel()
        freqs = np.asarray(freqs, float)
        nf = len(freqs)
        npts = len(xs)
        n_med = self.medium_n
        k = 2 * np.pi * freqs * n_med / C_0
        i_omega = 1j * 2 * np.pi * freqs
        epsilon = EPSILON_0 * n_med**2

        tot = {c: np.zeros((npts, nf), dtype=complex)
               for c in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")}

        for field_data, normal_dir in self.surfaces:
            surf = self._surface_currents(field_data, normal_dir)
            axis = surf["axis"]
            b_ax, c_ax = (axis + 1) % 3, (axis + 2) % 3
            b = surf["coords"][surf["b_dim"]]
            c = surf["coords"][surf["c_dim"]]
            w2d = (_trapz_weights(b)[:, None]
                   * _trapz_weights(c)[None, :]).ravel()
            bb, cc = np.meshgrid(b, c, indexing="ij")
            P = np.zeros((bb.size, 3))
            P[:, axis] = surf["pos"]
            P[:, b_ax] = bb.ravel()
            P[:, c_ax] = cc.ravel()
            J = [0.0, 0.0, 0.0]
            M = [0.0, 0.0, 0.0]
            J[b_ax] = surf["j_b"].reshape(-1, nf)
            J[c_ax] = surf["j_c"].reshape(-1, nf)
            J[axis] = np.zeros_like(J[b_ax])
            M[b_ax] = surf["m_b"].reshape(-1, nf)
            M[c_ax] = surf["m_c"].reshape(-1, nf)
            M[axis] = np.zeros_like(M[b_ax])

            for pi in range(npts):
                dx = xs[pi] - P[:, 0]
                dy = ys[pi] - P[:, 1]
                dz = zs[pi] - P[:, 2]
                r = np.sqrt(dx * dx + dy * dy + dz * dz)
                r = np.where(r == 0.0, 1e-12, r)
                ct = np.clip(dz / r, -1.0, 1.0)
                st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))
                ph = np.arctan2(dy, dx)
                sp, cp = np.sin(ph), np.cos(ph)
                rc = r[:, None]
                ikr = 1j * k[None, :] * rc
                G = np.exp(ikr) / (4 * np.pi * rc)
                dG = G * (ikr - 1.0) / rc
                d2G = dG * (ikr - 1.0) / rc + G / rc**2
                stc = st[:, None]
                ctc = ct[:, None]
                spc = sp[:, None]
                cpc = cp[:, None]

                def pot_terms(cur, const):
                    """(pot, curl_pot, grad_div_pot) Cartesian terms of
                    one vector potential (reference ``potential_terms``)."""
                    r_x_c = [stc * spc * cur[2] - ctc * cur[1],
                             ctc * cur[0] - stc * cpc * cur[2],
                             stc * cpc * cur[1] - stc * spc * cur[0]]
                    r_dot = (stc * cpc * cur[0] + stc * spc * cur[1]
                             + ctc * cur[2])
                    r_dot_dt = (ctc * cpc * cur[0] + ctc * spc * cur[1]
                                - stc * cur[2])
                    r_dot_dp_div_st = -spc * cur[0] + cpc * cur[1]
                    g_r = d2G * r_dot
                    g_t = dG * r_dot_dt / rc
                    g_p = dG * r_dot_dp_div_st / rc
                    # spherical -> Cartesian at (theta, phi) of each r'
                    gdp = [
                        g_r * stc * cpc + g_t * ctc * cpc - g_p * spc,
                        g_r * stc * spc + g_t * ctc * spc + g_p * cpc,
                        g_r * ctc - g_t * stc,
                    ]
                    pot = [const * v * G for v in cur]
                    curl_pot = [const * v * dG for v in r_x_c]
                    grad_div_pot = [const * v for v in gdp]
                    return pot, curl_pot, grad_div_pot

                A, curl_A, gdiv_A = pot_terms(J, MU_0)
                F, curl_F, gdiv_F = pot_terms(M, epsilon)

                ksq = (k**2)[None, :]
                for ci, comp in enumerate("xyz"):
                    e_int = i_omega[None, :] * (A[ci] + gdiv_A[ci] / ksq) \
                        - curl_F[ci] / epsilon
                    h_int = i_omega[None, :] * (F[ci] + gdiv_F[ci] / ksq) \
                        + curl_A[ci] / MU_0
                    tot[f"E{comp}"][pi] += np.einsum("s,sf->f", w2d, e_int)
                    tot[f"H{comp}"][pi] += np.einsum("s,sf->f", w2d, h_int)

        # convert to spherical components at the observation angles
        r_obs = np.sqrt(xs**2 + ys**2 + zs**2)
        r_safe = np.where(r_obs == 0.0, 1.0, r_obs)
        ct = np.clip(zs / r_safe, -1.0, 1.0)
        st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))
        ph = np.arctan2(ys, xs)
        sp, cp = np.sin(ph), np.cos(ph)

        def to_sph(vx, vy, vz):
            v_r = (vx * (st * cp)[:, None] + vy * (st * sp)[:, None]
                   + vz * ct[:, None])
            v_t = (vx * (ct * cp)[:, None] + vy * (ct * sp)[:, None]
                   - vz * st[:, None])
            v_p = -vx * sp[:, None] + vy * cp[:, None]
            return v_r, v_t, v_p

        e_r, e_t, e_p = to_sph(tot["Ex"], tot["Ey"], tot["Ez"])
        h_r, h_t, h_p = to_sph(tot["Hx"], tot["Hy"], tot["Hz"])
        return dict(Er=e_r, Etheta=e_t, Ephi=e_p,
                    Hr=h_r, Htheta=h_t, Hphi=h_p)

    # ------------------------------------------------------------------ #
    # public API per monitor type
    # ------------------------------------------------------------------ #

    def project_fields(self, proj_monitor: AbstractFieldProjectionMonitor):
        if isinstance(proj_monitor, FieldProjectionAngleMonitor):
            return self._fields_angle(proj_monitor)
        if isinstance(proj_monitor, FieldProjectionCartesianMonitor):
            return self._fields_cartesian(proj_monitor)
        if isinstance(proj_monitor, FieldProjectionKSpaceMonitor):
            return self._fields_kspace(proj_monitor)
        raise SetupError(f"unsupported projection monitor {type(proj_monitor).__name__}")

    def _freqs(self):
        field_data, _ = self.surfaces[0]
        comp = next(iter(field_data.field_components.values()))
        return np.asarray(comp.coords["f"], dtype=float)

    def _fields_angle(self, monitor: FieldProjectionAngleMonitor):
        from .data.monitor_data import FieldProjectionAngleData

        theta = np.atleast_1d(np.asarray(monitor.theta, dtype=float))
        phi = np.atleast_1d(np.asarray(monitor.phi, dtype=float))
        freqs = self._freqs()
        tt, pp = np.meshgrid(theta, phi, indexing="ij")
        if monitor.far_field_approx:
            comps = self._project(monitor, tt.ravel(), pp.ravel(),
                                  monitor.proj_distance, freqs)
        else:
            xs, ys, zs = sph_2_car(monitor.proj_distance, tt.ravel(),
                                   pp.ravel())
            comps = self._project_exact(xs, ys, zs, freqs)
        arrays = {}
        for name, vals in comps.items():
            vals = vals.reshape(len(theta), len(phi), len(freqs))
            arrays[name] = FieldProjectionAngleDataArray(
                vals[None], coords=dict(r=np.atleast_1d(monitor.proj_distance),
                                        theta=theta, phi=phi, f=freqs))
        return FieldProjectionAngleData(monitor=monitor, projection_surfaces=(),
                                        **arrays)

    def _fields_cartesian(self, monitor: FieldProjectionCartesianMonitor):
        from .data.monitor_data import FieldProjectionCartesianData

        x = np.atleast_1d(np.asarray(monitor.x, dtype=float))
        y = np.atleast_1d(np.asarray(monitor.y, dtype=float))
        freqs = self._freqs()
        xx, yy = np.meshgrid(x, y, indexing="ij")
        # local (x, y, proj_distance) -> global position relative to origin
        a = monitor.proj_axis
        pts_local = [xx.ravel(), yy.ravel(),
                     np.full(xx.size, monitor.proj_distance)]
        # map local axes: local z -> proj_axis
        pts = [None, None, None]
        b_ax, c_ax = (a + 1) % 3, (a + 2) % 3
        pts[b_ax], pts[c_ax], pts[a] = pts_local[0], pts_local[1], pts_local[2]
        r = np.sqrt(pts[0]**2 + pts[1]**2 + pts[2]**2)
        if monitor.far_field_approx:
            theta = np.arccos(
                np.clip(pts[a] * 0 + pts[2] / np.where(r == 0, 1, r), -1, 1))
            phi = np.arctan2(pts[1], pts[0])
            comps = self._project(monitor, theta, phi, None, freqs)
            # apply the exact per-point spherical spreading e^{ikr}/r
            k = 2 * np.pi * freqs * self.medium_n / C_0
            spread = np.exp(1j * np.outer(r, k)) / r[:, None]
        else:
            comps = self._project_exact(pts[0], pts[1], pts[2], freqs)
            spread = 1.0
        arrays = {}
        for name, vals in comps.items():
            vals = (vals * spread).reshape(len(x), len(y), 1, len(freqs))
            arrays[name] = FieldProjectionCartesianDataArray(
                vals, coords=dict(x=x, y=y,
                                  z=np.atleast_1d(monitor.proj_distance), f=freqs))
        return FieldProjectionCartesianData(monitor=monitor, projection_surfaces=(),
                                            **arrays)

    def _fields_kspace(self, monitor: FieldProjectionKSpaceMonitor):
        from .data.monitor_data import FieldProjectionKSpaceData
        from .geometry.utils import kspace_2_sph

        ux = np.atleast_1d(np.asarray(monitor.ux, dtype=float))
        uy = np.atleast_1d(np.asarray(monitor.uy, dtype=float))
        freqs = self._freqs()
        uxx, uyy = np.meshgrid(ux, uy, indexing="ij")
        theta, phi = kspace_2_sph(uxx.ravel(), uyy.ravel(), monitor.proj_axis)
        if monitor.far_field_approx:
            comps = self._project(monitor, theta, phi,
                                  monitor.proj_distance, freqs)
        else:
            xs, ys, zs = sph_2_car(monitor.proj_distance, theta, phi)
            comps = self._project_exact(xs, ys, zs, freqs)
        arrays = {}
        for name, vals in comps.items():
            vals = vals.reshape(len(ux), len(uy), 1, len(freqs))
            arrays[name] = FieldProjectionKSpaceDataArray(
                vals, coords=dict(ux=ux, uy=uy,
                                  r=np.atleast_1d(monitor.proj_distance), f=freqs))
        return FieldProjectionKSpaceData(monitor=monitor, projection_surfaces=(),
                                         **arrays)


def _trapz_weights(coords: np.ndarray) -> np.ndarray:
    coords = np.asarray(coords, dtype=float)
    if len(coords) == 1:
        return np.ones(1)
    w = np.zeros(len(coords))
    d = np.diff(coords)
    w[:-1] += d / 2
    w[1:] += d / 2
    return w
