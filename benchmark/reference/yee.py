"""The plain reference of the benchmark: a Yee FDTD solve in plain PyTorch.

It follows the published semantics of the simulations the benchmark runs,
and works out from a ``Problem`` (the simulation's physical parameters)
everything the solver under test derives in its set-up: the grid, the
subpixel-averaged permittivity, the CPML, the pole (ADE) coefficients of
dispersive media, the source sheets and their waveforms, the running DFTs,
the flux integrals and the normalisation by the source spectrum. It imports
numpy, scipy and torch only.

Conventions (those of the simulation schema the benchmark drives):

* uniform cells of ``dl``; E_w at cell centres along w and at the lower
  cell boundaries across it, H_w the dual; an absorbing side adds its
  layers outside the domain, with a PEC wall behind them;
* CPML of Roden and Gedney with polynomial sigma and kappa (orders 3, sigma
  up to 1.5 in units of 2 eps0 / dt, kappa up to 3), alpha 0;
* dielectric boxes get polarised subpixel averaging from their signed
  distance, dispersive boxes are painted cell by cell;
* a pole-residue medium steps each pole as Q' = A Q + B (E^{n+1} + E^n),
  the E update subtracting Re(a (A + 1) Q);
* sources are equivalence sheets J = -n x H, M = n x E of the wanted wave,
  J at t_n + dt/2 and M at t_n + dt; the DFTs weigh E^{n+1} at t_n + dt
  and H^{n+1} at t_n + 1.5 dt by dt e^{i w t}.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

C_0 = 2.99792458e14            # um / s
MU_0 = 1.25663706212e-12
EPSILON_0 = 1 / (MU_0 * C_0 ** 2)
ETA_0 = float(np.sqrt(MU_0 / EPSILON_0))
INF = 1e10                     # the schema's "infinite" extent
DFT_CUTOFF = 1e-8
E_COMPS = ("Ex", "Ey", "Ez")
H_COMPS = ("Hx", "Hy", "Hz")
PML = dict(sigma_order=3, sigma_max=1.5, kappa_order=3, kappa_max=3.0)


# --------------------------------------------------------------------------- #
# the problem
# --------------------------------------------------------------------------- #


@dataclass
class Box:
    center: Tuple[float, float, float]
    size: Tuple[float, float, float]

    @property
    def bounds(self):
        lo = tuple(c - s / 2 for c, s in zip(self.center, self.size))
        hi = tuple(c + s / 2 for c, s in zip(self.center, self.size))
        return lo, hi

    def inside(self, x, y, z):
        out = True
        for p, c, s in zip((x, y, z), self.center, self.size):
            out = out & (np.abs(p - c) <= s / 2)
        return out

    def sdf(self, x, y, z):
        qs = [np.abs(np.asarray(p, float) - c) - min(s / 2, INF)
              for p, c, s in zip((x, y, z), self.center, self.size)]
        qx, qy, qz = np.broadcast_arrays(*qs)
        outside = np.sqrt(np.maximum(qx, 0) ** 2 + np.maximum(qy, 0) ** 2
                          + np.maximum(qz, 0) ** 2)
        return outside + np.minimum(np.maximum(qx, np.maximum(qy, qz)), 0.0)


@dataclass
class Material:
    """A permittivity, or a pole-residue fit: ``eps_inf`` and ``poles``
    as ``[(a, c), ...]`` in rad/s."""
    eps: float
    poles: List[Tuple[complex, complex]] = field(default_factory=list)

    def static(self):
        """``(eps, sigma, poles)`` of the time-domain update: pure
        conductivity poles (a = 0, real c) become sigma = 2 eps0 Re(c)."""
        sigma, poles = 0.0, []
        for a, c in self.poles:
            a, c = complex(a), complex(c)
            if a == 0 and abs(c.imag) < abs(c.real) * 1e-12:
                sigma += 2 * EPSILON_0 * c.real
            else:
                poles.append((a, c))
        return float(self.eps), sigma, poles

    def n_at(self, freq):
        w = 2 * np.pi * freq
        eps = self.eps + sum(-c / (1j * w + a) - np.conj(c) / (1j * w
                                                               + np.conj(a))
                             for a, c in self.poles)
        return float(np.real(np.sqrt(eps)))


@dataclass
class Pulse:
    """A Gaussian pulse with its DC component removed."""
    freq0: float
    fwidth: float
    offset: float = 5.0

    @property
    def twidth(self):
        return 1.0 / (2 * np.pi * self.fwidth)

    def amp(self, t):
        t = np.asarray(t)
        w0 = 2 * np.pi * self.freq0
        rel = t - self.offset * self.twidth
        env = np.exp(-(rel ** 2) / 2 / self.twidth ** 2)
        return np.exp(-1j * w0 * t) * env * (1j + rel / self.twidth ** 2 / w0)

    def spectrum(self, tmesh, freqs, dt, complex_fields):
        amps = self.amp(tmesh)
        amps = amps if complex_fields else np.real(amps)
        keep = np.where(np.abs(amps) / np.max(np.abs(amps)) > DFT_CUTOFF)[0]
        sl = slice(keep[0], keep[-1] + 1)
        kernel = np.exp(2j * np.pi * np.asarray(freqs)[None, :]
                        * tmesh[sl][:, None])
        return dt * np.sum(amps[sl][:, None] * kernel, axis=0)


@dataclass
class Problem:
    """One simulation as the reference sees it. ``absorb[axis]``: the CPML
    layers below and above (0: none); ``bloch[axis]``: the Bloch vector
    (in units of 2 pi over the period) of a periodic axis, None for an
    absorbing one. ``sources``: ``("mode", box, direction, mode_index,
    mode_cfg)`` or ``("plane", box, direction, theta, phi, pol)``;
    ``monitors``: ``("flux", name, box, freqs)``, ``("field", name, box,
    freqs, comps)`` or ``("time", name, box, comps)``."""
    center: Tuple[float, float, float]
    size: Tuple[float, float, float]
    dl: float
    absorb: Tuple[Tuple[int, int], ...]
    bloch: Tuple[Optional[float], ...]
    medium: Material
    structures: List[Tuple[Box, Material]]
    pulse: Pulse
    sources: list
    monitors: list
    run_time: float
    courant: float = 0.99


# --------------------------------------------------------------------------- #
# grid
# --------------------------------------------------------------------------- #


class Grid:
    def __init__(self, pb: Problem):
        self.bounds = []
        for axis in range(3):
            lo = pb.center[axis] - pb.size[axis] / 2
            hi = pb.center[axis] + pb.size[axis] / 2
            n = max(int(np.ceil((hi - lo) / pb.dl)), 1)
            b = lo + np.arange(n + 1) * ((hi - lo) / n)
            n_lo, n_hi = pb.absorb[axis]
            b = np.concatenate([b[0] - (b[1] - b[0]) * np.arange(n_lo, 0, -1),
                                b, b[-1] + (b[-1] - b[-2])
                                * np.arange(1, n_hi + 1)])
            self.bounds.append(b)
        self.centers = [0.5 * (b[1:] + b[:-1]) for b in self.bounds]
        self.shape = tuple(len(b) - 1 for b in self.bounds)
        dl_min = [float(np.min(np.diff(b))) for b in self.bounds]
        dl_avg = 1 / np.sqrt(sum(1 / d ** 2 for d in dl_min))
        self.dt = float(1 * pb.courant * dl_avg / C_0)
        self.tmesh = np.arange(0.0, pb.run_time + self.dt, self.dt)

    def coords(self, comp):
        """The 1D coordinates of a Yee component along x, y and z."""
        own = "xyz".index(comp[1])
        return [self.centers[a] if (comp[0] == "E") == (a == own)
                else self.bounds[a][:-1] for a in range(3)]

    def span(self, box: Box, extend=False):
        """``(start, stop)`` cell ranges a box covers, per axis."""
        out = []
        for axis, (lo, hi) in enumerate(zip(*box.bounds)):
            b = self.bounds[axis]
            n = len(b) - 1
            i0 = max(int(np.searchsorted(b, lo, side="right") - 1), 0)
            i1 = min(int(np.searchsorted(b, hi, side="left")), n)
            if i1 <= i0:
                i1 = i0 + 1
            if extend:
                i0, i1 = max(i0 - 1, 0), min(i1 + 1, n)
            out.append((i0, i1))
        return out

    def box_slices(self, box, comp, extend=True):
        sl, crd = [], []
        all_crd = self.coords(comp)
        for axis, (i0, i1) in enumerate(self.span(box, extend)):
            sl.append(slice(i0, i1))
            crd.append(all_crd[axis][i0:i1])
        return tuple(sl), crd


# --------------------------------------------------------------------------- #
# materials
# --------------------------------------------------------------------------- #


def material_arrays(pb: Problem, grid: Grid):
    """Per E component the permittivity and conductivity (float32, on the
    grid) and the pole slots ``[(a, c, {comp: mask})]``."""
    shape = grid.shape
    avg_dl = [float(np.mean(np.diff(b))) for b in grid.bounds]
    real_axes = [a for a in range(3) if shape[a] > 1]
    dl_sub = float(np.mean([avg_dl[a] for a in real_axes]))
    eps_all, sigma_all = {}, {}
    masks: Dict[int, Dict[str, np.ndarray]] = {}
    pole_defs: Dict[Tuple[int, int], Tuple[complex, complex]] = {}
    bg_eps, bg_sigma, _ = pb.medium.static()
    for ci, comp in enumerate(E_COMPS):
        xs, ys, zs = grid.coords(comp)
        eps = np.full(shape, bg_eps, np.float32)
        sigma = np.full(shape, bg_sigma, np.float32)
        for si, (box, mat) in enumerate(pb.structures):
            rmin, rmax = box.bounds
            idx = []
            for a, v in enumerate((xs, ys, zs)):
                ii = np.nonzero((v >= rmin[a] - avg_dl[a])
                                & (v <= rmax[a] + avg_dl[a]))[0]
                idx.append(ii)
            if any(len(ii) == 0 for ii in idx):
                continue
            sl = np.ix_(*idx)
            pts = np.meshgrid(xs[idx[0]], ys[idx[1]], zs[idx[2]],
                              indexing="ij", sparse=True)
            dims = tuple(len(ii) for ii in idx)
            s_eps, s_sigma, s_poles = mat.static()
            if not s_poles:
                sdf = np.broadcast_to(box.sdf(*pts), dims)
                frac = np.clip(0.5 - sdf / dl_sub, 0.0, 1.0)
                if np.all(frac == 0):
                    continue
                old = eps[sl]
                arith = frac * s_eps + (1 - frac) * old
                if min(dims) > 1:
                    grads = np.gradient(sdf, xs[idx[0]], ys[idx[1]],
                                        zs[idx[2]], edge_order=1)
                else:
                    grads = [np.zeros_like(sdf)] * 3
                gnorm = np.sqrt(sum(g ** 2 for g in grads)) + 1e-30
                w_n = (grads[ci] / gnorm) ** 2
                harm = 1.0 / (frac / s_eps + (1 - frac) / np.maximum(old,
                                                                     1e-6))
                eps[sl] = (1 - w_n) * arith + w_n * harm
                sigma[sl] = frac * s_sigma + (1 - frac) * sigma[sl]
                continue
            inside = np.broadcast_to(box.inside(*pts), dims)
            if not np.any(inside):
                continue
            eps[sl] = np.where(inside, s_eps, eps[sl])
            sigma[sl] = np.where(inside, s_sigma, sigma[sl])
            full = np.zeros(shape, bool)
            full[sl] = inside
            own = masks.setdefault(si, {})
            own[comp] = own[comp] | full if comp in own else full.copy()
            for pid, (a, c) in enumerate(s_poles):
                pole_defs[(si, pid)] = (a, c)
            for sk, comp_masks in masks.items():
                if sk != si and comp in comp_masks:
                    comp_masks[comp][full] = False
        eps_all[comp], sigma_all[comp] = eps, sigma
    poles = [(a, c, {comp: masks[si][comp] for comp in E_COMPS
                     if comp in masks[si] and masks[si][comp].any()})
             for (si, _), (a, c) in pole_defs.items()]
    return eps_all, sigma_all, [p for p in poles if p[2]]


def pml_coeffs(coords, bounds, n_lo, n_hi):
    """``(inv_kappa, b, c)`` of the CPML along one axis at ``coords``."""
    n = len(coords)
    inv_kappa, b, c = np.ones(n), np.zeros(n), np.zeros(n)
    for side, num in (("lo", n_lo), ("hi", n_hi)):
        if num == 0 or n <= 2 * num:
            continue
        if side == "lo":
            wall, iface = bounds[0], bounds[num]
            sl = slice(0, num + 1)
            d = np.clip((iface - coords[sl]) / (iface - wall), 0.0, 1.0)
        else:
            wall, iface = bounds[-1], bounds[len(bounds) - 1 - num]
            sl = slice(n - num - 1, n)
            d = np.clip((coords[sl] - iface) / (wall - iface), 0.0, 1.0)
        sig = PML["sigma_max"] * d ** PML["sigma_order"]
        kap = np.maximum(1.0 + (PML["kappa_max"] - 1.0)
                         * d ** PML["kappa_order"], 1.0)
        bb = np.exp(-2.0 * (sig / kap))
        den = sig * kap
        with np.errstate(divide="ignore", invalid="ignore"):
            cc = np.where(den > 0, sig / np.where(den > 0, den, 1.0)
                          * (bb - 1.0), 0.0)
        inv_kappa[sl], b[sl], c[sl] = 1.0 / kap, bb, cc
    return inv_kappa, b, c


# --------------------------------------------------------------------------- #
# sources
# --------------------------------------------------------------------------- #


def sheet_plane(grid: Grid, box: Box, axis: int):
    """Per component the slices and coordinates of a source sheet: the
    plane index nearest the box's position for every component."""
    i0 = int(np.argmin(np.abs(grid.bounds[axis] - box.center[axis])))
    out = {}
    for comp in E_COMPS + H_COMPS:
        sl, crd = grid.box_slices(box, comp, extend=False)
        ac = grid.coords(comp)[axis]
        idx = min(i0, len(ac) - 1)
        sl = list(sl)
        sl[axis] = slice(idx, idx + 1)
        crd[axis] = ac[idx:idx + 1]
        out[comp] = (tuple(sl), crd)
    return out


def numerical_k(freq, n, dl, dt):
    arg = (dl / (C_0 / n * dt)) * np.sin(2 * np.pi * freq * dt / 2.0)
    return float(2.0 / dl * np.arcsin(np.clip(arg, -1.0, 1.0)))


def plane_wave_fields(pb, grid, src):
    """Tangential fields of an angled plane wave on its sheet."""
    _, box, direction, theta, phi, pol = src
    a = box.size.index(0.0)
    b, c = (a + 1) % 3, (a + 2) % 3
    mat = pb.medium
    for sbox, m in pb.structures:
        if sbox.inside(*[np.array(v) for v in box.center]):
            mat = m
    n = mat.n_at(pb.pulse.freq0)
    k0 = 2 * np.pi * pb.pulse.freq0 * n / C_0
    if theta == 0.0:
        k0 = numerical_k(pb.pulse.freq0, n, float(np.min(np.diff(
            grid.bounds[a]))), grid.dt)
    s = 1.0 if direction == "+" else -1.0
    k_l = np.array([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                    s * np.cos(theta)])
    th = np.array([np.cos(theta) * np.cos(phi), np.cos(theta) * np.sin(phi),
                   -s * np.sin(theta)])
    ph = np.array([-np.sin(phi), np.cos(phi), 0.0])
    e_l = np.cos(pol) * th + np.sin(pol) * ph
    h_l = np.cos(pol) * ph - np.sin(pol) * th

    def glob(v):
        g = np.zeros(3)
        g[b], g[c], g[a] = v
        return g

    k, e, h = k0 * glob(k_l), glob(e_l), (n / ETA_0) * glob(h_l)
    fields = {}
    for ci, (comp, (sl, crd)) in enumerate(sheet_plane(grid, box,
                                                       a).items()):
        amp = (e if comp[0] == "E" else h)[ci % 3]
        xs, ys, zs = np.meshgrid(*crd, indexing="ij", sparse=True)
        phase = np.exp(1j * (k[0] * (xs - box.center[0])
                             + k[1] * (ys - box.center[1])
                             + k[2] * (zs - box.center[2])))
        fields[comp] = (sl, amp * np.broadcast_to(
            phase, tuple(len(v) for v in crd)).astype(np.complex64))
    return fields, a


def sheet_terms(grid, fields, axis, direction, amp_fn):
    """The currents of an equivalence sheet: ``[(comp, slices, profile,
    waveform)]``; J from H on E components, M from E on H components,
    each over the cell thickness at the sheet."""
    sign = 1.0 if direction == "+" else -1.0
    b, c = "xyz"[(axis + 1) % 3], "xyz"[(axis + 2) % 3]
    dl = float(np.diff(grid.bounds[axis])[0])
    terms = []
    for out, src, factor in ((f"E{b}", f"H{c}", sign),
                             (f"E{c}", f"H{b}", -sign),
                             (f"H{b}", f"E{c}", -sign),
                             (f"H{c}", f"E{b}", sign)):
        if fields.get(src) is None:
            continue
        sl, prof = fields[src]
        shift = 0.5 if out[0] == "E" else 1.0
        wf = amp_fn(grid.tmesh + shift * grid.dt)
        terms.append((out, sl, (factor / dl) * np.asarray(prof), wf))
    return terms


# --------------------------------------------------------------------------- #
# the solve
# --------------------------------------------------------------------------- #


def _wrap(F, axis, side, kind, phase):
    """The column across the edge: F(-1) for a backward difference at
    ``lo``, F(N) for a forward one at ``hi``."""
    n = F.shape[axis]
    if kind == "pec":
        return torch.zeros_like(F.narrow(axis, 0, 1))
    if side == "lo":
        col = F.narrow(axis, n - 1, 1)
        return col * np.conj(phase) if phase is not None else col
    col = F.narrow(axis, 0, 1)
    return col * phase if phase is not None else col


def _deriv(F, axis, backward, kind, phase, inv):
    n = F.shape[axis]
    D = torch.empty_like(F)
    if backward:
        torch.sub(F.narrow(axis, 1, n - 1), F.narrow(axis, 0, n - 1),
                  out=D.narrow(axis, 1, n - 1))
        D.narrow(axis, 0, 1).copy_(F.narrow(axis, 0, 1)
                                   - _wrap(F, axis, "lo", kind, phase))
    else:
        torch.sub(F.narrow(axis, 1, n - 1), F.narrow(axis, 0, n - 1),
                  out=D.narrow(axis, 0, n - 1))
        D.narrow(axis, n - 1, 1).copy_(_wrap(F, axis, "hi", kind, phase)
                                       - F.narrow(axis, n - 1, 1))
    return D.mul_(inv)


def _vec(v, axis, device):
    shape = [1, 1, 1]
    shape[axis] = len(v)
    return torch.as_tensor(np.asarray(v, np.float32).reshape(shape),
                           device=device)


def solve(pb: Problem, device="cpu") -> dict:
    """Steps the problem in float32 and returns its monitors: per flux
    monitor its normalised flux spectrum, per field monitor its normalised
    DFT fields, per time monitor its samples."""
    from .modes import mode_source_fields

    grid = Grid(pb)
    shape, dt, tmesh = grid.shape, grid.dt, grid.tmesh
    nsteps = len(tmesh)
    cplx = any(v is not None and v % 1.0 != 0 for v in pb.bloch)
    ftype = torch.complex64 if cplx else torch.float32
    kinds = ["periodic" if pb.bloch[a] is not None else "pec"
             for a in range(3)]
    phases = [np.exp(2j * np.pi * pb.bloch[a]) if cplx and pb.bloch[a]
              is not None else None for a in range(3)]
    eps, sigma, poles = material_arrays(pb, grid)
    dev = torch.device(device)

    # update coefficients
    coef = {}
    for comp in E_COMPS:
        er = eps[comp].astype(np.float64)
        rate = sigma[comp] / (EPSILON_0 * er)
        for a, c, masks in poles:
            if comp not in masks:
                continue
            B = EPSILON_0 * c * (dt / 2.0) / (1.0 - a * dt / 2.0)
            lam = float(np.real(a * B) + EPSILON_0 * np.real(c))
            rate = rate + 2.0 * lam / (EPSILON_0 * er) * masks[comp]
        loss = rate * dt / 2.0
        coef[comp] = (((1.0 - loss) / (1.0 + loss)).astype(np.float32),
                      (dt / (EPSILON_0 * er) / (1.0 + loss)).astype(
                          np.float32))
    db = float(np.float32(dt / MU_0))
    ca = {k: torch.as_tensor(v[0], device=dev) for k, v in coef.items()}
    cb = {k: torch.as_tensor(v[1], device=dev) for k, v in coef.items()}

    # derivative scales and CPML per axis and family
    inv = {"E": [], "H": []}
    cpml = {}
    for axis in range(3):
        bnd, cen = grid.bounds[axis], grid.centers[axis]
        n = shape[axis]
        dual = np.empty(n)
        dual[1:] = cen[1:] - cen[:-1]
        dual[0] = cen[0] + (bnd[-1] - bnd[0]) - cen[-1]
        primal = np.diff(bnd)
        n_lo, n_hi = pb.absorb[axis]
        for fam, crd, step in (("E", bnd[:-1], dual), ("H", cen, primal)):
            ik, bb, cc = pml_coeffs(crd, bnd, n_lo, n_hi)
            inv[fam].append(_vec(((1.0 / step) * ik).astype(np.float32),
                                 axis, dev))
            kap = 1.0 / ik
            for side, w in (("lo", n_lo + 1 if n_lo else 0),
                            ("hi", n_hi + 1 if n_hi else 0)):
                if not w:
                    continue
                sl = slice(0, w) if side == "lo" else slice(n - w, n)
                cpml[(fam, axis, side)] = (
                    w, _vec(bb[sl].astype(np.float32), axis, dev),
                    _vec((cc * kap)[sl].astype(np.float32), axis, dev))

    # sources: J on E components, M on H components
    src_t = []
    for src in pb.sources:
        fields, axis = (plane_wave_fields(pb, grid, src) if src[0] == "plane"
                        else mode_source_fields(pb, grid, src))
        for comp, sl, prof, wf in sheet_terms(grid, fields, axis, src[2],
                                              pb.pulse.amp):
            c_sl = coef[comp][1][sl] if comp[0] == "E" else db
            term = torch.as_tensor((-np.asarray(c_sl, np.float64) * prof)
                                   .astype(np.complex64), device=dev)
            src_t.append((comp, sl, term, wf))

    # monitors
    mons = []
    for mon in pb.monitors:
        kind, name, box = mon[:3]
        if kind == "time":
            comps = tuple(mon[3])
            sls = {c: grid.box_slices(box, c)[0] for c in comps}
            bufs = {c: torch.zeros((nsteps,) + tuple(s.stop - s.start
                                                     for s in sls[c]),
                                   dtype=torch.float32, device=dev)
                    for c in comps}
            mons.append((kind, name, box, comps, sls, bufs, None))
            continue
        freqs = np.asarray(mon[3], float)
        if kind == "flux":
            a = box.size.index(0.0)
            comps = (f"E{'xyz'[(a + 1) % 3]}", f"E{'xyz'[(a + 2) % 3]}",
                     f"H{'xyz'[(a + 1) % 3]}", f"H{'xyz'[(a + 2) % 3]}")
        else:
            comps = tuple(mon[4])
        sls = {c: grid.box_slices(box, c)[0] for c in comps}
        accs = {c: torch.zeros(tuple(s.stop - s.start for s in sls[c])
                               + (len(freqs),), dtype=torch.complex64,
                               device=dev) for c in comps}
        kern = {f: torch.as_tensor((dt * np.exp(
            2j * np.pi * (tmesh + shift * dt)[:, None] * freqs[None, :]))
            .astype(np.complex64), device=dev)
            for f, shift in (("E", 1.0), ("H", 1.5))}
        mons.append((kind, name, box, comps, sls, accs, (freqs, kern)))

    # state: the fields, the CPML slabs, the pole currents (per copy of a
    # complex run: Q[0] driven by Re E, Q[1] by Im E) on the boxes where
    # their media are
    E = {c: torch.zeros(shape, dtype=ftype, device=dev) for c in E_COMPS}
    H = {c: torch.zeros(shape, dtype=ftype, device=dev) for c in H_COMPS}
    psi = {}
    for fam, outs in (("E", E_COMPS), ("H", H_COMPS)):
        for i, comp in enumerate(outs):
            for axis in ((i + 1) % 3, (i + 2) % 3):
                for side in ("lo", "hi"):
                    if (fam, axis, side) in cpml:
                        s = list(shape)
                        s[axis] = cpml[(fam, axis, side)][0]
                        psi[(comp, axis, side)] = torch.zeros(
                            s, dtype=ftype, device=dev)
    pole_t = []
    for a, c, masks in poles:
        A = (1.0 + a * dt / 2.0) / (1.0 - a * dt / 2.0)
        Gc = a * (A + 1.0)
        B0 = EPSILON_0 * c * (dt / 2.0) / (1.0 - a * dt / 2.0)
        per = {}
        for comp, m in masks.items():
            nz = np.nonzero(m)
            box = tuple(slice(int(v.min()), int(v.max()) + 1) for v in nz)
            per[comp] = (box, torch.as_tensor(m[box].astype(np.float32),
                                              device=dev),
                         torch.zeros((1 + cplx,) + m[box].shape,
                                     dtype=torch.complex64, device=dev))
        pole_t.append((complex(A), complex(Gc), complex(B0), per))
    # tangential E is held at zero on a lower PEC wall
    walls = {comp: [a for a in range(3) if a != i and kinds[a] == "pec"]
             for i, comp in enumerate(E_COMPS)}
    # per component the box around every pole's cells, where E^n is kept
    ebox = {}
    for *_, per in pole_t:
        for comp, (box, _, _) in per.items():
            old = ebox.get(comp, box)
            ebox[comp] = tuple(slice(min(a.start, b.start), max(a.stop, b.stop))
                               for a, b in zip(old, box))

    def curl(fam, i, src):
        j, k = (i + 1) % 3, (i + 2) % 3
        other = H_COMPS if fam == "E" else E_COMPS
        out_comp = (E_COMPS if fam == "E" else H_COMPS)[i]
        d = {}
        for axis, name in ((j, other[k]), (k, other[j])):
            d[axis] = _deriv(src[name], axis, fam == "E", kinds[axis],
                             phases[axis], inv[fam][axis])
            for side in ("lo", "hi"):
                key = (out_comp, axis, side)
                if key not in psi:
                    continue
                w, bb, cc = cpml[(fam, axis, side)]
                n = shape[axis]
                part = d[axis].narrow(axis, 0 if side == "lo" else n - w, w)
                p = psi[key]
                p.mul_(bb).add_(cc * part)
                part.add_(p)
        return d[j].sub_(d[k])

    def inject(fields, fam, n_):
        for comp, sl, term, wf in src_t:
            if comp[0] == fam:
                add = term * complex(wf[n_])
                fields[comp][sl] += add if cplx else add.real

    for n_ in range(nsteps):
        oldE = {c: E[c][b].clone() for c, b in ebox.items()}
        for i, comp in enumerate(E_COMPS):
            rhs = curl("E", i, H)
            for A, Gc, B0, per in pole_t:
                if comp in per:
                    box, _, q = per[comp]
                    t = Gc.real * q.real - Gc.imag * q.imag
                    rhs[box] -= torch.complex(t[0], t[1]) if cplx else t[0]
            E[comp].mul_(ca[comp]).addcmul_(cb[comp], rhs)
            for axis in walls[comp]:
                E[comp].narrow(axis, 0, 1).zero_()
        inject(E, "E", n_)
        for A, Gc, B0, per in pole_t:
            for comp, (box, m, q) in per.items():
                rel = tuple(slice(b.start - e.start, b.stop - e.start)
                            for b, e in zip(box, ebox[comp]))
                es = (E[comp][box] + oldE[comp][rel]) * m
                q.mul_(A)
                if cplx:
                    q[0].add_(B0 * es.real)
                    q[1].add_(B0 * es.imag)
                else:
                    q[0].add_(B0 * es)
        for i, comp in enumerate(H_COMPS):
            H[comp].add_(curl("H", i, E), alpha=-db)
        inject(H, "H", n_)
        for kind, name, box, comps, sls, accs, dft in mons:
            for c in comps:
                v = (E if c[0] == "E" else H)[c][sls[c]]
                if kind == "time":
                    accs[c][n_].copy_(v.real if cplx else v)
                else:
                    accs[c].add_(v.unsqueeze(-1) * dft[1][c[0]][n_])
    return postprocess(pb, grid, mons, cplx)


# --------------------------------------------------------------------------- #
# monitor data
# --------------------------------------------------------------------------- #


def _interp1(vals, x, xt, axis):
    """Linear interpolation along ``axis`` onto ``xt``, holding the edge
    values beyond the ends."""
    if len(x) == 1:
        return np.take(vals, [0] * len(xt), axis=axis)
    i = np.clip(np.searchsorted(x, xt) - 1, 0, len(x) - 2)
    w = np.clip((np.asarray(xt) - x[i]) / (x[i + 1] - x[i]), 0.0, 1.0)
    shape = [1] * vals.ndim
    shape[axis] = len(xt)
    w = w.reshape(shape)
    return np.take(vals, i, axis=axis) * (1 - w) \
        + np.take(vals, i + 1, axis=axis) * w


def overlap_weights(x, lo, hi):
    if len(x) == 1:
        return np.array([max(hi - lo, 1.0) if hi > lo else 1.0])
    edges = np.clip(np.concatenate([[lo], 0.5 * (x[1:] + x[:-1]), [hi]]),
                    lo, hi)
    return np.maximum(np.diff(edges), 0.0)


def flux_of(grid, box, fields):
    """The flux through a plane from its DFT fields ``{comp: (array
    (x, y, z, f), coords)}``."""
    a = box.size.index(0.0)
    b, c = (a + 1) % 3, (a + 2) % 3
    names = [f"{f}{'xyz'[d]}" for f in "EH" for d in (b, c)]
    ref_crd = fields[names[0]][1]
    col = {}
    for nm in names:
        vals, crd = fields[nm]
        for d in (b, c):
            vals = _interp1(vals, crd[d], ref_crd[d], d)
        if len(crd[a]) > 1:
            vals = _interp1(vals, crd[a], np.array([box.center[a]]), a)
        col[nm] = np.take(vals, 0, axis=a)
    eb, ec, hb, hc = (col[nm] for nm in names)
    s = 0.5 * np.real(eb * np.conj(hc) - ec * np.conj(hb))
    lo, hi = box.bounds
    wb = overlap_weights(ref_crd[b], lo[b], hi[b])
    wc = overlap_weights(ref_crd[c], lo[c], hi[c])
    # the plane's two in-plane axes in array order (b, c sorted)
    first, second = sorted((b, c))
    w2 = (wb if first == b else wc)[:, None] * (wc if second == c
                                                else wb)[None, :]
    return np.sum(s * w2[..., None], axis=(0, 1))


def postprocess(pb, grid, mons, cplx):
    out = {}
    for kind, name, box, comps, sls, accs, dft in mons:
        if kind == "time":
            out[name] = {c: accs[c].cpu().numpy() for c in comps}
            continue
        freqs, _ = dft
        spec = pb.pulse.spectrum(grid.tmesh, freqs, grid.dt, cplx)
        fields = {}
        for c in comps:
            crd = grid.box_slices(box, c)[1]
            fields[c] = (accs[c].cpu().numpy().astype(np.complex128), crd)
        if kind == "flux":
            out[name] = flux_of(grid, box, fields) / np.abs(spec) ** 2
        else:
            out[name] = {c: v / spec for c, (v, _) in fields.items()}
    return out
