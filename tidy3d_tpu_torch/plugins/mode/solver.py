"""Vector finite-difference waveguide mode eigensolver on a 2D Yee cross
section.

Role model: the upstream tidy3d plugins/mode/solver.py (EigSolver — sparse
operator assembly + ARPACK shift-invert). This implementation re-derives the
discrete eigenproblem directly from the staggered Yee equations (see below),
assembles sparse operators, and solves with shift-invert ARPACK on host.
A dense JAX path (jnp.linalg.eig on the reduced operator) is used for small
cross sections so the hot path can move to the MXU.

Discretization (plane normal = local z, fields ~ exp(i(beta z - w t)),
h = eta0 H, k0 = w/c):

    i k0 hx = Dyf Ez - i beta Ey          i k0 hz = Dxf Ey - Dyf Ex
    i k0 hy = i beta Ex - Dxf Ez
    -i k0 ex_eps Ex = Dyb hz - i beta hy  -i k0 ez_eps Ez = Dxb hy - Dyb hx
    -i k0 ey_eps Ey = i beta hx - Dxb hz

Eliminating Ez, hz yields  i beta e_t = A h_t,  i beta h_t = B e_t  and the
transverse-E eigenproblem  (-A B) e_t = beta^2 e_t.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spl

from ...constants import C_0, ETA_0, fp_eps, pec_val
from ...exceptions import SetupError
from ...log import log

# matrix size (2N) below which dense eig beats shift-invert ARPACK
DENSE_SIZE_CUTOFF = 600
# PML parameters for mode-plane absorbing layers
MODE_PML_SIGMA_MAX = 3.0
MODE_PML_ORDER = 3


def _derivative_mats(bounds: np.ndarray, s_bnd: np.ndarray, s_cen: np.ndarray
                     ) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """(Df, Db): forward difference (boundary-indexed -> center-indexed) and
    backward difference (center-indexed -> boundary-indexed), with 1/s PML
    stretch factors. Fields beyond the plane edges are zero (PEC-backed)."""
    n = len(bounds) - 1  # number of cells = number of centers
    centers = 0.5 * (bounds[1:] + bounds[:-1])
    dl_primal = np.diff(bounds)
    # forward: (f[i+1]-f[i])/dx at centers; boundary-indexed f has n points
    # (the stored boundaries 0..n-1; f[n] = 0 by PEC)
    rows, cols, vals = [], [], []
    for i in range(n):
        inv = 1.0 / (dl_primal[i] * s_cen[i])
        rows.append(i), cols.append(i), vals.append(-inv)
        if i + 1 < n:
            rows.append(i), cols.append(i + 1), vals.append(inv)
    Df = sp.csr_matrix((vals, (rows, cols)), shape=(n, n), dtype=complex)

    # backward: (f[i]-f[i-1])/dxd at boundaries; center-indexed f (f[-1]=0)
    dl_dual = np.empty(n)
    dl_dual[0] = dl_primal[0]
    if n > 1:
        dl_dual[1:] = centers[1:] - centers[:-1]
    rows, cols, vals = [], [], []
    for i in range(n):
        inv = 1.0 / (dl_dual[i] * s_bnd[i])
        rows.append(i), cols.append(i), vals.append(inv)
        if i - 1 >= 0:
            rows.append(i), cols.append(i - 1), vals.append(-inv)
    Db = sp.csr_matrix((vals, (rows, cols)), shape=(n, n), dtype=complex)
    return Df, Db


def compute_modes(
    eps_cross,
    coords: Tuple[np.ndarray, np.ndarray],
    freq: float,
    mode_spec,
    direction: str = "+",
    solver_basis_fields=None,
    device=None,
) -> Tuple[dict, np.ndarray]:
    """Solve for waveguide modes on a 2D Yee cross-section.

    Parameters
    ----------
    eps_cross : tuple of 3 arrays (eps_xx, eps_yy, eps_zz) sampled at the
        in-plane Yee positions of Ex, Ey, Ez respectively; shape (Nx, Ny)
        in local plane coordinates (x = first in-plane axis, y = second,
        z = propagation normal).
    coords : (x_bounds, y_bounds) cell boundary coords of the plane grid
        (len Nx+1, Ny+1).
    freq : frequency [Hz].
    mode_spec : ModeSpec.
    device : where the device filter runs when it is routed there
        (``plugins/mode/device_solver.py``); None takes the innermost
        ``device_solver.solve_on`` scope's, else CUDA. Small planes (dense
        eig) and ARPACK stay on the host on any device.

    Returns
    -------
    (fields, n_complex): fields = dict of 6 arrays (Ex..Hz), each
    (Nx, Ny, num_modes) complex; n_complex = (num_modes,) complex array.
    """
    # explicit copies: the bend transform and PEC clamp below modify these
    # in place, and np.asarray would alias caller arrays that are already
    # complex (a second solve on the same inputs would double-apply them)
    # eps_cross: 3 diagonal arrays, or 9 row-major tensor components
    # (xx, xy, xz, yx, ...) at the row component's Yee position (reference
    # mode_solver.py:587-593 eps_keys ordering, rotated to local axes)
    eps_full = None
    if len(eps_cross) == 9:
        full = [np.array(e, dtype=complex) for e in eps_cross]
        offdiag = [full[i] for i in (1, 2, 3, 5, 6, 7)]
        if any(np.any(np.abs(o) > 1e-12) for o in offdiag):
            eps_full = full
        eps_xx, eps_yy, eps_zz = full[0], full[4], full[8]
    else:
        eps_xx, eps_yy, eps_zz = [np.array(e, dtype=complex)
                                  for e in eps_cross]
    x_b, y_b = [np.asarray(c, dtype=float) for c in coords]
    nx, ny = eps_xx.shape
    if (nx != len(x_b) - 1) or (ny != len(y_b) - 1):
        raise SetupError(f"eps shape {eps_xx.shape} does not match plane grid "
                         f"({len(x_b) - 1}, {len(y_b) - 1})")
    num_modes = mode_spec.num_modes
    k0 = 2 * np.pi * freq / C_0

    # bend: radial transform straightens the bend at the cost of DIAGONAL
    # anisotropic eps AND mu: with r the distance from the bend center and R
    # the bend radius, J = diag(1, 1, R/r) gives eps' = J eps J^T/det(J) =
    # (eps r/R, eps r/R, eps R/r), and identically for mu (reference:
    # plugins/mode/transforms.py radial_transform:14 — only dw/dz = R/r is
    # nontrivial). Factors are evaluated at each component's own Yee position
    # along the radial axis.
    mu_xx = np.ones((nx, ny))
    mu_yy = np.ones((nx, ny))
    mu_zz = np.ones((nx, ny))
    if mode_spec.bend_radius is not None:
        R = float(mode_spec.bend_radius)
        bend_axis = mode_spec.bend_axis if mode_spec.bend_axis is not None else 1
        norm_axis = 1 - bend_axis
        u_b = (x_b, y_b)[norm_axis]
        u_cen = 0.5 * (u_b[1:] + u_b[:-1])
        u0 = u_b[len(u_b) // 2]
        # r/R ratio at primal (boundary) and dual (center) points
        rr_primal = np.clip(1.0 + (u_b[:-1] - u0) / R, 1e-3, None)
        rr_dual = np.clip(1.0 + (u_cen - u0) / R, 1e-3, None)

        def fac(vec, axis_):
            shape_ = [1, 1]
            shape_[axis_] = len(vec)
            return vec.reshape(shape_)

        if norm_axis == 0:
            # Ex/Hy/Hz at dual x; Ey/Ez/Hx at primal x
            eps_xx *= fac(rr_dual, 0)
            eps_yy *= fac(rr_primal, 0)
            eps_zz /= fac(rr_primal, 0)
            mu_xx = mu_xx * fac(rr_primal, 0)
            mu_yy = mu_yy * fac(rr_dual, 0)
            mu_zz = mu_zz / fac(rr_dual, 0)
        else:
            # Ey/Hx/Hz at dual y; Ex/Ez/Hy at primal y
            eps_xx *= fac(rr_primal, 1)
            eps_yy *= fac(rr_dual, 1)
            eps_zz /= fac(rr_primal, 1)
            mu_xx = mu_xx * fac(rr_dual, 1)
            mu_yy = mu_yy * fac(rr_primal, 1)
            mu_zz = mu_zz / fac(rr_dual, 1)

    # PEC representation: large negative eps -> set large value for stability
    for eps in (eps_xx, eps_yy, eps_zz):
        pec_mask = np.real(eps) <= 0.5 * pec_val
        eps[pec_mask] = -1e8  # strongly reflective

    # 1D stretch factors for mode-plane PML
    npml_x, npml_y = mode_spec.num_pml
    sx_b, sx_c = _pml_stretch(x_b, npml_x)
    sy_b, sy_c = _pml_stretch(y_b, npml_y)

    # single-cell axes (2D simulations) are uniform: d/daxis = 0, no walls
    uniform_x = nx == 1
    uniform_y = ny == 1
    if uniform_x:
        Dxf_1d = Dxb_1d = sp.csr_matrix((1, 1), dtype=complex)
    else:
        Dxf_1d, Dxb_1d = _derivative_mats(x_b, sx_b, sx_c)
    if uniform_y:
        Dyf_1d = Dyb_1d = sp.csr_matrix((1, 1), dtype=complex)
    else:
        Dyf_1d, Dyb_1d = _derivative_mats(y_b, sy_b, sy_c)

    Ix = sp.identity(nx, dtype=complex)
    Iy = sp.identity(ny, dtype=complex)
    # 2D operators with (x fastest? choose ordering: flatten (i_x, i_y) with
    # y fastest: index = ix*ny + iy)
    Dxf = sp.kron(Dxf_1d, Iy).tocsr()
    Dxb = sp.kron(Dxb_1d, Iy).tocsr()
    Dyf = sp.kron(Ix, Dyf_1d).tocsr()
    Dyb = sp.kron(Ix, Dyb_1d).tocsr()

    N = nx * ny
    eps_x_d = sp.diags(eps_xx.ravel())
    eps_y_d = sp.diags(eps_yy.ravel())

    # PEC walls at the plane edges: pin the tangential-E DOFs that lie ON a
    # wall. Ez sits at (x_bnd, y_bnd) -> pinned on both walls; Ex at
    # (x_cen, y_bnd) -> pinned at the y wall; Ey at (x_bnd, y_cen) -> pinned
    # at the x wall. (The opposite walls' points are not stored; the
    # zero-extension of the difference operators handles them.)
    mask_z = np.ones((nx, ny))
    mask_x = np.ones((nx, ny))
    mask_y = np.ones((nx, ny))
    if not uniform_x:
        mask_z[0, :] = 0.0
        mask_y[0, :] = 0.0
    if not uniform_y:
        mask_z[:, 0] = 0.0
        mask_x[:, 0] = 0.0
    Pz = sp.diags(mask_z.ravel())
    Px = sp.diags(mask_x.ravel())
    Py = sp.diags(mask_y.ravel())

    inv_eps_z = Pz @ sp.diags(1.0 / eps_zz.ravel())
    mu_x_d = sp.diags(mu_xx.ravel())
    mu_y_d = sp.diags(mu_yy.ravel())
    inv_mu_z = sp.diags(1.0 / mu_zz.ravel())

    ik0 = 1j * k0
    # A: i beta e_t = A h_t
    A11 = (1.0 / ik0) * (Dxf @ inv_eps_z @ Dyb)
    A12 = ik0 * mu_y_d - (1.0 / ik0) * (Dxf @ inv_eps_z @ Dxb)
    A21 = -ik0 * mu_x_d + (1.0 / ik0) * (Dyf @ inv_eps_z @ Dyb)
    A22 = -(1.0 / ik0) * (Dyf @ inv_eps_z @ Dxb)
    # B: i beta h_t = B e_t
    B11 = -(1.0 / ik0) * (Dxb @ inv_mu_z @ Dyf)
    B12 = -ik0 * eps_y_d + (1.0 / ik0) * (Dxb @ inv_mu_z @ Dxf)
    B21 = ik0 * eps_x_d - (1.0 / ik0) * (Dyb @ inv_mu_z @ Dyf)
    B22 = (1.0 / ik0) * (Dyb @ inv_mu_z @ Dxf)

    A = sp.bmat([[A11, A12], [A21, A22]]).tocsr()
    B = sp.bmat([[B11, B12], [B21, B22]]).tocsr()
    Pt = sp.bmat([[Px, None], [None, Py]]).tocsr()
    M = (Pt @ (-(A @ B)) @ Pt).tocsr()  # beta^2 eigenproblem on (Ex, Ey)

    # target effective index (shift) and the physical light line (filter)
    n_max = float(np.sqrt(np.max(np.real(
        np.stack([eps_xx, eps_yy, eps_zz])).clip(min=1.0))))
    if mode_spec.target_neff is not None:
        n_target = mode_spec.target_neff
    else:
        n_target = n_max
    sigma = (n_target * k0) ** 2

    # angled propagation: shear transform -> full-tensor eps/mu ->
    # 4N x 4N first-order eigenproblem (reference: transforms.py:74 +
    # solver.py solver_tensorial:594)
    theta = float(getattr(mode_spec, "angle_theta", 0.0) or 0.0)
    phi = float(getattr(mode_spec, "angle_phi", 0.0) or 0.0)

    # full-tensor cross-section (FullyAnisotropicMedium): 4N x 4N
    # tensorial eigenproblem on the 9-component eps (reference:
    # solver.py solver_tensorial:594 handles tensorial eps directly)
    if eps_full is not None:
        if theta != 0.0 or mode_spec.bend_radius is not None:
            raise NotImplementedError(
                "angled propagation / bends combined with fully "
                "anisotropic cross-sections are not supported")
        zero = np.zeros(nx * ny)
        eps_t = [[eps_full[3 * i + j].ravel() for j in range(3)]
                 for i in range(3)]
        mu_rows = (mu_xx.ravel(), mu_yy.ravel(), mu_zz.ravel())
        mu_t = [[mu_rows[i] if i == j else zero for j in range(3)]
                for i in range(3)]
        return _compute_modes_tensorial(
            eps_t, mu_t, Dxf, Dxb, Dyf, Dyb, k0, 1.0, n_target, n_max,
            num_modes, (mask_x, mask_y, mask_z), nx, ny, direction)

    if theta != 0.0:
        return _compute_modes_angled(
            eps_xx, eps_yy, eps_zz, mu_xx, mu_yy, mu_zz,
            Dxf, Dxb, Dyf, Dyb, k0, theta, phi, n_target, n_max,
            num_modes, (mask_x, mask_y, mask_z), nx, ny, direction)

    # request extra eigenpairs so spurious ones can be filtered out
    num_request = min(num_modes + 4, 2 * N - 2)
    vals = vecs = None
    if 2 * N <= DENSE_SIZE_CUTOFF:
        vals, vecs = np.linalg.eig(M.toarray())
    else:
        from .device_solver import use_filter_path

        if use_filter_path(2 * N, has_offaxis=False, device=device):
            # the device filter iterates on an UNSTRETCHED (sigma=0,
            # PEC-backed) real proxy whose top spectrum is exactly the
            # guided modes; stretched matrices would introduce spurious
            # top eigenvalues (complex CPML spectrum / metric mismatch)
            ones_x = np.ones(nx, dtype=complex)
            ones_y = np.ones(ny, dtype=complex)
            Dxf_p, Dxb_p = (Dxf_1d, Dxb_1d) if uniform_x else \
                _derivative_mats(x_b, ones_x, ones_x)
            Dyf_p, Dyb_p = (Dyf_1d, Dyb_1d) if uniform_y else \
                _derivative_mats(y_b, ones_y, ones_y)
            out = _eigs_filter_device(
                Dxf_p, Dxb_p, Dyf_p, Dyb_p,
                eps_xx, eps_yy, eps_zz, mu_xx, mu_yy, mu_zz,
                mask_x, mask_y, mask_z, k0, num_modes, n_max, M,
                sigma=sigma,
                true_is_real=_is_real_problem(
                    npml_x, npml_y, eps_xx, eps_yy, eps_zz),
                device=device)
            if out is not None:
                vals, vecs = out
        if vals is None:
            vals, vecs = _eigs_arpack_robust(
                M, N, num_modes, sigma, k0, n_max,
                real_problem=_is_real_problem(
                    npml_x, npml_y, eps_xx, eps_yy, eps_zz))

    beta = np.sqrt(vals.astype(complex))
    # choose forward-propagating branch: Re(beta) >= 0 (decaying for lossy)
    flip = np.real(beta) < 0
    beta[flip] = -beta[flip]
    n_eff_all = beta / k0

    real_problem = _is_real_problem(npml_x, npml_y, eps_xx, eps_yy, eps_zz)
    keep, order = _keep_physical(n_eff_all, n_max, real_problem)
    if len(keep) < num_modes:
        # pad with the largest remaining
        extras = [i for i in order if i not in keep]
        keep = keep + extras[: num_modes - len(keep)]
    keep = keep[:num_modes]

    n_complex = n_eff_all[keep]
    e_t = vecs[:, keep]  # (2N, M)

    fields = _reconstruct_fields(e_t, beta[keep], eps_zz, Dxf, Dxb, Dyf, Dyb,
                                 k0, nx, ny, mask_z,
                                 mu=(mu_xx, mu_yy, mu_zz))

    if direction == "-":
        # backward mode: conjugate-free transform E_t -> E_t, H_t -> -H_t,
        # Ez -> -Ez, Hz -> Hz
        fields["Hx"] = -fields["Hx"]
        fields["Hy"] = -fields["Hy"]
        fields["Ez"] = -fields["Ez"]

    return fields, n_complex


def _compute_modes_angled(eps_xx, eps_yy, eps_zz, mu_xx, mu_yy, mu_zz,
                          Dxf, Dxb, Dyf, Dyb, k0, theta, phi, n_target,
                          n_max, num_modes, masks, nx, ny, direction):
    """Angled-propagation solve via the shear transform + tensorial
    eigenproblem. Returns (fields, n_complex) with
    n_eff = beta' cos(theta)/k0 (the index along the tilted direction);
    in-plane field components are physical (the shear leaves tangential
    components unchanged — A^T acts only on the normal component)."""
    T = _shear_tensor(theta, phi)
    eps_rows = (eps_xx.ravel(), eps_yy.ravel(), eps_zz.ravel())
    mu_rows = (np.asarray(mu_xx).ravel(), np.asarray(mu_yy).ravel(),
               np.asarray(mu_zz).ravel())
    eps_t = [[T[i, j] * eps_rows[i] for j in range(3)] for i in range(3)]
    mu_t = [[T[i, j] * mu_rows[i] for j in range(3)] for i in range(3)]
    return _compute_modes_tensorial(
        eps_t, mu_t, Dxf, Dxb, Dyf, Dyb, k0, np.cos(theta), n_target,
        n_max, num_modes, masks, nx, ny, direction)


def _compute_modes_tensorial(eps_t, mu_t, Dxf, Dxb, Dyf, Dyb, k0, cos_t,
                             n_target, n_max, num_modes, masks, nx, ny,
                             direction):
    """Solve the 4N x 4N first-order tensorial eigenproblem and
    reconstruct fields; n_eff = beta cos_t / k0 (cos_t = 1 for a straight
    full-tensor solve, cos(theta) for the sheared angled solve)."""
    mask_x, mask_y, mask_z = masks
    sigma_beta = n_target * k0 / cos_t
    betas, vecs = _solver_tensorial(eps_t, mu_t, Dxf, Dxb, Dyf, Dyb, k0,
                                    (mask_x, mask_y, mask_z), num_modes,
                                    sigma_beta)
    n_eff_all = betas * cos_t / k0
    order = np.argsort(-np.real(n_eff_all))
    keep = []
    for idx in order:
        ne = n_eff_all[idx]
        if np.real(ne) > n_max * (1 + 1e-6) or np.real(ne) <= 0:
            continue
        keep.append(idx)
    if len(keep) < num_modes:
        extras = [i for i in order if i not in keep]
        keep = keep + extras[: num_modes - len(keep)]
    keep = keep[:num_modes]
    n_complex = n_eff_all[keep]

    N = nx * ny
    ik0 = 1j * k0
    inv_ezz = 1.0 / eps_t[2][2]
    inv_mzz = 1.0 / mu_t[2][2]
    fields = {name: np.zeros((nx, ny, len(keep)), dtype=complex)
              for name in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")}
    for mi, idx in enumerate(keep):
        v = vecs[:, idx]
        ex, ey, hx, hy = v[:N], v[N:2 * N], v[2 * N:3 * N], v[3 * N:]
        ez = inv_ezz * (-(Dxb @ hy - Dyb @ hx) / ik0
                        - eps_t[2][0] * ex - eps_t[2][1] * ey)
        ez = ez * mask_z.ravel()
        hz = inv_mzz * ((Dxf @ ey - Dyf @ ex) / ik0
                        - mu_t[2][0] * hx - mu_t[2][1] * hy)
        fields["Ex"][:, :, mi] = ex.reshape(nx, ny)
        fields["Ey"][:, :, mi] = ey.reshape(nx, ny)
        fields["Ez"][:, :, mi] = ez.reshape(nx, ny)
        fields["Hx"][:, :, mi] = hx.reshape(nx, ny) / ETA_0
        fields["Hy"][:, :, mi] = hy.reshape(nx, ny) / ETA_0
        fields["Hz"][:, :, mi] = hz.reshape(nx, ny) / ETA_0
    if direction == "-":
        fields["Hx"] = -fields["Hx"]
        fields["Hy"] = -fields["Hy"]
        fields["Ez"] = -fields["Ez"]
    return fields, n_complex


def _is_real_problem(npml_x, npml_y, eps_xx, eps_yy, eps_zz) -> bool:
    """Lossless, PML-free sections have a REAL operator whose physical
    modes are real; the non-normal discretization still carries spurious
    complex conjugate pairs that must be filtered out."""
    return (npml_x == 0 and npml_y == 0
            and all(np.allclose(np.imag(e), 0.0)
                    for e in (eps_xx, eps_yy, eps_zz)))


def _keep_physical(n_eff_all, n_max, real_problem):
    """Indices of physically-admissible modes, descending Re(n_eff).

    Rules: below the light line of the densest medium, forward-decaying,
    not a spurious complex pair (exactly real for real operators; for
    lossy/PML problems modes with |Im| comparable to |Re| are PML junk,
    not guided modes)."""
    order = np.argsort(-np.real(n_eff_all))
    keep = []
    for idx in order:
        ne = n_eff_all[idx]
        if np.real(ne) > n_max * (1 + 1e-6) or np.real(ne) <= 0:
            continue
        im_ratio = abs(np.imag(ne)) / max(abs(np.real(ne)), 1e-12)
        if real_problem and im_ratio > 1e-4:
            continue
        if im_ratio > 0.3:
            continue
        keep.append(idx)
    return keep, list(order)


def _eigs_arpack_robust(M, N, num_modes, sigma, k0, n_max, real_problem):
    """Shift-invert ARPACK with shift-walking retries.

    The initial shift sits at the top of the physical window
    ((n_target k0)^2, usually the material light line), where spurious
    complex pairs of the non-normal operator can be NEARER than the guided
    cluster and crowd the request. Retry with a larger request and a shift
    walked down toward the guided cluster until enough physical pairs
    converge. Deterministic v0 keeps which-pairs-converge reproducible.
    """
    sigma_try = sigma
    vals = vecs = None
    for attempt in range(4):
        k_req = min(num_modes + 4 + 6 * attempt, 2 * N - 2)
        v0 = np.random.default_rng(7 + attempt).standard_normal(2 * N)
        vals, vecs = spl.eigs(M, k=k_req, sigma=sigma_try, which="LM", v0=v0)
        beta = np.sqrt(vals.astype(complex))
        beta[np.real(beta) < 0] *= -1
        keep, _ = _keep_physical(beta / k0, n_max, real_problem)
        if len(keep) >= num_modes:
            return vals, vecs
        sigma_try = sigma_try * 0.8
        log.info("mode solver: only %d/%d physical pairs at shift %.3g; "
                 "retrying at %.3g" % (len(keep), num_modes, sigma, sigma_try))
    return vals, vecs


def _eigs_filter_device(Dxf_1d, Dxb_1d, Dyf_1d, Dyb_1d,
                        eps_xx, eps_yy, eps_zz, mu_xx, mu_yy, mu_zz,
                        mask_x, mask_y, mask_z, k0, num_modes, n_max, M,
                        sigma=None, true_is_real=True, device=None):
    """Device eigensolve of the diagonal-path beta^2 problem via the
    matrix-free Chebyshev filter (device_solver.py) on ``device``. Returns
    (vals, vecs) or None on non-convergence (caller falls back to ARPACK).

    PEC handling differs from the sparse path: instead of the ``eps=-1e8``
    penalty diagonal (which inflates the spectral radius by 1e8 and defeats
    polynomial filtering), E DOFs at PEC points are pinned to zero through
    the masks. The final Rayleigh-Ritz runs against the sparse penalty
    operator ``M``; pinned vectors are exactly in its nullspace at those
    DOFs, so the two representations agree on the kept modes.
    """
    from .device_solver import (assemble_real_proxy, chebyshev_eigs,
                                make_apply_real, solve_device)

    nx, ny = eps_xx.shape
    pec_x = np.real(eps_xx) <= -1e7
    pec_y = np.real(eps_yy) <= -1e7
    pec_z = np.real(eps_zz) <= -1e7
    mask_x_f = mask_x * (~pec_x)
    mask_y_f = mask_y * (~pec_y)
    inv_eps_z = np.where(pec_z, 0.0, mask_z / np.real(eps_zz))
    eps_x_f = np.where(pec_x, 1.0, np.real(eps_xx))
    eps_y_f = np.where(pec_y, 1.0, np.real(eps_yy))

    apply_real = make_apply_real(
        np.asarray(Dxf_1d.toarray()), np.asarray(Dxb_1d.toarray()),
        np.asarray(Dyf_1d.toarray()), np.asarray(Dyb_1d.toarray()),
        eps_x_f, eps_y_f, inv_eps_z,
        np.asarray(mu_xx), np.asarray(mu_yy), 1.0 / np.asarray(mu_zz),
        mask_x_f, mask_y_f, k0, device=solve_device(device))
    lam_hi = (n_max * k0) ** 2
    # radiation-continuum edge: the cladding light line, estimated from the
    # densest non-PEC material on the plane's outer frame (where radiation
    # modes live). Guided modes sit strictly above it.
    frame = np.zeros((nx, ny), dtype=bool)
    frame[0, :] = frame[-1, :] = frame[:, 0] = frame[:, -1] = True
    eps_frame = [np.real(e)[frame & ~p]
                 for e, p in ((eps_xx, pec_x), (eps_yy, pec_y))]
    eps_clad = max((float(v.max()) for v in eps_frame if v.size), default=1.0)
    lam_edge = eps_clad * k0**2
    m_proxy = assemble_real_proxy(
        Dxf_1d.toarray(), Dxb_1d.toarray(), Dyf_1d.toarray(),
        Dyb_1d.toarray(), eps_x_f, eps_y_f, inv_eps_z,
        mu_xx, mu_yy, 1.0 / np.asarray(mu_zz), mask_x_f, mask_y_f, k0)
    return chebyshev_eigs(apply_real, (nx, ny), num_modes, lam_hi, m_host=M,
                          lam_edge=lam_edge, m_proxy=m_proxy, sigma=sigma,
                          true_is_real=true_is_real)


def _shear_tensor(angle_theta: float, angle_phi: float) -> np.ndarray:
    """Constant tensor pattern T = A A^T of the angled-propagation shear.

    Reference behavior: plugins/mode/transforms.py angled_transform:74 —
    a coordinate shear maps the tilted propagation direction onto the new
    normal axis, turning a scalar permittivity into eps' = eps * T with

        A = [[1, 0, -tx], [0, 1, -ty], [0, 0, 1]],  det A = 1,
        tx = tan(theta) cos(phi), ty = tan(theta) sin(phi),

    identically for mu. The solved beta' is the propagation constant
    along the tilted direction scaled by 1/cos(theta):
    n_eff = beta' cos(theta) / k0.
    """
    tx = np.tan(angle_theta) * np.cos(angle_phi)
    ty = np.tan(angle_theta) * np.sin(angle_phi)
    A = np.array([[1.0, 0.0, -tx], [0.0, 1.0, -ty], [0.0, 0.0, 1.0]])
    return A @ A.T


def _solver_tensorial(eps_t, mu_t, Dxf, Dxb, Dyf, Dyb, k0: float,
                      masks, num_modes: int, sigma_beta: complex):
    """4N x 4N first-order tensorial eigenproblem i beta v = L v on
    v = (Ex, Ey, hx, hy) with full 3x3 eps and mu tensors
    (reference behavior: plugins/mode/solver.py solver_tensorial:594).

    Derivation (h = eta0 H, all D include the PML stretches): the z-rows
    of the two curl equations express Ez, hz in terms of the transverse
    fields; substituting into the transverse rows gives

      i b Ex =  i k0 (mu_yx hx + mu_yy hy + mu_yz hz) + Dxf Ez
      i b Ey = -i k0 (mu_xx hx + mu_xy hy + mu_xz hz) + Dyf Ez
      i b hx = -i k0 (eps_yx Ex + eps_yy Ey + eps_yz Ez) + Dxb hz
      i b hy = +i k0 (eps_xx Ex + eps_xy Ey + eps_xz Ez) + Dyb hz

      Ez = (1/eps_zz) [-(Dxb hy - Dyb hx)/(i k0) - eps_zx Ex - eps_zy Ey]
      hz = (1/mu_zz)  [ (Dxf Ey - Dyf Ex)/(i k0) - mu_zx hx - mu_zy hy]

    ``eps_t``/``mu_t``: (3, 3) nested lists of length-N complex vectors.
    ``masks``: (mask_x, mask_y, mask_z) PEC wall masks: tangential E rows
    are projected out on their walls, and Ez is pinned on the plane-edge
    rows through the masked 1/eps_zz (exactly as the diagonal path's
    ``inv_eps_z = Pz @ diags(1/eps_zz)``).
    Returns (betas, vecs (4N, M)).
    """
    N = Dxf.shape[0]
    ik0 = 1j * k0

    def dia(v):
        return sp.diags(np.asarray(v, dtype=complex))

    mask_x, mask_y, mask_z = masks
    Pz = sp.diags(np.asarray(mask_z, dtype=complex).ravel())
    inv_ezz = Pz @ dia(1.0 / eps_t[2][2])
    inv_mzz = dia(1.0 / mu_t[2][2])
    # Ez = Ce_x Ex + Ce_y Ey + Ch_x hx + Ch_y hy
    Ce_x = -inv_ezz @ dia(eps_t[2][0])
    Ce_y = -inv_ezz @ dia(eps_t[2][1])
    Ch_x = (1.0 / ik0) * (inv_ezz @ Dyb)
    Ch_y = -(1.0 / ik0) * (inv_ezz @ Dxb)
    # hz = De_x Ex + De_y Ey + Dh_x hx + Dh_y hy
    De_x = -(1.0 / ik0) * (inv_mzz @ Dyf)
    De_y = (1.0 / ik0) * (inv_mzz @ Dxf)
    Dh_x = -inv_mzz @ dia(mu_t[2][0])
    Dh_y = -inv_mzz @ dia(mu_t[2][1])

    # row 1: i b Ex
    L11 = ik0 * dia(mu_t[1][2]) @ De_x + Dxf @ Ce_x
    L12 = ik0 * dia(mu_t[1][2]) @ De_y + Dxf @ Ce_y
    L13 = ik0 * (dia(mu_t[1][0]) + dia(mu_t[1][2]) @ Dh_x) + Dxf @ Ch_x
    L14 = ik0 * (dia(mu_t[1][1]) + dia(mu_t[1][2]) @ Dh_y) + Dxf @ Ch_y
    # row 2: i b Ey
    L21 = -ik0 * dia(mu_t[0][2]) @ De_x + Dyf @ Ce_x
    L22 = -ik0 * dia(mu_t[0][2]) @ De_y + Dyf @ Ce_y
    L23 = -ik0 * (dia(mu_t[0][0]) + dia(mu_t[0][2]) @ Dh_x) + Dyf @ Ch_x
    L24 = -ik0 * (dia(mu_t[0][1]) + dia(mu_t[0][2]) @ Dh_y) + Dyf @ Ch_y
    # row 3: i b hx
    L31 = -ik0 * (dia(eps_t[1][0]) + dia(eps_t[1][2]) @ Ce_x) + Dxb @ De_x
    L32 = -ik0 * (dia(eps_t[1][1]) + dia(eps_t[1][2]) @ Ce_y) + Dxb @ De_y
    L33 = -ik0 * dia(eps_t[1][2]) @ Ch_x + Dxb @ Dh_x
    L34 = -ik0 * dia(eps_t[1][2]) @ Ch_y + Dxb @ Dh_y
    # row 4: i b hy
    L41 = ik0 * (dia(eps_t[0][0]) + dia(eps_t[0][2]) @ Ce_x) + Dyb @ De_x
    L42 = ik0 * (dia(eps_t[0][1]) + dia(eps_t[0][2]) @ Ce_y) + Dyb @ De_y
    L43 = ik0 * dia(eps_t[0][2]) @ Ch_x + Dyb @ Dh_x
    L44 = ik0 * dia(eps_t[0][2]) @ Ch_y + Dyb @ Dh_y

    Px = sp.diags(mask_x.ravel().astype(complex))
    Py = sp.diags(mask_y.ravel().astype(complex))
    I = sp.identity(N, dtype=complex)
    P = sp.block_diag([Px, Py, I, I]).tocsr()
    L = sp.bmat([[L11, L12, L13, L14],
                 [L21, L22, L23, L24],
                 [L31, L32, L33, L34],
                 [L41, L42, L43, L44]]).tocsr()
    L = (P @ L @ P).tocsr()

    # the 4N first-order operator conditions worse under shift-invert
    # than the 2N beta^2 form: prefer dense up to a larger cutoff and give
    # ARPACK a wide Krylov basis
    if 4 * N <= 4 * DENSE_SIZE_CUTOFF:
        vals, vecs = np.linalg.eig(L.toarray())
    else:
        k_req = min(4 * num_modes + 8, 4 * N - 2)
        vals, vecs = spl.eigs(L, k=k_req, sigma=1j * sigma_beta,
                              which="LM", ncv=min(max(6 * k_req, 60), 4 * N),
                              maxiter=80 * N, tol=1e-9)
    betas = vals / 1j
    return betas, vecs


def _pml_stretch(bounds: np.ndarray, num_pml: int):
    """1/s stretch factor arrays at boundary-located and center-located points."""
    n = len(bounds) - 1
    centers = 0.5 * (bounds[1:] + bounds[:-1])
    s_bnd = np.ones(n, dtype=complex)
    s_cen = np.ones(n, dtype=complex)
    npml = min(num_pml, max(n // 2 - 1, 0))
    if npml <= 0:
        return s_bnd, s_cen
    lo_int = bounds[npml]
    hi_int = bounds[n - npml]
    w_lo = max(lo_int - bounds[0], fp_eps)
    w_hi = max(bounds[-1] - hi_int, fp_eps)

    def stretch(pts):
        d = np.zeros(len(pts))
        d = np.where(pts < lo_int, (lo_int - pts) / w_lo, d)
        d = np.where(pts > hi_int, (pts - hi_int) / w_hi, d)
        sigma = MODE_PML_SIGMA_MAX * np.clip(d, 0, 1) ** MODE_PML_ORDER
        return 1.0 + 1j * sigma

    return stretch(bounds[:-1]), stretch(centers)


def _reconstruct_fields(e_t, betas, eps_zz, Dxf, Dxb, Dyf, Dyb, k0, nx, ny,
                        mask_z, mu=None):
    """All six field components from transverse E eigenvectors (diagonal mu
    support for the bend transform)."""
    N = nx * ny
    num_modes = e_t.shape[1]
    fields = {name: np.zeros((nx, ny, num_modes), dtype=complex)
              for name in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")}
    ik0 = 1j * k0
    mz = mask_z.ravel()
    Pz = sp.diags(mz)
    if mu is None:
        inv_mux = inv_muy = inv_muz = np.ones(N)
    else:
        inv_mux = 1.0 / mu[0].ravel()
        inv_muy = 1.0 / mu[1].ravel()
        inv_muz = 1.0 / mu[2].ravel()
    imx_d = sp.diags(inv_mux)
    imy_d = sp.diags(inv_muy)
    for m in range(num_modes):
        ex = e_t[:N, m]
        ey = e_t[N:, m]
        beta = betas[m]
        # hz = (Dxf Ey - Dyf Ex)/(i k0 mu_z)
        hz = inv_muz * (Dxf @ ey - Dyf @ ex) / ik0
        # Ez from the curl equations with h_t eliminated:
        #   -i k0 eps_z Ez = Dxb hy - Dyb hx
        #   i k0 mu_x hx = Dyf Ez - i beta ey
        #   i k0 mu_y hy = i beta ex - Dxf Ez
        # => (-k0^2 eps_z + Dxb (1/mu_y) Dxf + Dyb (1/mu_x) Dyf) Ez
        #      = i beta (Dxb (1/mu_y) ex + Dyb (1/mu_x) ey)
        # with Ez pinned to zero on the PEC wall rows
        lhs = (sp.diags(-(k0**2) * eps_zz.ravel())
               + Dxb @ imy_d @ Dxf + Dyb @ imx_d @ Dyf)
        lhs = Pz @ lhs @ Pz + sp.diags(1.0 - mz)
        rhs = mz * (1j * beta * (Dxb @ (inv_muy * ex) + Dyb @ (inv_mux * ey)))
        ez = spl.spsolve(lhs.tocsc(), rhs)
        hx = inv_mux * (Dyf @ ez - 1j * beta * ey) / ik0
        hy = inv_muy * (1j * beta * ex - Dxf @ ez) / ik0
        fields["Ex"][:, :, m] = ex.reshape(nx, ny)
        fields["Ey"][:, :, m] = ey.reshape(nx, ny)
        fields["Ez"][:, :, m] = ez.reshape(nx, ny)
        # h = eta0 H -> H = h / eta0
        fields["Hx"][:, :, m] = hx.reshape(nx, ny) / ETA_0
        fields["Hy"][:, :, m] = hy.reshape(nx, ny) / ETA_0
        fields["Hz"][:, :, m] = hz.reshape(nx, ny) / ETA_0
    return fields
