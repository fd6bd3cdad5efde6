"""CPML (complex frequency-shifted PML) coefficient computation.

Profiles follow the reference's parameterization
(/root/reference/tidy3d/components/boundary.py:195-260): polynomial sigma and
kappa grading with sigma/alpha expressed in units of ``2*EPSILON_0/dt`` — so
the recursive-convolution coefficients b = exp(-(sigma/kappa + alpha) dt/eps0)
become dt-independent:

    b = exp(-2 (sigma_n / kappa + alpha_n))
    c = sigma_n / (sigma_n kappa + kappa^2 alpha_n) * (b - 1)

The update per PML slab (Roden & Gedney 2000):

    psi^n = b psi^{n-1} + c * dF/dw
    curl_term = dF/dw / kappa + psi
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..components.boundary import AbsorberParams, PMLParams


@dataclass(frozen=True)
class PmlCoeffs1D:
    """Per-point CPML coefficients along one axis for one field family.

    Arrays have the length of the number of field points along the axis;
    coefficients are identity (kappa=1, b=0, c=0) outside the PML slabs.
    """

    inv_kappa: np.ndarray  # 1/kappa profile (1 outside PML)
    b: np.ndarray          # recursion coefficient (0 outside PML)
    c: np.ndarray          # source coefficient (0 outside PML)
    n_lo: int              # number of PML points on the low side
    n_hi: int              # number of PML points on the high side


def _profiles(dists: np.ndarray, params: PMLParams) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """sigma, kappa, alpha profiles at normalized depths ``dists`` in [0, 1]
    (0 = inner PML edge, 1 = outer edge)."""
    sigma = params.sigma_min + (params.sigma_max - params.sigma_min) * dists**params.sigma_order
    if isinstance(params, PMLParams):
        kappa = params.kappa_min + (params.kappa_max - params.kappa_min) * (
            dists**params.kappa_order
        )
        kappa = np.maximum(kappa, 1.0)
        # alpha decreases from the inner edge outward (CFS term)
        alpha = params.alpha_min + (params.alpha_max - params.alpha_min) * (
            (1.0 - dists)**params.alpha_order
        )
    else:
        kappa = np.ones_like(dists)
        alpha = np.zeros_like(dists)
    return sigma, kappa, alpha


def _bc_coeffs(sigma: np.ndarray, kappa: np.ndarray, alpha: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Recursion coefficients from normalized (2 eps0/dt units) profiles."""
    b = np.exp(-2.0 * (sigma / kappa + alpha))
    denom = sigma * kappa + kappa**2 * alpha
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(denom > 0, sigma / np.where(denom > 0, denom, 1.0) * (b - 1.0), 0.0)
    return b, c


def make_pml_coeffs(
    coords: np.ndarray,
    bounds: np.ndarray,
    num_lo: int,
    num_hi: int,
    params_lo: Optional[PMLParams],
    params_hi: Optional[PMLParams],
    dual: bool,
) -> PmlCoeffs1D:
    """CPML coefficients for field points along one axis.

    coords : positions of the field points (length N). For the E-update
        (derivatives of H at E points) pass the boundary positions
        (``dual=True``); for the H-update pass cell centers.
    bounds : the N+1 cell boundary coordinates — they define the PHYSICAL PML
        interval [wall, interface] shared by both staggered families. The
        profile must be sampled at each family's true positions within that
        common interval (a half-cell-misaligned profile between E and H points
        is a classic CPML reflection-floor killer).
    num_lo/num_hi : number of PML *cells* on each side.
    """
    n = len(coords)
    inv_kappa = np.ones(n)
    b = np.zeros(n)
    c = np.zeros(n)
    bounds = np.asarray(bounds)

    if num_lo > 0 and params_lo is not None and n > 2 * num_lo:
        wall = bounds[0]
        interface = bounds[num_lo]
        width = interface - wall
        if width > 0:
            n_pts = num_lo + 1
            pts = coords[:n_pts]
            dists = np.clip((interface - pts) / width, 0.0, 1.0)
            sigma, kappa, alpha = _profiles(dists, params_lo)
            bb, cc = _bc_coeffs(sigma, kappa, alpha)
            inv_kappa[:n_pts] = 1.0 / kappa
            b[:n_pts] = bb
            c[:n_pts] = cc

    if num_hi > 0 and params_hi is not None and n > 2 * num_hi:
        wall = bounds[-1]
        interface = bounds[len(bounds) - 1 - num_hi]
        width = wall - interface
        if width > 0:
            n_pts = num_hi + 1
            pts = coords[n - n_pts:]
            dists = np.clip((pts - interface) / width, 0.0, 1.0)
            sigma, kappa, alpha = _profiles(dists, params_hi)
            bb, cc = _bc_coeffs(sigma, kappa, alpha)
            inv_kappa[n - n_pts:] = 1.0 / kappa
            b[n - n_pts:] = bb
            c[n - n_pts:] = cc

    return PmlCoeffs1D(inv_kappa=inv_kappa, b=b, c=c, n_lo=num_lo, n_hi=num_hi)


def absorber_sigma_profile(
    coords: np.ndarray, num_lo: int, num_hi: int,
    params_lo: Optional[AbsorberParams], params_hi: Optional[AbsorberParams],
    dt: float,
) -> np.ndarray:
    """Adiabatic absorber conductivity profile [S/um-equivalent, i.e. actual
    sigma/eps0 rate] at the given field points. Applied as both electric and
    magnetic conductivity for an impedance-matched absorber."""
    from ..constants import EPSILON_0

    n = len(coords)
    sigma = np.zeros(n)
    if num_lo > 0 and params_lo is not None and n > num_lo:
        edge = coords[min(num_lo, n - 1)]
        width = max(edge - coords[0], 1e-30)
        pts = coords[: num_lo + 1]
        dists = np.clip((edge - pts) / width, 0.0, 1.0)
        sigma[: num_lo + 1] = np.maximum(
            sigma[: num_lo + 1],
            params_lo.sigma_min + (params_lo.sigma_max - params_lo.sigma_min)
            * dists**params_lo.sigma_order,
        )
    if num_hi > 0 and params_hi is not None and n > num_hi:
        edge = coords[max(n - 1 - num_hi, 0)]
        width = max(coords[-1] - edge, 1e-30)
        pts = coords[n - 1 - num_hi:]
        dists = np.clip((pts - edge) / width, 0.0, 1.0)
        sigma[n - 1 - num_hi:] = np.maximum(
            sigma[n - 1 - num_hi:],
            params_hi.sigma_min + (params_hi.sigma_max - params_hi.sigma_min)
            * dists**params_hi.sigma_order,
        )
    # convert normalized (2 eps0/dt) units to a rate sigma/eps0 [1/s]
    return sigma * 2.0 / dt
