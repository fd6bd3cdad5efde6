"""Fast dispersion fitting via relaxed vector fitting.

Behavioral model: the upstream tidy3d plugins/dispersion/fit_fast.py
(FastDispersionFitter:651 — relaxed vector fitting, Gustavsen 1999/2006, with
stability enforcement). Implemented from the published algorithm: iterative
pole relocation by linear least squares on

    sigma(s) eps(s) ~ eps_inf + sum_k c_k / (s - p_k),
    sigma(s) = 1 + sum_k ~c_k / (s - p_k),

with new poles = zeros of sigma (eigenvalue relocation), poles flipped into
the left half plane for stability/causality.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ...components.medium import PoleResidue
from ...constants import C_0
from ...exceptions import SetupError
from ...log import log
from .fit import DispersionFitter

# number of pole-relocation iterations
N_ITERS = 30


class FastDispersionFitter(DispersionFitter):
    """Vector-fitting dispersion fitter."""

    def fit(self, min_num_poles: int = 1, max_num_poles: int = 5,
            eps_inf: float = None, tolerance_rms: float = 1e-3,
            advanced_param=None) -> Tuple[PoleResidue, float]:
        omega = 2 * np.pi * self.freqs
        s = -1j * omega  # Laplace variable consistent with jw + a form
        eps_target = self.eps_data

        best_medium, best_rms = None, np.inf
        for num_poles in range(min_num_poles, max_num_poles + 1):
            try:
                medium, rms = self._fit_fixed_poles(num_poles, eps_inf)
            except Exception as exc:  # noqa: BLE001
                log.warning(f"vector fitting with {num_poles} poles failed: {exc}")
                continue
            if rms < best_rms:
                best_medium, best_rms = medium, rms
            if best_rms <= tolerance_rms:
                break
        if best_medium is None:
            raise SetupError("vector fitting failed for all pole counts")
        if best_rms > tolerance_rms:
            log.warning(f"warning: dispersion fit rms {best_rms:.2e} above "
                        f"tolerance {tolerance_rms:.2e}")
        return best_medium, float(best_rms)

    def _fit_fixed_poles(self, num_poles: int, eps_inf_fixed) -> Tuple[PoleResidue, float]:
        omega = 2 * np.pi * self.freqs
        eps_target = self.eps_data
        w_min, w_max = omega.min(), omega.max()

        # initial poles spaced across the band. NOTE the convention: with
        # fields ~ e^{-iwt}, s = jw corresponds to -d/dt, so STABLE poles have
        # POSITIVE real part in this s-plane (a = -p then satisfies the
        # causality condition Re(a) <= 0 of PoleResidue).
        beta = np.linspace(w_min, w_max, num_poles) if num_poles > 1 else \
            np.array([(w_min + w_max) / 2])
        poles = (beta / 100 + 1j * beta).astype(complex)

        s = 1j * omega  # evaluate at s = j omega

        def basis(poles_):
            """Partial-fraction basis for conjugate pole pairs (real output)."""
            cols = []
            for p in poles_:
                cols.append(1.0 / (s - p) + 1.0 / (s - np.conj(p)))
                cols.append(1j / (s - p) - 1j / (s - np.conj(p)))
            return np.stack(cols, axis=1)

        for _ in range(N_ITERS):
            Phi = basis(poles)
            ncols = Phi.shape[1]
            # unknowns: eps_inf (re), residue coeffs (2 per pole), sigma coeffs
            # classic VF: sigma(s) = 1 + sum c~ phi;  sigma*eps ~ eps_inf + sum c phi
            A_top = np.concatenate(
                [np.ones((len(s), 1)), Phi, -eps_target[:, None] * Phi], axis=1)
            A = np.concatenate([A_top.real, A_top.imag], axis=0)
            b = np.concatenate([eps_target.real, eps_target.imag])
            x = _scaled_lstsq(A, b)
            sigma_c = x[1 + ncols:]
            # new poles = eigenvalues of (A_p - b_p c_sigma^T)
            poles_new = _relocate_poles(poles, sigma_c)
            # flip into the stable (right) half plane of this s-convention
            poles_new = np.where(poles_new.real < 0,
                                 -poles_new.real + 1j * poles_new.imag, poles_new)
            poles = poles_new

        # final residue fit with fixed poles
        Phi = basis(poles)
        A = np.concatenate([np.ones((len(s), 1)), Phi], axis=1)
        A_ri = np.concatenate([A.real, A.imag], axis=0)
        b = np.concatenate([eps_target.real, eps_target.imag])
        if eps_inf_fixed is not None:
            b = b - eps_inf_fixed * np.concatenate(
                [np.ones(len(s)), np.zeros(len(s))])
            A_ri = A_ri[:, 1:]
            x = _scaled_lstsq(A_ri, b)
            eps_inf_val = eps_inf_fixed
            coeffs = x
        else:
            x = _scaled_lstsq(A_ri, b)
            eps_inf_val = max(x[0], 1.0)
            coeffs = x[1:]

        # convert (cr, ci) pairs into tidy3d (a, c) convention:
        # eps = eps_inf + sum [r/(s-p) + r*/(s-p*)]
        #     = eps_inf - sum [c/(jw+a) + c*/(jw+a*)] with a = -p, c = -r
        pole_list = []
        for idx, p in enumerate(poles):
            r = coeffs[2 * idx] + 1j * coeffs[2 * idx + 1]
            # eps = eps_inf + sum [r/(s-p) + c.c.] = eps_inf - sum [c/(jw+a) + c.c.]
            # with a = -p (Re(a) <= 0 by the stability flip above), c = -r
            pole_list.append((-p, -r))

        medium = PoleResidue(
            eps_inf=float(eps_inf_val), poles=tuple(pole_list),
            frequency_range=(float(self.freqs.min()), float(self.freqs.max())),
            allow_gain=False if not self.lossy else False,
        )
        eps_fit = medium.eps_model(self.freqs)
        rms = float(np.sqrt(np.mean(np.abs(eps_fit - eps_target) ** 2)))
        return medium, rms


def _scaled_lstsq(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Least squares with per-column normalization (the partial-fraction basis
    columns are ~1/omega ~ 1e-15 and would be truncated by rcond otherwise)."""
    norms = np.linalg.norm(A, axis=0)
    norms = np.where(norms > 0, norms, 1.0)
    x, *_ = np.linalg.lstsq(A / norms[None, :], b, rcond=None)
    return x / norms


def _relocate_poles(poles: np.ndarray, sigma_c: np.ndarray) -> np.ndarray:
    """Zeros of sigma(s) = 1 + sum_k [~c/(s-p) + ~c*/(s-p*)] via the
    companion eigenvalue formulation (real-arithmetic conjugate-pair form)."""
    n = len(poles)
    # real block-diagonal A matrix for conjugate pairs
    A = np.zeros((2 * n, 2 * n))
    bvec = np.zeros(2 * n)
    cvec = np.zeros(2 * n)
    for i, p in enumerate(poles):
        pr, pi = p.real, p.imag
        A[2 * i, 2 * i] = pr
        A[2 * i, 2 * i + 1] = pi
        A[2 * i + 1, 2 * i] = -pi
        A[2 * i + 1, 2 * i + 1] = pr
        bvec[2 * i] = 2.0
        bvec[2 * i + 1] = 0.0
        cvec[2 * i] = sigma_c[2 * i]
        cvec[2 * i + 1] = sigma_c[2 * i + 1]
    H = A - np.outer(bvec, cvec)
    eig = np.linalg.eigvals(H)
    # keep one of each conjugate pair (positive imaginary part preferred)
    eig_pos = eig[eig.imag >= 0]
    if len(eig_pos) < n:
        eig_sorted = eig[np.argsort(-eig.imag)]
        eig_pos = eig_sorted[:n]
    return eig_pos[:n]
