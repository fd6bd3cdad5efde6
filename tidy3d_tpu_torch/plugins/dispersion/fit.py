"""Dispersion fitting of refractive-index data to dispersive medium models.

Behavioral model: the upstream tidy3d plugins/dispersion/fit.py
(DispersionFitter:26 — nk data loading and random-restart least-squares
fitting of pole models).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import pydantic
from scipy.optimize import least_squares

from ...components.base import Tidy3dBaseModel, cached_property
from ...components.medium import PoleResidue
from ...components.types import ArrayFloat1D
from ...constants import C_0
from ...exceptions import SetupError, ValidationError
from ...log import log


class DispersionFitter(Tidy3dBaseModel):
    """Fits (wavelength, n, k) data with a PoleResidue dispersion model."""

    wvl_um: ArrayFloat1D = pydantic.Field(..., title="Wavelengths [um]")
    n_data: ArrayFloat1D = pydantic.Field(..., title="Real part of the index")
    k_data: Optional[ArrayFloat1D] = pydantic.Field(None, title="Imaginary part")
    wvl_range: Tuple[Optional[float], Optional[float]] = pydantic.Field(
        (None, None), title="Wavelength range for fitting")

    @pydantic.model_validator(mode="after")
    def _check_lengths(self):
        if len(self.wvl_um) != len(self.n_data):
            raise ValidationError("wvl_um and n_data must have equal length")
        if self.k_data is not None and len(self.k_data) != len(self.wvl_um):
            raise ValidationError("wvl_um and k_data must have equal length")
        return self

    @classmethod
    def from_file(cls, fname: str, **loadtxt_kwargs) -> "DispersionFitter":
        """Load nk data from csv/txt file with columns wvl, n[, k]."""
        data = np.loadtxt(fname, **loadtxt_kwargs)
        if data.shape[1] < 2:
            raise SetupError("data file must have at least 2 columns (wvl, n)")
        k = data[:, 2] if data.shape[1] > 2 else None
        return cls(wvl_um=data[:, 0], n_data=data[:, 1], k_data=k)

    from_url = from_file  # offline environment: same loader for local paths

    @cached_property
    def _filtered(self):
        wvl = np.asarray(self.wvl_um, dtype=float)
        n = np.asarray(self.n_data, dtype=float)
        k = np.asarray(self.k_data, dtype=float) if self.k_data is not None \
            else np.zeros_like(n)
        lo = self.wvl_range[0] if self.wvl_range[0] is not None else -np.inf
        hi = self.wvl_range[1] if self.wvl_range[1] is not None else np.inf
        mask = (wvl >= lo) & (wvl <= hi)
        return wvl[mask], n[mask], k[mask]

    @cached_property
    def freqs(self) -> np.ndarray:
        wvl, _, _ = self._filtered
        return C_0 / wvl

    @cached_property
    def eps_data(self) -> np.ndarray:
        _, n, k = self._filtered
        return (n + 1j * k) ** 2

    @property
    def lossy(self) -> bool:
        _, _, k = self._filtered
        return bool(np.any(k != 0))

    # ------------------------------------------------------------------ #
    # fitting
    # ------------------------------------------------------------------ #

    def fit(self, num_poles: int = 1, num_tries: int = 50,
            tolerance_rms: float = 1e-2, guess=None) -> Tuple[PoleResidue, float]:
        """Random-restart nonlinear least squares over a pole-residue model."""
        rng = np.random.default_rng(0)
        omega = 2 * np.pi * self.freqs
        eps_target = self.eps_data
        w_scale = omega.mean()

        def unpack(x):
            eps_inf = 1.0 + x[0] ** 2
            poles = []
            for p in range(num_poles):
                ar, ai, cr, ci_ = x[1 + 4 * p: 5 + 4 * p]
                poles.append((-(ar ** 2) + 1j * ai * w_scale,
                              (cr + 1j * ci_) * w_scale))
            return eps_inf, poles

        def residual(x):
            eps_inf, poles = unpack(x)
            eps = PoleResidue._eps_model(eps_inf, poles, self.freqs)
            r = eps - eps_target
            return np.concatenate([r.real, r.imag])

        best = None
        best_rms = np.inf
        for _ in range(num_tries):
            x0 = rng.uniform(-1, 1, 1 + 4 * num_poles)
            try:
                res = least_squares(residual, x0, max_nfev=600)
            except Exception:
                continue
            rms = np.sqrt(np.mean(res.fun ** 2))
            if rms < best_rms:
                best_rms = rms
                best = res.x
            if best_rms < tolerance_rms:
                break
        if best is None:
            raise SetupError("dispersion fit failed")
        eps_inf, poles = unpack(best)
        medium = PoleResidue(
            eps_inf=float(eps_inf), poles=tuple(poles),
            frequency_range=(float(self.freqs.min()), float(self.freqs.max())),
        )
        if best_rms > tolerance_rms:
            log.warning(f"dispersion fit rms {best_rms:.2e} above tolerance "
                        f"{tolerance_rms:.2e}")
        return medium, float(best_rms)

    def plot(self, medium: PoleResidue = None, ax=None):
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        wvl, n, k = self._filtered
        ax.scatter(wvl, n, label="n data", s=8)
        ax.scatter(wvl, k, label="k data", s=8)
        if medium is not None:
            eps = medium.eps_model(self.freqs)
            n_fit, k_fit = medium.eps_complex_to_nk(eps)
            ax.plot(wvl, n_fit, label="n fit")
            ax.plot(wvl, k_fit, label="k fit")
        ax.set_xlabel("wavelength (um)")
        ax.legend()
        return ax


class StableDispersionFitter(DispersionFitter):
    """Alias retained for API parity (the reference's server-side fitter);
    locally identical to FastDispersionFitter."""

    def fit(self, num_poles: int = 1, num_tries: int = 50,
            tolerance_rms: float = 1e-2, guess=None):
        from .fit_fast import FastDispersionFitter

        fitter = FastDispersionFitter(wvl_um=self.wvl_um, n_data=self.n_data,
                                      k_data=self.k_data, wvl_range=self.wvl_range)
        return fitter.fit(max_num_poles=max(num_poles, 2),
                          tolerance_rms=tolerance_rms)
