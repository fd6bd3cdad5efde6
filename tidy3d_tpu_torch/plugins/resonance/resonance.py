"""Resonance finder: harmonic inversion of time signals.

Behavioral model: tidy3d v2.7.6 plugins/resonance/resonance.py
(ResonanceFinder:39 — Mandelshtam-Taylor filter-diagonalization; frequencies,
decay rates, Q factors, amplitudes, phases, error estimates from
FieldTimeData). This implementation uses the standard matrix-pencil/ESPRIT
harmonic inversion, which solves the same exponential-fitting problem with
robust linear algebra.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import pydantic
import scipy.linalg as la

from ...components.base import Tidy3dBaseModel
from ...components.data.data_array import DataArray
from ...components.data.monitor_data import FieldTimeData
from ...components.types import ArrayComplex1D, FreqBound
from ...exceptions import SetupError, ValidationError
from ...log import log


class ResonanceData(Tidy3dBaseModel):
    """Data on a single resonance."""

    decay: float = pydantic.Field(..., title="Decay rate")
    Q: float = pydantic.Field(..., title="Q factor")
    amplitude: complex = pydantic.Field(..., title="Amplitude")
    phase: float = pydantic.Field(..., title="Phase")
    error: float = pydantic.Field(..., title="Estimation error")


class ResonanceFinder(Tidy3dBaseModel):
    """Finds resonances from time-domain field data."""

    freq_window: FreqBound = pydantic.Field(
        ..., title="Window", description="(fmin, fmax) of the search window [Hz]."
    )
    init_num_freqs: pydantic.PositiveInt = pydantic.Field(
        200, title="Initial number of frequencies",
        description="Upper bound on the model order of the harmonic inversion.",
    )
    rcond: float = pydantic.Field(1e-4, title="Singular value cutoff")

    @pydantic.model_validator(mode="after")
    def _check_window(self):
        if self.freq_window[1] < self.freq_window[0]:
            raise ValidationError("freq_window must be (fmin, fmax)")
        return self

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #

    def run(self, signals: Union[FieldTimeData, Tuple[FieldTimeData, ...]]):
        """Find resonances in FieldTimeData (all components summed)."""
        if not isinstance(signals, (tuple, list)):
            signals = (signals,)
        total = None
        t = None
        for sig_data in signals:
            for name, arr in sig_data.field_components.items():
                vals = arr.values
                # sum over spatial points -> one time series
                series = vals.reshape(-1, vals.shape[-1]).sum(axis=0)
                total = series if total is None else total + series
                t = np.asarray(arr.coords["t"], dtype=float)
        return self.run_raw_signal(total, t[1] - t[0])

    def run_scalar_field_time(self, signal) -> "DataArray":
        t = np.asarray(signal.coords["t"], dtype=float)
        series = signal.values.reshape(-1, len(t)).sum(axis=0)
        return self.run_raw_signal(series, t[1] - t[0])

    def run_raw_signal(self, signal: np.ndarray, time_step: float) -> DataArray:
        """Harmonic inversion of a 1D (real or complex) time series.

        Returns a DataArray over 'freq' with fields decay/Q/amplitude/phase/
        error stacked along a second dim, mirroring the reference's xr.Dataset.
        """
        signal = np.asarray(signal)
        if np.isrealobj(signal):
            # analytic signal carries e^{+iwt}; conjugate into the e^{-iwt}
            # convention used throughout the framework
            signal = np.conj(_analytic_signal(signal))
        freqs, decays, amps = _matrix_pencil(
            signal, time_step, max_order=min(self.init_num_freqs,
                                             len(signal) // 3),
            rcond=self.rcond,
        )
        fmin, fmax = self.freq_window
        keep = (freqs >= fmin) & (freqs <= fmax) & (decays >= 0)
        freqs, decays, amps = freqs[keep], decays[keep], amps[keep]
        order = np.argsort(freqs)
        freqs, decays, amps = freqs[order], decays[order], amps[order]

        # error estimate: residual of the reconstructed signal
        t = np.arange(len(signal)) * time_step
        recon = np.zeros(len(signal), dtype=complex)
        for f, d, a in zip(freqs, decays, amps):
            recon += a * np.exp((-1j * 2 * np.pi * f - d) * t)
        resid = np.linalg.norm(recon - signal) / max(np.linalg.norm(signal), 1e-300)

        q = np.pi * np.abs(freqs) / np.where(decays > 0, decays, np.inf)
        data = np.stack([
            decays, q, np.abs(amps), np.angle(amps),
            np.full(len(freqs), resid),
        ])
        return DataArray(
            data.T, coords={"freq": freqs,
                            "field": np.array(["decay", "Q", "amplitude",
                                               "phase", "error"])},
            dims=("freq", "field"),
        )


# --------------------------------------------------------------------------- #
# numerics
# --------------------------------------------------------------------------- #


def _analytic_signal(x: np.ndarray) -> np.ndarray:
    """Analytic signal via FFT (positive-frequency part), without scipy.signal."""
    n = len(x)
    X = np.fft.fft(x)
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1
        h[1:n // 2] = 2
    else:
        h[0] = 1
        h[1:(n + 1) // 2] = 2
    return np.fft.ifft(X * h)


def _matrix_pencil(signal: np.ndarray, dt: float, max_order: int, rcond: float
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Matrix-pencil harmonic inversion: signal ~ sum_k a_k z_k^n with
    z_k = exp((-i 2 pi f_k - d_k) dt)."""
    n = len(signal)
    L = min(max(n // 3, max_order), n - 2)
    # Hankel matrices
    Y = la.hankel(signal[: n - L], signal[n - L - 1:])
    Y0 = Y[:, :-1]
    Y1 = Y[:, 1:]
    # truncated SVD of Y0
    U, s, Vh = np.linalg.svd(Y0, full_matrices=False)
    if len(s) == 0:
        return np.array([]), np.array([]), np.array([])
    keep = s > rcond * s[0]
    rank = min(int(np.sum(keep)), max_order)
    U, s, Vh = U[:, :rank], s[:rank], Vh[:rank]
    # reduced pencil
    A = np.diag(1.0 / s) @ (U.conj().T @ Y1 @ Vh.conj().T)
    z = np.linalg.eigvals(A)
    z = z[np.abs(z) > 1e-12]
    log_z = np.log(z)
    freqs = -log_z.imag / (2 * np.pi * dt)
    decays = -log_z.real / dt
    # amplitudes via least squares on the full signal
    t_idx = np.arange(n)
    basis = z[None, :] ** t_idx[:, None]
    amps, *_ = np.linalg.lstsq(basis, signal, rcond=None)
    return freqs, decays, amps
