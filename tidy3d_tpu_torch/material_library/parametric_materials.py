"""Parametric materials: graphene surface conductivity.

Behavioral model: the upstream tidy3d material_library/
parametric_materials.py (Graphene:60). The physics is the standard Kubo /
Hanson model (G. W. Hanson, IEEE Trans. Antennas Propag. 56, 747 (2008)):
an intraband Drude term (exact) plus a numerically integrated interband
term, fitted here with the vector-fitting dispersion fitter instead of the
reference's Pade approximants.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import pydantic

from ..components.base import Tidy3dBaseModel, cached_property
from ..components.medium import Drude, Medium2D, PoleResidue
from ..constants import C_0, EPSILON_0, HBAR, K_B, Q_e
from ..log import log

# conversion: our HBAR/K_B are in eV units (HBAR [eV s], K_B [eV/K])
_HBAR_SI = HBAR * Q_e  # J s


class Graphene(Tidy3dBaseModel):
    """Parametric surface conductivity model of graphene."""

    mu_c: float = pydantic.Field(0.0, title="Chemical potential [eV]")
    temp: pydantic.PositiveFloat = pydantic.Field(300.0, title="Temperature [K]")
    gamma: pydantic.NonNegativeFloat = pydantic.Field(
        0.00041, title="Scattering rate [eV]")
    scaling: pydantic.PositiveFloat = pydantic.Field(
        1.0, title="Layer scaling factor")
    include_interband: bool = pydantic.Field(True, title="Include interband")
    interband_fit_freq_range: Optional[Tuple[float, float]] = pydantic.Field(
        None, title="Interband fit frequency range [Hz]")

    @cached_property
    def intraband_drude(self) -> Drude:
        """Exact Drude representation of the intraband conductivity:
        sigma_intra(w) = (i e^2 kB T / (pi hbar^2 (w + i/tau)))
                        * [mu_c/(kB T) + 2 ln(exp(-mu_c/(kB T)) + 1)].
        Expressed as a Drude 'volumetric' medium whose conductivity in S
        equals the surface conductivity (the 1/dl sheet scaling is applied at
        rasterization by Medium2D)."""
        kt = K_B * self.temp  # eV
        # f1^2 = e^2 kB_J T F / (4 pi^3 hbar_SI^2 eps0), written with the
        # eV-unit constants: Q_e kt / (HBAR^2 4 pi^3 eps0)
        factor1 = Q_e * kt / (HBAR**2 * 4 * np.pi**3 * EPSILON_0)
        factor2 = self.mu_c / kt + 2.0 * np.log(np.exp(-self.mu_c / kt) + 1.0)
        f1 = float(np.sqrt(self.scaling * factor1 * factor2))
        delta1 = self.gamma / (np.pi * HBAR)
        return Drude(coeffs=[(f1, delta1)])

    def interband_conductivity(self, freqs) -> np.ndarray:
        """Kubo interband surface conductivity [S] by numerical integration."""
        from scipy import integrate

        kt = K_B * self.temp  # eV

        def fermi_g(e_ev):
            # f(-E) - f(E) with overflow-safe exponentials
            def fermi(e):
                x = np.clip((e - self.mu_c) / kt, -700, 700)
                return 1.0 / (np.exp(x) + 1.0)
            return fermi(-e_ev) - fermi(e_ev)

        omegas = 2 * np.pi * np.asarray(freqs, dtype=float)
        out = np.zeros(len(omegas), dtype=complex)
        for i, w in enumerate(omegas):
            hw = HBAR * w  # eV
            # real (absorptive) part: (e^2/4hbar) G(hw/2)
            re = (Q_e**2 / (4.0 * _HBAR_SI)) * fermi_g(hw / 2.0)

            # imaginary part via principal-value integral
            def integrand(e_ev):
                return (fermi_g(e_ev) - fermi_g(hw / 2.0)) / (hw**2 - 4 * e_ev**2)

            upper = max(20 * kt + 10 * abs(self.mu_c), 2 * hw)
            val, _ = integrate.quad(integrand, 0.0, upper,
                                    points=[hw / 2.0] if hw / 2.0 < upper else None,
                                    limit=200)
            im = (Q_e**2 / (4.0 * _HBAR_SI)) * (4.0 * hw / np.pi) * val
            out[i] = self.scaling * (re + 1j * im)
        return out

    def numerical_conductivity(self, freqs) -> np.ndarray:
        """Total (intraband + interband) surface conductivity [S]."""
        intra = np.asarray(self.intraband_drude.pole_residue.sigma_model(freqs))
        if not self.include_interband:
            return intra
        return intra + self.interband_conductivity(freqs)

    @cached_property
    def interband_pole_residue(self) -> PoleResidue:
        """Vector-fit pole-residue model of the interband conductivity."""
        from ..plugins.dispersion import FastDispersionFitter

        kt_hz = K_B * self.temp / (2 * np.pi * HBAR)
        mu_hz = abs(self.mu_c) / (2 * np.pi * HBAR)
        resonance = max(np.sqrt(abs(mu_hz**2 - kt_hz**2)), 1e12)
        if self.interband_fit_freq_range is not None:
            f_lo, f_hi = self.interband_fit_freq_range
        else:
            f_lo, f_hi = resonance / 20.0, resonance * 20.0
        freqs = np.logspace(np.log10(f_lo), np.log10(f_hi), 60)
        sigma = self.interband_conductivity(freqs)
        # fictitious permittivity samples: eps = 1 + i sigma/(w eps0)
        eps = 1.0 + 1j * sigma / (2 * np.pi * freqs * EPSILON_0)
        fitter = FastDispersionFitter(
            wvl_um=tuple((C_0 / freqs).tolist()),
            n_data=tuple(np.real(np.sqrt(eps)).tolist()),
            k_data=tuple(np.imag(np.sqrt(eps)).tolist()),
        )
        medium, rms = fitter.fit(max_num_poles=4, tolerance_rms=1e-4)
        if rms > 1e-2:
            log.warning(f"graphene interband fit rms {rms:.2e}; consider "
                        "setting interband_fit_freq_range for your band.")
        return medium

    @property
    def medium(self) -> Medium2D:
        """The graphene surface-conductivity sheet as a 2D medium."""
        intra = self.intraband_drude.pole_residue
        if self.include_interband:
            inter = self.interband_pole_residue
            pr = PoleResidue(eps_inf=intra.eps_inf + (inter.eps_inf - 1.0),
                             poles=tuple(list(intra.poles) + list(inter.poles)))
        else:
            pr = intra
        return Medium2D(ss=pr, tt=pr)
