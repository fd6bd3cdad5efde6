"""Analytic microstrip transmission-line models.

Behavioral model: tidy3d v2.7.6 plugins/microwave/models/
microstrip.py. Standard Hammerstad-Jensen closed-form expressions
(E. Hammerstad, O. Jensen, "Accurate models for microstrip computer-aided
design", IEEE MTT-S 1980) for the quasi-static effective permittivity and
characteristic impedance of a microstrip of width w on a substrate of
height h and relative permittivity eps_r.
"""

from __future__ import annotations

import numpy as np

ETA_0 = 376.73031346177066


def _f_hj(u: float) -> float:
    """Hammerstad-Jensen f(u) auxiliary."""
    return 6.0 + (2.0 * np.pi - 6.0) * np.exp(-((30.666 / u) ** 0.7528))


def _z01(u: float) -> float:
    """Impedance of the air-filled line."""
    return ETA_0 / (2 * np.pi) * np.log(_f_hj(u) / u
                                        + np.sqrt(1.0 + (2.0 / u) ** 2))


def epsilon_eff(width: float, height: float, eps_r: float) -> float:
    """Quasi-static effective permittivity (Hammerstad-Jensen)."""
    u = width / height
    a = 1.0 + (1.0 / 49.0) * np.log((u**4 + (u / 52.0) ** 2)
                                    / (u**4 + 0.432)) \
        + (1.0 / 18.7) * np.log(1.0 + (u / 18.1) ** 3)
    b = 0.564 * ((eps_r - 0.9) / (eps_r + 3.0)) ** 0.053
    return (eps_r + 1.0) / 2.0 + (eps_r - 1.0) / 2.0 \
        * (1.0 + 10.0 / u) ** (-a * b)


def wheeler_z0(width: float, height: float, eps_r: float) -> float:
    """Characteristic impedance [ohm] (Hammerstad-Jensen form)."""
    u = width / height
    e_eff = epsilon_eff(width, height, eps_r)
    return _z01(u) / np.sqrt(e_eff)


# aliases matching common naming
compute_line_params = wheeler_z0


def microstrip_z0_eeff(width: float, height: float, eps_r: float):
    """(Z0 [ohm], eps_eff) of a microstrip line."""
    return wheeler_z0(width, height, eps_r), epsilon_eff(width, height, eps_r)
