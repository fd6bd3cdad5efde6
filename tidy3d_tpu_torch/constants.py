"""Physical constants and unit labels.

Unit system matches the reference framework (tidy3d): lengths in micrometers,
times in seconds, frequencies in Hz (cf. /root/reference/tidy3d/constants.py).
"""

import numpy as np

# fundamental constants (https://physics.nist.gov), micron-second unit system
C_0 = 2.99792458e14
"""Speed of light in vacuum [um/s]."""

MU_0 = 1.25663706212e-12
"""Vacuum permeability [H/um]."""

EPSILON_0 = 1 / (MU_0 * C_0**2)
"""Vacuum permittivity [F/um]."""

ETA_0 = float(np.sqrt(MU_0 / EPSILON_0))
"""Vacuum impedance [Ohm]."""

Q_e = 1.602176634e-19
"""Fundamental charge [C]."""

HBAR = 6.582119569e-16
"""Reduced Planck constant [eV*s]."""

K_B = 8.617333262e-5
"""Boltzmann constant [eV/K]."""

# floating point precisions
dp_eps = float(np.finfo(np.float64).eps)
fp_eps = float(np.finfo(np.float32).eps)

# large conductivity value used to represent PEC in the mode solver
pec_val = -1e8

# our representation of infinity: large but finite so arithmetic stays safe
inf = 1e10

# glancing-incidence fix threshold
GLANCING_CUTOFF = 0.1

# unit labels (used in field metadata / docstrings)
HERTZ = "Hz"
TERAHERTZ = "THz"
SECOND = "sec"
PICOSECOND = "ps"
FEMTOSECOND = "fs"
METER = "m"
MICROMETER = "um"
NANOMETER = "nm"
RADIAN = "rad"
DEGREE = "deg"
CONDUCTIVITY = "S/um"
PERMITTIVITY = "None (relative permittivity)"
PML_SIGMA = "2*EPSILON_0/dt"
RADPERSEC = "rad/sec"
ELECTRON_VOLT = "eV"
KELVIN = "K"
CMCUBE = "cm^3"
PERCMCUBE = "1/cm^3"
WATT = "W"
VOLT = "V"
AMP = "A"
OHM = "ohm"
THERMAL_CONDUCTIVITY = "W/(um*K)"
SPECIFIC_HEAT_CAPACITY = "J/(kg*K)"
HEAT_FLUX = "W/um^2"
VOLUMETRIC_HEAT_RATE = "W/um^3"
HEAT_TRANSFER_COEFF = "W/(um^2*K)"
