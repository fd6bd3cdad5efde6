from .fit import DispersionFitter, StableDispersionFitter
from .fit_fast import FastDispersionFitter
