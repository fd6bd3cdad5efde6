from .mode_solver import ModeSolver
from .solver import compute_modes
