from .resonance import ResonanceData, ResonanceFinder
