"""Custom exceptions, mirroring the reference exception taxonomy
(/root/reference/tidy3d/exceptions.py)."""

from .log import log


class Tidy3dError(Exception):
    """Any error in tidy3d_tpu."""

    def __init__(self, message: str = None):
        super().__init__(message)
        if message is not None:
            log.error(message)


class ConfigError(Tidy3dError):
    """Error when configuring tidy3d_tpu."""


class Tidy3dKeyError(Tidy3dError):
    """Could not find a key in a dict-like object."""


class ValidationError(Tidy3dError):
    """Error when constructing components."""


class SetupError(Tidy3dError):
    """Error in the setup of the simulation."""


class SimulationError(Tidy3dError):
    """Error occurred within the simulation run."""


class DataError(Tidy3dError):
    """Error accessing data."""


class FileError(Tidy3dError):
    """Error reading/writing to file."""

class Tidy3dImportError(Tidy3dError):
    """Error importing a package needed for a feature."""


class Tidy3dNotImplementedError(Tidy3dError):
    """Requested feature is not yet implemented."""


class DivergenceError(SimulationError):
    """Simulation diverged (fields grew without bound)."""


class AdjointError(Tidy3dError):
    """Error in the adjoint / differentiation pipeline."""


class WebError(Tidy3dError):
    """Error in the local execution ('web'-shaped) layer."""
