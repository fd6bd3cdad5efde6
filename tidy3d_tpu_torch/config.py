"""Global configuration object ``td.config``.

Behavioral model: the upstream tidy3d config.py (validate-on-assignment
pydantic model controlling logging)."""

import pydantic

from .log import DEFAULT_LEVEL, LogLevelValues, log, set_logging_level


class Tidy3dConfig(pydantic.BaseModel):
    """Configuration of tidy3d_tpu (logging level/suppression, solver defaults)."""

    model_config = pydantic.ConfigDict(
        frozen=False, validate_assignment=True, extra="forbid"
    )

    logging_level: str = DEFAULT_LEVEL
    log_suppression: bool = True
    # solver defaults (TPU-specific knobs, not in reference schema)
    solver_precision: str = "float32"  # "float32" | "bfloat16_mixed"
    use_pallas: bool = True  # use fused Pallas kernels on TPU where available

    @pydantic.field_validator("logging_level")
    @classmethod
    def _set_logging_level(cls, val: str) -> str:
        level = val.upper()
        if level not in LogLevelValues:
            raise ValueError(f"Unknown logging level '{val}'")
        set_logging_level(level)
        return level

    @pydantic.field_validator("log_suppression")
    @classmethod
    def _set_suppression(cls, val: bool) -> bool:
        log.suppression = val
        return val


# instance of the config used globally
config = Tidy3dConfig()
