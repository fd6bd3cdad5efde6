"""Heat monitors (reference: tidy3d/components/heat/monitor.py)."""

from __future__ import annotations

import pydantic

from ..geometry.base import Box


class TemperatureMonitor(Box):
    """Records the steady-state temperature field in a region."""

    name: str = pydantic.Field(..., min_length=1, title="Name")
    unstructured: bool = pydantic.Field(
        False, title="Unstructured output",
        description="This solver returns structured-grid data; kept for API parity.")
