from .component_modelers.modal import ComponentModeler, Port
from .component_modelers.terminal import (
    LumpedPort,
    TerminalComponentModeler,
)

__all__ = ["ComponentModeler", "Port", "TerminalComponentModeler", "LumpedPort"]
