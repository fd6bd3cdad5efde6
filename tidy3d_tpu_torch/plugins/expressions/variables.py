"""Variable and constant leaves of the expression AST."""

from __future__ import annotations

from typing import Any, Optional

import pydantic

from ...exceptions import SetupError
from .base import Expression


class Constant(Expression):
    value: Any = pydantic.Field(..., title="Value")

    def evaluate(self, *args, **kwargs):
        return self.value


class Variable(Expression):
    """Named (or positional) input to the expression."""

    name: Optional[str] = pydantic.Field(None, title="Name")

    def evaluate(self, *args, **kwargs):
        if self.name is not None:
            if self.name not in kwargs:
                raise SetupError(f"variable '{self.name}' not provided")
            return kwargs[self.name]
        if not args:
            raise SetupError("positional variable requires an argument")
        return args[0]
