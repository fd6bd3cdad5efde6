"""Math function nodes of the expression AST."""

from __future__ import annotations

from typing import Any

import numpy as np
import pydantic

from .base import Expression
from .operators import UnaryOperator


class Abs(UnaryOperator):
    def evaluate(self, *args, **kwargs):
        return np.abs(self._operand(*args, **kwargs))


class Sqrt(UnaryOperator):
    def evaluate(self, *args, **kwargs):
        return np.sqrt(self._operand(*args, **kwargs))


class Exp(UnaryOperator):
    def evaluate(self, *args, **kwargs):
        return np.exp(self._operand(*args, **kwargs))


class Log(UnaryOperator):
    def evaluate(self, *args, **kwargs):
        return np.log(self._operand(*args, **kwargs))


class Log10(UnaryOperator):
    def evaluate(self, *args, **kwargs):
        return np.log10(self._operand(*args, **kwargs))


class Sin(UnaryOperator):
    def evaluate(self, *args, **kwargs):
        return np.sin(self._operand(*args, **kwargs))


class Cos(UnaryOperator):
    def evaluate(self, *args, **kwargs):
        return np.cos(self._operand(*args, **kwargs))


class Tan(UnaryOperator):
    def evaluate(self, *args, **kwargs):
        return np.tan(self._operand(*args, **kwargs))
