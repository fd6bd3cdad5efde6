"""Binary/unary operator nodes of the expression AST."""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import pydantic

from .base import Expression


class BinaryOperator(Expression):
    left: Any = pydantic.Field(..., title="Left operand")
    right: Any = pydantic.Field(..., title="Right operand")

    @pydantic.field_validator("left", "right", mode="before")
    @classmethod
    def _reconstruct(cls, val):
        from .base import expression_from_dict

        return expression_from_dict(val)

    def _operands(self, *args, **kwargs):
        lhs = self.left.evaluate(*args, **kwargs) if isinstance(self.left, Expression) \
            else self.left
        rhs = self.right.evaluate(*args, **kwargs) if isinstance(self.right, Expression) \
            else self.right
        return lhs, rhs


class Add(BinaryOperator):
    def evaluate(self, *args, **kwargs):
        lhs, rhs = self._operands(*args, **kwargs)
        return lhs + rhs


class Subtract(BinaryOperator):
    def evaluate(self, *args, **kwargs):
        lhs, rhs = self._operands(*args, **kwargs)
        return lhs - rhs


class Multiply(BinaryOperator):
    def evaluate(self, *args, **kwargs):
        lhs, rhs = self._operands(*args, **kwargs)
        return lhs * rhs


class Divide(BinaryOperator):
    def evaluate(self, *args, **kwargs):
        lhs, rhs = self._operands(*args, **kwargs)
        return lhs / rhs


class Power(BinaryOperator):
    def evaluate(self, *args, **kwargs):
        lhs, rhs = self._operands(*args, **kwargs)
        return lhs**rhs


class UnaryOperator(Expression):
    operand: Any = pydantic.Field(..., title="Operand")

    @pydantic.field_validator("operand", mode="before")
    @classmethod
    def _reconstruct(cls, val):
        from .base import expression_from_dict

        return expression_from_dict(val)

    def _operand(self, *args, **kwargs):
        return self.operand.evaluate(*args, **kwargs) \
            if isinstance(self.operand, Expression) else self.operand


class Negate(UnaryOperator):
    def evaluate(self, *args, **kwargs):
        return -self._operand(*args, **kwargs)
