"""Serializable scalar expression AST — objective functions as data.

Behavioral model: tidy3d v2.7.6 plugins/expressions/ (Expression
base :28 with operator overloading; operators/functions/variables modules).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import numpy as np
import pydantic

from ...components.base import Tidy3dBaseModel
from ...components.types import annotate_type


class NumericType:
    pass


# type-tag registry so serialized ASTs reconstruct their node classes
EXPRESSION_REGISTRY = {}


class Expression(Tidy3dBaseModel):
    """Base class of all expression nodes: evaluable, composable, serializable."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        EXPRESSION_REGISTRY[cls.__name__] = cls

    def evaluate(self, *args, **kwargs) -> Any:
        raise NotImplementedError

    def __call__(self, *args, **kwargs) -> Any:
        return self.evaluate(*args, **kwargs)

    # operator overloads build AST nodes
    def __add__(self, other):
        from .operators import Add

        return Add(left=self, right=_wrap(other))

    def __radd__(self, other):
        from .operators import Add

        return Add(left=_wrap(other), right=self)

    def __sub__(self, other):
        from .operators import Subtract

        return Subtract(left=self, right=_wrap(other))

    def __rsub__(self, other):
        from .operators import Subtract

        return Subtract(left=_wrap(other), right=self)

    def __mul__(self, other):
        from .operators import Multiply

        return Multiply(left=self, right=_wrap(other))

    def __rmul__(self, other):
        from .operators import Multiply

        return Multiply(left=_wrap(other), right=self)

    def __truediv__(self, other):
        from .operators import Divide

        return Divide(left=self, right=_wrap(other))

    def __rtruediv__(self, other):
        from .operators import Divide

        return Divide(left=_wrap(other), right=self)

    def __pow__(self, other):
        from .operators import Power

        return Power(left=self, right=_wrap(other))

    def __neg__(self):
        from .operators import Negate

        return Negate(operand=self)

    def __abs__(self):
        from .functions import Abs

        return Abs(operand=self)


def _wrap(value) -> Expression:
    if isinstance(value, Expression):
        return value
    from .variables import Constant

    return Constant(value=value)


def expression_from_dict(model_dict: Any) -> Any:
    """Reconstruct an expression tree from its serialized dict (the node
    classes keep operands typed Any, so nested nodes arrive as dicts)."""
    if not isinstance(model_dict, dict) or "type" not in model_dict:
        return model_dict
    from . import functions as fn_mod
    from . import metrics as metric_mod
    from . import operators as op_mod
    from . import variables as var_mod

    registry = {}
    for mod in (op_mod, fn_mod, var_mod, metric_mod):
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type) and issubclass(obj, Expression):
                registry[name] = obj

    def build(node):
        if not isinstance(node, dict) or "type" not in node:
            return node
        cls = registry[node["type"]]
        kwargs = {k: build(v) for k, v in node.items() if k != "type"}
        return cls(**kwargs)

    return build(model_dict)


def expression_from_dict(val):
    """Reconstruct an Expression node from its serialized dict (by the
    injected ``type`` tag); pass anything else through."""
    if isinstance(val, dict) and val.get("type") in EXPRESSION_REGISTRY:
        return EXPRESSION_REGISTRY[val["type"]].model_validate(val)
    return val
