from .base import Expression, expression_from_dict
from .variables import Constant, Variable
from .metrics import ModeAmp, ModePower, generate_validation_data

__all__ = ["Expression", "expression_from_dict", "Constant", "Variable", "ModeAmp", "ModePower",
           "generate_validation_data"]
