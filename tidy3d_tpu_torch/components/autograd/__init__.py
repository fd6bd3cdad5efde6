from .derivative_utils import DerivativeInfo

__all__ = ["DerivativeInfo"]
