from .wrapper import to_torch
