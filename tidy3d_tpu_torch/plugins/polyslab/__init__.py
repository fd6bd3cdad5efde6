from .polyslab import ComplexPolySlab
