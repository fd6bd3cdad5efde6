"""Public ComplexPolySlab wrapper (reference: plugins/polyslab/polyslab.py:8)."""

from ...components.geometry.polyslab import ComplexPolySlabBase


class ComplexPolySlab(ComplexPolySlabBase):
    """PolySlab that splits self-intersecting extrusions into sub-slabs."""
