"""Boundary conditions: PML/StablePML/Absorber, periodic, Bloch, PEC/PMC walls.

Behavioral model: /root/reference/tidy3d/components/boundary.py (PML:275 with
CFS parameters :195-254, BlochBoundary :55-84, BoundarySpec:732). Default
profiles match the reference: sigma in units of 2*eps0/dt, polynomial order 3,
kappa in [1, 3] order 3, alpha = 0 for standard PML; alpha_max = 0.9 for
StablePML; sigma-only adiabatic Absorber with sigma_max = 6.4.
"""

from __future__ import annotations

from abc import ABC
from typing import List, Optional, Tuple, Union

import numpy as np
import pydantic

from ..constants import C_0, EPSILON_0, PML_SIGMA
from ..exceptions import SetupError, ValidationError
from ..log import log
from .base import Tidy3dBaseModel, cached_property
from .medium import Medium, MediumType
from .types import Axis, Complex, annotate_type


class BoundaryEdge(Tidy3dBaseModel, ABC):
    """Electromagnetic boundary condition at a domain edge."""

    name: Optional[str] = pydantic.Field(None, title="Name")


class Periodic(BoundaryEdge):
    """Periodic boundary condition."""


class PECBoundary(BoundaryEdge):
    """Perfect electric conductor wall."""


class PMCBoundary(BoundaryEdge):
    """Perfect magnetic conductor wall."""


class BlochBoundary(BoundaryEdge):
    """Bloch-periodic boundary with phase shift exp(1j * 2*pi * bloch_vec)
    across the domain."""

    bloch_vec: float = pydantic.Field(
        ..., title="Normalized Bloch vector component",
        description="Bloch vector component in units of 2*pi/(domain size) "
        "along the boundary axis.",
    )

    @cached_property
    def bloch_phase(self) -> complex:
        """Phase factor applied when wrapping around the domain."""
        return np.exp(1j * 2 * np.pi * self.bloch_vec)

    @classmethod
    def from_source(cls, source, domain_size: float, axis: Axis,
                    medium: MediumType = None) -> "BlochBoundary":
        """Bloch vector matching the in-plane wavevector of an angled source."""
        if medium is None:
            n = 1.0
        else:
            freq0 = source.source_time.freq0
            eps = medium.eps_model(freq0)
            n = float(np.real(np.sqrt(eps)))
        freq0 = source.source_time.freq0
        angle_theta = getattr(source, "angle_theta", 0.0)
        angle_phi = getattr(source, "angle_phi", 0.0)
        if angle_theta == 0.0:
            return cls(bloch_vec=0.0)
        kmag = n * freq0 / C_0  # 1/um (in units of 2*pi)
        k_plane = kmag * np.sin(angle_theta)
        inj_axis = source.size.index(0.0)
        _, plane_axes = _pop(inj_axis)
        if axis not in plane_axes:
            raise SetupError("Bloch boundary axis must be transverse to the source "
                             "injection axis.")
        local = plane_axes.index(axis)
        k_comp = k_plane * (np.cos(angle_phi) if local == 0 else np.sin(angle_phi))
        return cls(bloch_vec=float(k_comp * domain_size))


def _pop(axis: int) -> Tuple[int, List[int]]:
    others = [0, 1, 2]
    others.remove(axis)
    return axis, others


# --------------------------------------------------------------------------- #
# absorber parameter sets (reference: boundary.py:162-260)
# --------------------------------------------------------------------------- #


class AbsorberParams(Tidy3dBaseModel):
    """Parameters of the conductivity profile of an absorber/PML."""

    sigma_order: pydantic.NonNegativeInt = pydantic.Field(
        3, title="Sigma Order", description="Polynomial order of the sigma profile."
    )
    sigma_min: pydantic.NonNegativeFloat = pydantic.Field(
        0.0, title="Sigma Minimum", description="", json_schema_extra={"units": PML_SIGMA}
    )
    sigma_max: pydantic.NonNegativeFloat = pydantic.Field(
        1.5, title="Sigma Maximum", description="", json_schema_extra={"units": PML_SIGMA}
    )


class PMLParams(AbsorberParams):
    """Full set of CFS-PML parameters (sigma, kappa, alpha profiles)."""

    kappa_order: pydantic.NonNegativeInt = pydantic.Field(3, title="Kappa Order")
    kappa_min: pydantic.NonNegativeFloat = pydantic.Field(0.0, title="Kappa Minimum")
    kappa_max: pydantic.NonNegativeFloat = pydantic.Field(1.5, title="Kappa Maximum")
    alpha_order: pydantic.NonNegativeInt = pydantic.Field(3, title="Alpha Order")
    alpha_min: pydantic.NonNegativeFloat = pydantic.Field(0.0, title="Alpha Minimum")
    alpha_max: pydantic.NonNegativeFloat = pydantic.Field(1.5, title="Alpha Maximum")


DefaultAbsorberParameters = AbsorberParams(sigma_order=3, sigma_min=0.0, sigma_max=6.4)
DefaultPMLParameters = PMLParams(
    sigma_order=3, sigma_min=0.0, sigma_max=1.5,
    kappa_order=3, kappa_min=1.0, kappa_max=3.0,
    alpha_order=1, alpha_min=0.0, alpha_max=0.0,
)
DefaultStablePMLParameters = PMLParams(
    sigma_order=3, sigma_min=0.0, sigma_max=1.0,
    kappa_order=3, kappa_min=1.0, kappa_max=5.0,
    alpha_order=1, alpha_min=0.0, alpha_max=0.9,
)


class AbsorberSpec(BoundaryEdge, ABC):
    """Absorbing layer specification."""

    num_layers: pydantic.NonNegativeInt = pydantic.Field(
        ..., title="Number of Layers"
    )
    parameters: AbsorberParams = pydantic.Field(
        ..., title="Parameters"
    )


class PML(AbsorberSpec):
    """Standard CFS-PML (12 layers default)."""

    num_layers: pydantic.NonNegativeInt = pydantic.Field(12, title="Number of Layers")
    parameters: PMLParams = pydantic.Field(DefaultPMLParameters, title="PML Parameters")


class StablePML(AbsorberSpec):
    """PML with parameters more robust to divergence (40 layers default)."""

    num_layers: pydantic.NonNegativeInt = pydantic.Field(40, title="Number of Layers")
    parameters: PMLParams = pydantic.Field(DefaultStablePMLParameters, title="Parameters")


class Absorber(AbsorberSpec):
    """Adiabatic sigma-only absorber (40 layers default); cures PML
    divergence at the cost of some reflection."""

    num_layers: pydantic.NonNegativeInt = pydantic.Field(40, title="Number of Layers")
    parameters: AbsorberParams = pydantic.Field(
        DefaultAbsorberParameters, title="Absorber Parameters"
    )


BoundaryEdgeType = Union[Periodic, PECBoundary, PMCBoundary, PML, StablePML, Absorber, BlochBoundary]


class Boundary(Tidy3dBaseModel):
    """Boundary conditions on the two sides of one axis."""

    plus: annotate_type(BoundaryEdgeType) = pydantic.Field(
        default_factory=PML, title="Plus BC"
    )
    minus: annotate_type(BoundaryEdgeType) = pydantic.Field(
        default_factory=PML, title="Minus BC"
    )

    @pydantic.model_validator(mode="after")
    def _periodic_pairs(self):
        """Periodic/Bloch conditions must come in matching pairs."""
        kinds = {type(self.plus), type(self.minus)}
        periodic_kinds = {Periodic, BlochBoundary}
        if (type(self.plus) in periodic_kinds) != (type(self.minus) in periodic_kinds):
            raise ValidationError(
                "periodic-type boundary must be applied on both sides of an axis"
            )
        if {Periodic, BlochBoundary} <= kinds:
            raise ValidationError("cannot mix Periodic and Bloch on the same axis")
        if (
            isinstance(self.plus, BlochBoundary)
            and isinstance(self.minus, BlochBoundary)
            and self.plus.bloch_vec != self.minus.bloch_vec
        ):
            raise ValidationError("Bloch vectors must match on both sides of an axis")
        return self

    # constructors (reference: Boundary classmethods)
    @classmethod
    def periodic(cls, **kwargs):
        return cls(plus=Periodic(), minus=Periodic(), **kwargs)

    @classmethod
    def bloch(cls, bloch_vec: float, **kwargs):
        return cls(plus=BlochBoundary(bloch_vec=bloch_vec),
                   minus=BlochBoundary(bloch_vec=bloch_vec), **kwargs)

    @classmethod
    def bloch_from_source(cls, source, domain_size: float, axis: Axis, medium=None, **kwargs):
        bc = BlochBoundary.from_source(source, domain_size, axis, medium)
        return cls(plus=bc, minus=bc, **kwargs)

    @classmethod
    def pec(cls, **kwargs):
        return cls(plus=PECBoundary(), minus=PECBoundary(), **kwargs)

    @classmethod
    def pmc(cls, **kwargs):
        return cls(plus=PMCBoundary(), minus=PMCBoundary(), **kwargs)

    @classmethod
    def pml(cls, num_layers: int = 12, parameters: PMLParams = DefaultPMLParameters, **kwargs):
        return cls(plus=PML(num_layers=num_layers, parameters=parameters),
                   minus=PML(num_layers=num_layers, parameters=parameters), **kwargs)

    @classmethod
    def stable_pml(cls, num_layers: int = 40, **kwargs):
        return cls(plus=StablePML(num_layers=num_layers),
                   minus=StablePML(num_layers=num_layers), **kwargs)

    @classmethod
    def absorber(cls, num_layers: int = 40, **kwargs):
        return cls(plus=Absorber(num_layers=num_layers),
                   minus=Absorber(num_layers=num_layers), **kwargs)


class BoundarySpec(Tidy3dBaseModel):
    """Boundary conditions for all three axes."""

    x: Boundary = pydantic.Field(default_factory=Boundary, title="Boundary condition along x")
    y: Boundary = pydantic.Field(default_factory=Boundary, title="Boundary condition along y")
    z: Boundary = pydantic.Field(default_factory=Boundary, title="Boundary condition along z")

    @classmethod
    def all_sides(cls, boundary: BoundaryEdgeType) -> "BoundarySpec":
        b = Boundary(plus=boundary, minus=boundary)
        return cls(x=b, y=b, z=b)

    @classmethod
    def pml(cls, x: bool = True, y: bool = True, z: bool = True) -> "BoundarySpec":
        return cls(
            x=Boundary.pml() if x else Boundary.periodic(),
            y=Boundary.pml() if y else Boundary.periodic(),
            z=Boundary.pml() if z else Boundary.periodic(),
        )

    @classmethod
    def pec(cls, x: bool = True, y: bool = True, z: bool = True) -> "BoundarySpec":
        return cls(
            x=Boundary.pec() if x else Boundary.periodic(),
            y=Boundary.pec() if y else Boundary.periodic(),
            z=Boundary.pec() if z else Boundary.periodic(),
        )

    @property
    def to_list(self) -> List[Tuple[BoundaryEdgeType, BoundaryEdgeType]]:
        return [(b.minus, b.plus) for b in (self.x, self.y, self.z)]

    def __getitem__(self, field_name: str) -> Boundary:
        if field_name in ("x", "y", "z"):
            return getattr(self, field_name)
        raise KeyError(f"boundary {field_name} not found")

    @cached_property
    def flipped_bloch_vecs(self) -> "BoundarySpec":
        updates = {}
        for dim in "xyz":
            boundary = self[dim]
            if isinstance(boundary.plus, BlochBoundary):
                updates[dim] = Boundary.bloch(bloch_vec=-boundary.plus.bloch_vec)
        return self.copy(update=updates)
