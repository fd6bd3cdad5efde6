"""Small simulations shared by the ``test_torch_*`` equivalence tests.

Each grid is 10 to 22 cells wide (dl = 0.05, PML included), so both
packages step it in well under a second on the CPU. The schema comes
through the port, so this module imports on a machine without ``h5py``.
"""

import numpy as np

import tidy3d_tpu_torch as td
from tidy3d_tpu_torch import C_0

FREQ0 = C_0 / 1.55
DL = 0.05
SIZE = (12 * DL, 10 * DL, 16 * DL)


def _sim(bspec, structures=(), monitors=(), run_time=1e-14, **kwargs):
    return td.Simulation(
        center=(0, 0, 0), size=SIZE, run_time=run_time,
        sources=[td.PointDipole(
            center=(0.02, -0.01, 0.03),
            source_time=td.GaussianPulse(freq0=FREQ0, fwidth=FREQ0 / 5),
            polarization="Ez")],
        structures=list(structures), monitors=list(monitors),
        boundary_spec=bspec, grid_spec=td.GridSpec.uniform(dl=DL),
        shutoff=0.0, **kwargs)


DIELECTRIC = td.Structure(
    geometry=td.Box(center=(0.05, 0.0, -0.05), size=(0.3, 0.25, 0.35)),
    medium=td.Medium(permittivity=4.0, conductivity=0.02))


def pml_all(**kw):
    return _sim(td.BoundarySpec.all_sides(td.PML(num_layers=3)), **kw)


def dielectric_mixed(**kw):
    """PML, PEC and PMC walls mixed per side, with per-cell ca/cb."""
    return _sim(td.BoundarySpec(
        x=td.Boundary(minus=td.PML(num_layers=3), plus=td.PECBoundary()),
        y=td.Boundary(minus=td.PMCBoundary(), plus=td.PMCBoundary()),
        z=td.Boundary(minus=td.PECBoundary(), plus=td.PML(num_layers=3))),
        structures=[DIELECTRIC], **kw)


def periodic(**kw):
    """Periodic x and y with a PML z, with per-cell ca/cb."""
    return _sim(td.BoundarySpec(
        x=td.Boundary.periodic(), y=td.Boundary.periodic(),
        z=td.Boundary.pml(num_layers=3)), structures=[DIELECTRIC], **kw)


def pec_pmc(**kw):
    """PEC x, PMC/PEC y and PML z in vacuum (scalar ca/cb)."""
    return _sim(td.BoundarySpec(
        x=td.Boundary(minus=td.PECBoundary(), plus=td.PECBoundary()),
        y=td.Boundary(minus=td.PMCBoundary(), plus=td.PECBoundary()),
        z=td.Boundary.pml(num_layers=3)), **kw)


SIMS = {f.__name__: f for f in (pml_all, dielectric_mixed, periodic,
                                pec_pmc)}

# dispersive media: one Lorentz pole, a purely real (Drude) pole, three
# Lorentz poles and the 7-pole Au fit of the material library
LORENTZ = td.Lorentz(eps_inf=2.0, coeffs=[(8.0, 1.8 * FREQ0, FREQ0 / 10)])
DRUDE = td.Drude(eps_inf=1.0, coeffs=[(2 * FREQ0, FREQ0 / 5)])
LORENTZ3 = td.Lorentz(eps_inf=1.5, coeffs=[
    (2.0, 1.5 * FREQ0, FREQ0 / 10), (1.0, 2.5 * FREQ0, FREQ0 / 5),
    (0.5, 0.8 * FREQ0, FREQ0 / 20)])
GOLD = td.material_library["Au"]["RakicBrendelBormann1998"]


def _box(medium, center=(0.05, 0.0, 0.1), size=(0.35, 0.3, 0.3)):
    return td.Structure(geometry=td.Box(center=center, size=size),
                        medium=medium)


def lorentz_mixed(**kw):
    """One Lorentz pole in a box beside the dielectric, mixed walls."""
    return dielectric_mixed(**kw).copy(update=dict(
        structures=[DIELECTRIC, _box(LORENTZ)]))


def drude_periodic(**kw):
    """A Drude (real) pole in a box, periodic x and y."""
    return periodic(**kw).copy(update=dict(
        structures=[DIELECTRIC, _box(DRUDE)]))


def lorentz3_pml(**kw):
    """Three Lorentz poles in a box through the lo-x PML."""
    return pml_all(**kw).copy(update=dict(structures=[_box(
        LORENTZ3, center=(-0.2, 0.0, 0.05), size=(0.4, 0.3, 0.3))]))


def gold_halfspace(**kw):
    """The 7-pole Au fit filling the upper z half, through the x/y PML."""
    return pml_all(**kw).copy(update=dict(structures=[_box(
        GOLD, center=(0, 0, SIZE[2] / 2), size=(td.inf, td.inf, SIZE[2]))]))


def sheet_lorentz(**kw):
    """A plane-wave sheet spanning the x and y PML onto a Lorentz slab."""
    sim = lorentz3_pml(**kw)
    return sim.copy(update=dict(
        sources=[td.PlaneWave(
            center=(0, 0, -0.2), size=(td.inf, td.inf, 0),
            source_time=td.GaussianPulse(freq0=FREQ0, fwidth=FREQ0 / 5),
            direction="+", pol_angle=0.3)],
        structures=[_box(LORENTZ, center=(0, 0, 0.2),
                         size=(td.inf, td.inf, 0.2))]))


DISPERSIVE = {f.__name__: f for f in (lorentz_mixed, drude_periodic,
                                      lorentz3_pml, gold_halfspace,
                                      sheet_lorentz)}


def monitors():
    """A field, a flux and a field-time monitor around the source."""
    freqs = list(np.linspace(0.9 * FREQ0, 1.1 * FREQ0, 3))
    return [
        td.FieldMonitor(center=(0, 0, 0.05), size=(0.4, 0.3, 0),
                        freqs=freqs, name="field"),
        td.FluxMonitor(center=(0, 0, 0), size=(0.3, 0.25, 0.4),
                       freqs=freqs, name="flux"),
        td.FieldTimeMonitor(center=(0, 0, 0), size=(0.2, 0.2, 0.2),
                            interval=4, name="time"),
    ]


def random_state(rng, shape, psi_shapes, pole_scalars=()):
    """Random E/H fields, psi slabs and pole currents (float32 numpy,
    reference layout). Each pole's currents are scaled by 1/|Gc| so that
    its term in the E update is of the order of the curl."""
    def r(s):
        return rng.standard_normal(s).astype(np.float32)

    def q(gc):
        return (r(shape) / np.float32(abs(gc)), r(shape) / np.float32(abs(gc)))

    return {
        "E": {c: r(shape) for c in ("Ex", "Ey", "Ez")},
        "H": {c: r(shape) for c in ("Hx", "Hy", "Hz")},
        "psi": {k: 0.1 * r(s) for k, s in psi_shapes.items()},
        "Q": [{c: q(Gc) for c in ("Ex", "Ey", "Ez")}
              for _, Gc in pole_scalars],
    }


def max_rel_err(ref: dict, got: dict) -> float:
    """Largest |ref - got| over all entries, relative to the largest |ref|."""
    scale = max(float(np.max(np.abs(v))) for v in ref.values()) + 1e-30
    return max(float(np.max(np.abs(np.asarray(ref[k]) - np.asarray(got[k]))))
               for k in ref) / scale
