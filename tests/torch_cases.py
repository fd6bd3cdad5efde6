"""Small simulations shared by the ``test_torch_*`` equivalence tests.

Each grid is 10 to 22 cells wide (dl = 0.05, PML included), so both
packages step it in well under a second on the CPU. The simulations are the
port's; ``to_reference`` carries one to the JAX package through its JSON
(``parse_raw(sim.json())``), and ``lower_reference`` lowers it there. The
equivalence tests step that one plan in both runners;
``tests/test_torch_imports.py`` holds the port's own ``lower()`` equal to
it on every case here.

The JAX package's schema imports ``h5py`` at module level for its file I/O,
and the card's machine has none. The tests write no file, so where ``h5py``
is missing an empty stand-in lets them import the JAX package there: import
this module before any ``tidy3d_tpu`` module. The port itself defers
``h5py`` to its file I/O and needs no stand-in.
"""

import sys
import types

import numpy as np

try:
    import h5py  # noqa: F401
except ImportError:
    sys.modules["h5py"] = types.ModuleType("h5py")

import tidy3d_tpu_torch as td  # noqa: E402
from tidy3d_tpu_torch import C_0  # noqa: E402

FREQ0 = C_0 / 1.55
DL = 0.05
SIZE = (12 * DL, 10 * DL, 16 * DL)


def to_reference(sim):
    """The JAX package's ``Simulation`` equal to the port's ``sim``. The
    JAX package's ``Medium.modulation_spec`` field keeps a parsed dict as a
    dict (no ``applied_modulation``, so its lowering would drop the
    modulation): each is rebuilt as its ``ModulationSpec``."""
    import tidy3d_tpu

    ref = tidy3d_tpu.Simulation.parse_raw(sim.json())
    structures = []
    for st in ref.structures:
        spec = getattr(st.medium, "modulation_spec", None)
        if isinstance(spec, dict):
            st = st.copy(update=dict(medium=st.medium.copy(update=dict(
                modulation_spec=tidy3d_tpu.ModulationSpec.parse_obj(spec)))))
        structures.append(st)
    return ref.copy(update=dict(structures=structures))


def lower_reference(sim):
    """The JAX package's ``SimulationPlan`` of the port's ``sim``."""
    from tidy3d_tpu.solver.lowering import lower

    return lower(to_reference(sim))


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


# Bloch (complex) runs: the kstep tier steps two real copies of the fields


def bloch_dipole(**kw):
    """Bloch x (0.27) and y (-0.13), PML z, the dielectric block: the
    JAX package's ``fdtd_bloch`` bench case in small."""
    return _sim(td.BoundarySpec(
        x=td.Boundary.bloch(bloch_vec=0.27),
        y=td.Boundary.bloch(bloch_vec=-0.13),
        z=td.Boundary.pml(num_layers=3)), structures=[DIELECTRIC], **kw)


def angled_plane_wave(theta_deg: float = 25.0):
    """An Ez-polarised plane wave along +x tilted by ``theta_deg`` in y."""
    return td.PlaneWave(
        center=(-0.2, 0, 0), size=(0, td.inf, td.inf), direction="+",
        source_time=td.GaussianPulse(freq0=FREQ0, fwidth=FREQ0 / 5),
        pol_angle=np.pi / 2, angle_theta=np.deg2rad(theta_deg))


def bloch_planewave(**kw):
    """PML x, Bloch y from the angled plane wave (``BlochBoundary.
    from_source``), periodic z: complex source profiles."""
    pw = angled_plane_wave()
    bloch = td.BlochBoundary.from_source(source=pw, domain_size=SIZE[1],
                                         axis=1)
    return _sim(td.BoundarySpec(
        x=td.Boundary.pml(num_layers=3), y=td.Boundary(minus=bloch,
                                                       plus=bloch),
        z=td.Boundary.periodic()), **kw).copy(update=dict(sources=[pw]))


def bloch_x_pec(**kw):
    """Bloch x (0.31) with PEC y walls and a PML z: the wrap of the x
    march."""
    return _sim(td.BoundarySpec(
        x=td.Boundary.bloch(bloch_vec=0.31),
        y=td.Boundary(minus=td.PECBoundary(), plus=td.PECBoundary()),
        z=td.Boundary.pml(num_layers=3)), structures=[DIELECTRIC], **kw)


BLOCH = {f.__name__: f for f in (bloch_dipole, bloch_planewave,
                                 bloch_x_pec)}


# Grids of several k-step kernel blocks per axis (x slabs of 32 planes,
# tiles of 13 rows and 29 columns at k = 2), none of them a multiple of the
# tile: the kernel's bulk and shell blocks both occur. 70 x 40 x 64 cells
# inside the walls (76 x 46 x 70 with a 3-layer PML on every side).
TILED_SIZE = (70 * DL, 40 * DL, 64 * DL)
PML3 = td.PML(num_layers=3)
LORENTZ2 = td.Lorentz(eps_inf=1.5, coeffs=[
    (2.0, 1.5 * FREQ0, FREQ0 / 10), (1.0, 2.5 * FREQ0, FREQ0 / 5)])
LORENTZ8 = td.Lorentz(eps_inf=1.5, coeffs=[
    (0.5 + 0.25 * i, (1.2 + 0.25 * i) * FREQ0, FREQ0 / 10)
    for i in range(8)])


def _tiled(bspec, structures=(), **kw):
    return _sim(bspec, structures, **kw).copy(update=dict(size=TILED_SIZE))


def _half(medium):
    """``medium`` filling the upper z half through the x and y walls."""
    return _box(medium, center=(0, 0, TILED_SIZE[2] / 4),
                size=(td.inf, td.inf, TILED_SIZE[2] / 2))


def tiled_pec_pmc(**kw):
    """PEC lo x and PMC lo y walls, PML on the other sides, a dielectric
    block: no poles."""
    return _tiled(td.BoundarySpec(
        x=td.Boundary(minus=td.PECBoundary(), plus=PML3),
        y=td.Boundary(minus=td.PMCBoundary(), plus=PML3),
        z=td.Boundary(minus=PML3, plus=PML3)), [DIELECTRIC], **kw)


def tiled_lorentz_periodic(**kw):
    """One Lorentz pole in a half-space, periodic x."""
    return _tiled(td.BoundarySpec(x=td.Boundary.periodic(),
                                  y=td.Boundary(minus=PML3, plus=PML3),
                                  z=td.Boundary(minus=PML3, plus=PML3)),
                  [DIELECTRIC, _half(LORENTZ)], **kw)


def tiled_lorentz2(**kw):
    """Two Lorentz poles in a half-space, PML on every side."""
    return _tiled(td.BoundarySpec.all_sides(td.PML(num_layers=3)),
                  [_half(LORENTZ2)], **kw)


def tiled_gold(**kw):
    """The 7-pole Au fit in a half-space, PML on every side."""
    return _tiled(td.BoundarySpec.all_sides(td.PML(num_layers=3)),
                  [_half(GOLD)], **kw)


def tiled_lorentz8(**kw):
    """Eight Lorentz poles in a half-space, PMC lo x and PEC lo z, periodic
    y: every pole slot the kernel has."""
    return _tiled(td.BoundarySpec(
        x=td.Boundary(minus=td.PMCBoundary(), plus=PML3),
        y=td.Boundary.periodic(),
        z=td.Boundary(minus=td.PECBoundary(), plus=PML3)),
        [_half(LORENTZ8)], **kw)


def tiled_bloch(**kw):
    """Bloch x (0.27) and y (-0.13), PML z, the dielectric block."""
    return _tiled(td.BoundarySpec(
        x=td.Boundary.bloch(bloch_vec=0.27),
        y=td.Boundary.bloch(bloch_vec=-0.13),
        z=td.Boundary(minus=PML3, plus=PML3)), [DIELECTRIC], **kw)


TILED = {f.__name__: f for f in (tiled_pec_pmc, tiled_lorentz_periodic,
                                 tiled_lorentz2, tiled_gold, tiled_lorentz8,
                                 tiled_bloch)}


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


# Cases of web.run's monitor data: modes and the mode solver, permittivity,
# far-field projection and diffraction


def mode_plane(**kw):
    """The mode plane of ``waveguide``: 0.4 x 0.6 um normal to x."""
    return dict(center=(0.15, 0, 0), size=(0, 0.4, 0.6), **kw)


def waveguide_monitors(freqs=None):
    """A mode monitor of 2 modes, a mode-solver monitor and a flux plane on
    the mode plane, and a permittivity plane through the strip."""
    freqs = list(np.linspace(0.9 * FREQ0, 1.1 * FREQ0, 3)) \
        if freqs is None else freqs
    spec = td.ModeSpec(num_modes=2)
    return [
        td.ModeMonitor(**mode_plane(), freqs=freqs, mode_spec=spec,
                       name="mode"),
        td.ModeSolverMonitor(**mode_plane(), freqs=freqs[:2], mode_spec=spec,
                             name="modes"),
        td.FluxMonitor(**mode_plane(), freqs=freqs, name="flux"),
        td.PermittivityMonitor(center=(0, 0, 0), size=(0.5, 0.4, 0),
                               freqs=[FREQ0], name="eps"),
    ]


def waveguide(monitors=None, run_time=2e-14, **kw):
    """A strip of eps 12.1 (0.25 x 0.15 um) along x in eps 2.085, a mode
    source of mode 0 at x = -0.2 and ``waveguide_monitors``; PML on every
    side."""
    sim = _sim(td.BoundarySpec.all_sides(td.PML(num_layers=3)),
               run_time=run_time, **kw)
    return sim.copy(update=dict(
        medium=td.Medium(permittivity=2.085),
        structures=[td.Structure(
            geometry=td.Box(center=(0, 0, 0), size=(td.inf, 0.25, 0.15)),
            medium=td.Medium(permittivity=12.1))],
        sources=[td.ModeSource(
            center=(-0.2, 0, 0), size=(0, 0.4, 0.6), direction="+",
            source_time=td.GaussianPulse(freq0=FREQ0, fwidth=FREQ0 / 5),
            mode_spec=td.ModeSpec(num_modes=1), mode_index=0)],
        monitors=waveguide_monitors() if monitors is None
        else list(monitors)))


def projection_monitors(freqs=None):
    """The three field-projection monitors on a box around the dipole."""
    freqs = [FREQ0, 1.1 * FREQ0] if freqs is None else freqs
    box = dict(center=(0, 0, 0), size=(0.3, 0.25, 0.4), freqs=freqs)
    return [
        td.FieldProjectionAngleMonitor(
            **box, name="angle", theta=np.linspace(0.2, np.pi - 0.2, 5),
            phi=np.linspace(0, 2 * np.pi, 4, endpoint=False)),
        td.FieldProjectionCartesianMonitor(
            **box, name="cartesian", proj_axis=2, proj_distance=50.0,
            x=np.linspace(-5, 5, 3), y=np.linspace(-4, 4, 3)),
        td.FieldProjectionKSpaceMonitor(
            **box, name="kspace", proj_axis=1, ux=np.linspace(-0.6, 0.6, 3),
            uy=np.linspace(-0.5, 0.5, 3)),
    ]


def diffraction_monitors(freqs=None):
    """Diffraction planes ahead of and behind an x-directed plane wave."""
    freqs = list(np.linspace(0.9 * FREQ0, 1.1 * FREQ0, 3)) \
        if freqs is None else freqs
    return [
        td.DiffractionMonitor(center=(0.2, 0, 0), size=(0, td.inf, td.inf),
                              freqs=freqs, name="diff", normal_dir="+"),
        td.DiffractionMonitor(center=(-0.25, 0, 0), size=(0, td.inf, td.inf),
                              freqs=freqs, name="diff_r", normal_dir="-"),
    ]


def normal_planewave(**kw):
    """PML x, periodic y and z, a dielectric block and an Ez plane wave
    along +x: a real run with diffraction orders."""
    return _sim(td.BoundarySpec(
        x=td.Boundary.pml(num_layers=3), y=td.Boundary.periodic(),
        z=td.Boundary.periodic()), structures=[DIELECTRIC], **kw).copy(
        update=dict(sources=[angled_plane_wave(0.0)]))


MONITOR_CASES = {
    "waveguide": waveguide,
    "projection": lambda **kw: pml_all(**kw).copy(
        update=dict(monitors=projection_monitors())),
    "diffraction": lambda **kw: normal_planewave(**kw).copy(
        update=dict(monitors=diffraction_monitors())),
    "diffraction_bloch": lambda **kw: bloch_planewave(**kw).copy(
        update=dict(monitors=diffraction_monitors())),
}


# Differentiation: the coupling case of the JAX package's adjoint tests

COUPLING_FREQ0 = C_0 / 1.5
COUPLING_REGION = dict(center=(-0.1, 0, 0), size=(1.2, 1.8, td.inf))


def coupling(run_time=1e-13):
    """The 2D coupling case of ``tests/test_plugins/test_adjoint_invdes.py``
    (108 x 85 x 1 cells at dl = 0.06, 724 steps at the default run time):
    an Ez dipole, an eps 4 strip to the right and a one-mode monitor on it
    at 1.5 um, PML in x and y, periodic z, no shutoff. The design region
    is ``COUPLING_REGION`` (21 x 31 x 1 cells)."""
    f0 = COUPLING_FREQ0
    return td.Simulation(
        center=(0, 0, 0), size=(5, 3.6, 0), run_time=run_time,
        sources=[td.PointDipole(
            center=(-1.4, 0, 0),
            source_time=td.GaussianPulse(freq0=f0, fwidth=f0 / 6),
            polarization="Ez")],
        monitors=[td.ModeMonitor(
            center=(1.8, 0, 0), size=(0, 2.6, td.inf), freqs=[f0],
            name="out", mode_spec=td.ModeSpec(num_modes=1,
                                              target_neff=2.0))],
        structures=[td.Structure(
            geometry=td.Box(center=(1.55, 0, 0), size=(1.7, 0.4, td.inf)),
            medium=td.Medium(permittivity=4.0))],
        shutoff=0.0,
        boundary_spec=td.BoundarySpec(x=td.Boundary.pml(),
                                      y=td.Boundary.pml(),
                                      z=td.Boundary.periodic()),
        grid_spec=td.GridSpec.uniform(dl=0.06))
