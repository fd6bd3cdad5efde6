"""Lowering: Simulation spec -> flat arrays + static metadata for the TPU
time-stepping core.

This replaces the reference's ``upload`` step (serialize + ship to the cloud
solver, /root/reference/tidy3d/web/api/webapi.py:159): here the spec is
lowered in-process to device-ready coefficient arrays:

* Yee-grid update coefficients Ca/Cb (E) and Da/Db (H) per component,
  including material conductivity, PEC masks, absorber profiles, and
  SDF-based polarized subpixel averaging at interfaces (the reference's
  server-side subpixel scheme, spec'd by SubpixelSpec).
* CPML recursion coefficients per axis/side (components/boundary.py profiles).
* Dispersive pole slots: per (medium, pole) a scalar ``a`` and per-cell
  complex residue map ``c`` for the ADE update.
* Source plans: static index slices + spatial profiles + per-step waveforms.
* Monitor plans: static slices + DFT kernels (with apodization) or
  time-sampling strides.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..components.boundary import (
    Absorber,
    AbsorberSpec,
    BlochBoundary,
    PECBoundary,
    Periodic,
    PML,
    PMCBoundary,
    StablePML,
)
from ..components.medium import (
    AbstractMedium,
    AnisotropicMedium,
    CustomMedium,
    DispersiveMedium,
    Medium,
    PECMedium,
    PoleResidue,
)
from ..components.monitor import (
    AbstractFieldProjectionMonitor,
    DiffractionMonitor,
    FieldMonitor,
    FieldTimeMonitor,
    FluxMonitor,
    FluxTimeMonitor,
    ModeMonitor,
    ModeSolverMonitor,
    Monitor,
    PermittivityMonitor,
)
from ..components.simulation import Simulation
from ..components.source import (
    AstigmaticGaussianBeam,
    CustomCurrentSource,
    CustomFieldSource,
    GaussianBeam,
    ModeSource,
    PlaneWave,
    PointDipole,
    TFSF,
    UniformCurrentSource,
)
from ..constants import C_0, EPSILON_0, ETA_0, MU_0, pec_val
from ..exceptions import SetupError
from ..log import log
from . import cpml as cpml_mod
from .lowering_utils import slices_for_box as _slices_for_box_util
from .lowering_utils import yee_coords

E_COMPS = ("Ex", "Ey", "Ez")
H_COMPS = ("Hx", "Hy", "Hz")

# boundary kinds per axis side
BK_PERIODIC = "periodic"
BK_PEC = "pec"
BK_PMC = "pmc"


# --------------------------------------------------------------------------- #
# plan dataclasses (host-side; converted to jnp by the runner)
# --------------------------------------------------------------------------- #


@dataclass
class PolePlan:
    """One global dispersive pole slot: scalar pole `a` plus a compressed
    per-component residue.

    Library media (Au/Ag/... PoleResidue fits) are uniform inside their
    structure's support, so the residue of component ``ci`` is the scalar
    ``c_vals[ci]`` times the shared boolean indicator
    ``plan.pole_masks[mask_ids[ci]]`` (``mask_ids[ci] < 0`` means zero
    support for that component). All poles of one structure share the same
    masks, so a 7-pole metal ships 3 bool masks + 21 complex scalars
    instead of 42 full-grid f32 maps (the round-3 dense layout measured
    5.4 GB of jit arguments at 256^3 x 7 poles and HBM-OOM'd; reference
    pole model: tidy3d/components/medium.py:2843).

    ``c_maps`` (dense per-cell complex maps) is the fallback for spatially
    varying residues and takes precedence when set."""

    a: complex
    c_vals: Tuple[complex, complex, complex] = (0j, 0j, 0j)
    mask_ids: Tuple[int, int, int] = (-1, -1, -1)
    c_maps: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None

    def dense_c_maps(self, pole_masks, shape) -> Tuple[np.ndarray, ...]:
        """Materialize full-grid complex residue maps (tests/debug)."""
        if self.c_maps is not None:
            return self.c_maps
        out = []
        for ci in range(3):
            mid = self.mask_ids[ci]
            if mid < 0:
                out.append(np.zeros(shape, np.complex64))
            else:
                out.append(np.where(pole_masks[mid], self.c_vals[ci],
                                    0j).astype(np.complex64))
        return tuple(out)


@dataclass
class SourcePlan:
    """Injection of one field component of one source."""

    comp: str                       # e.g. "Ex" (current J) or "Hx" (current M)
    slices: Tuple[slice, slice, slice]
    profile: np.ndarray             # spatial profile over the slice (complex or float)
    waveform_key: int               # index into the waveform table
    phase: complex = 1.0 + 0j       # extra static phase (e.g. H half-step factors)
    # waveform driving the imaginary field copy in complex (Bloch) runs: the
    # injected current is profile * (wf[waveform_key] + 1j wf[waveform_key_im])
    waveform_key_im: Optional[int] = None


@dataclass
class MonitorPlan:
    monitor: Monitor
    kind: str                       # 'field' | 'field_time' | 'permittivity' | 'mode'
    comps: Tuple[str, ...]
    slices: Dict[str, Tuple[slice, slice, slice]]
    coords: Dict[str, Dict[str, np.ndarray]]   # comp -> dim -> 1D coords
    freqs: Optional[np.ndarray] = None
    # time monitor info
    t_start: int = 0
    t_stop: int = 0
    t_interval: int = 1
    # postprocessing hooks
    surfaces: Optional[list] = None   # for flux: list of (axis, sign) sub-plans
    mode_info: Optional[dict] = None


@dataclass
class SimulationPlan:
    simulation: Simulation
    shape: Tuple[int, int, int]
    dt: float
    num_steps: int
    tmesh: np.ndarray
    # update coefficient arrays, keyed by component name
    coeffs_E: Dict[str, Tuple[np.ndarray, np.ndarray]]  # comp -> (Ca, Cb)
    coeffs_H: Dict[str, Tuple[np.ndarray, np.ndarray]]  # comp -> (Da, Db)
    # inverse steps: inv_primal[axis][i] = 1/(bound[i+1]-bound[i]),
    # inv_dual[axis][i] = 1/(center[i]-center[i-1]) (wrapped at 0)
    inv_primal: Tuple[np.ndarray, np.ndarray, np.ndarray]
    inv_dual: Tuple[np.ndarray, np.ndarray, np.ndarray]
    # CPML coefficients: per axis, for primal (H-update) and dual (E-update)
    pml_dual: Tuple[cpml_mod.PmlCoeffs1D, ...]
    pml_primal: Tuple[cpml_mod.PmlCoeffs1D, ...]
    # boundary kinds: [axis][side] in {periodic, pec, pmc}
    boundaries: Tuple[Tuple[str, str], ...]
    # bloch phases per axis (1.0 if not bloch)
    bloch_phases: Tuple[complex, complex, complex]
    # dispersive poles
    poles: List[PolePlan]
    # E-field coefficient for the ADE implicit term, per component (real)
    # (zero when no dispersive media)
    disp_ee: Optional[Dict[str, np.ndarray]]
    # nonlinear response maps (None when no nonlinear media): per-E-comp
    # chi3 [um^2/V^2] and TPA conductivity coefficient K [S*um/V^2] with
    # sigma_NL = K * E^2, plus the fixed-point iteration count
    nonlinear: Optional[dict]
    # time-modulation entries (None when absent): list of dicts with keys
    # freq0/phase/amplitude (time part) and eps_maps/sigma_maps: per-E-comp
    # (M1, M2) spatial maps so that delta(x, t) = M1 cos(wt+p) - M2 sin(wt+p)
    modulation: Optional[list]
    # sources
    sources: List[SourcePlan]
    waveforms: np.ndarray           # (num_waveforms, num_steps) float32/complex
    # monitors
    monitors: List[MonitorPlan]
    # is the simulation complex-valued (bloch phases != 1)
    is_complex: bool
    # eps arrays used for permittivity monitors: comp -> np.ndarray
    eps_yee: Optional[Dict[str, np.ndarray]] = None
    # shared boolean pole-support indicators referenced by PolePlan.mask_ids
    pole_masks: List[np.ndarray] = field(default_factory=list)


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #


def _comp_axes(comp: str) -> Tuple[int, int, int]:
    """(own axis a, other axes b, c in cyclic order a->b->c)."""
    a = "xyz".index(comp[1])
    b, c = (a + 1) % 3, (a + 2) % 3
    return a, b, c


_slices_for_box = _slices_for_box_util


# --------------------------------------------------------------------------- #
# main lowering entry
# --------------------------------------------------------------------------- #


def lower(simulation: Simulation) -> SimulationPlan:
    """Lower a Simulation into a SimulationPlan."""
    grid = simulation.grid
    nx, ny, nz = grid.num_cells
    shape = (nx, ny, nz)
    dt = simulation.dt
    tmesh = simulation.tmesh
    num_steps = len(tmesh)

    bounds = {d: np.asarray(v) for d, v in grid.boundaries.to_dict.items()}
    centers = {d: 0.5 * (v[1:] + v[:-1]) for d, v in bounds.items()}

    # inverse steps
    inv_primal = []
    inv_dual = []
    for axis, dim in enumerate("xyz"):
        primal = np.diff(bounds[dim])
        cen = centers[dim]
        dual = np.empty_like(primal)
        if len(cen) > 1:
            dual[1:] = cen[1:] - cen[:-1]
            # wrap distance for index 0 (periodic); for walls value is unused
            span = bounds[dim][-1] - bounds[dim][0]
            dual[0] = cen[0] + span - cen[-1]
        else:
            dual[0] = primal[0]
        inv_primal.append((1.0 / primal).astype(np.float64))
        inv_dual.append((1.0 / dual).astype(np.float64))

    # ------------------------------------------------------------------ #
    # boundaries
    # ------------------------------------------------------------------ #
    boundaries = []
    bloch_phases = []
    pml_dual = []
    pml_primal = []
    for axis, dim in enumerate("xyz"):
        minus, plus = simulation.boundary_spec.to_list[axis]
        kinds = []
        for bc in (minus, plus):
            if isinstance(bc, (Periodic, BlochBoundary)):
                kinds.append(BK_PERIODIC)
            elif isinstance(bc, PMCBoundary):
                kinds.append(BK_PMC)
            else:
                kinds.append(BK_PEC)  # PEC wall (also terminates PML/absorber)
        boundaries.append(tuple(kinds))
        phase = 1.0 + 0j
        if isinstance(minus, BlochBoundary):
            phase = complex(minus.bloch_phase)
        bloch_phases.append(phase)

        # pml coefficient profiles at dual (E-update) and primal (H-update) pts
        n_lo = minus.num_layers if isinstance(minus, (PML, StablePML)) else 0
        n_hi = plus.num_layers if isinstance(plus, (PML, StablePML)) else 0
        p_lo = minus.parameters if isinstance(minus, (PML, StablePML)) else None
        p_hi = plus.parameters if isinstance(plus, (PML, StablePML)) else None
        # E update: derivative of H along `axis` lives at boundary-located
        # positions (bounds[:-1]); H update: derivative of E at centers.
        pml_dual.append(cpml_mod.make_pml_coeffs(
            bounds[dim][:-1], bounds[dim], n_lo, n_hi, p_lo, p_hi, dual=True))
        pml_primal.append(cpml_mod.make_pml_coeffs(
            centers[dim], bounds[dim], n_lo, n_hi, p_lo, p_hi, dual=False))

    is_complex = any(abs(p - 1.0) > 1e-12 for p in bloch_phases)

    # ------------------------------------------------------------------ #
    # material coefficient arrays
    # ------------------------------------------------------------------ #
    freq0 = None
    if simulation.sources:
        freq0 = float(np.mean([s.source_time.freq0 for s in simulation.sources]))

    (eps_arrays, sigma_arrays, pole_plans, pole_masks, disp_ee, nonlinear,
     modulation) = _material_arrays(simulation, freq0)

    # absorber magnetic/electric conductivity profiles
    abs_sigma = _absorber_profiles(simulation, bounds, centers, dt)

    coeffs_E = {}
    coeffs_H = {}
    for ci, comp in enumerate(E_COMPS):
        eps_r = eps_arrays[comp]
        sigma = sigma_arrays[comp]
        # add absorber electric conductivity (rate sigma/eps0) as sigma
        sigma_rate = sigma / (EPSILON_0 * np.real(eps_r)) + abs_sigma[comp]
        # dispersive pole coupling term in the semi-implicit ADE update:
        # lambda_p = Re(a B) + eps0 Re(c), B = eps0 c dt/2 / (1 - a dt/2)
        for pole in pole_plans:
            a = pole.a
            if pole.c_maps is not None:
                c_map = pole.c_maps[ci]
                if not np.any(c_map):
                    continue
                B = EPSILON_0 * c_map * (dt / 2.0) / (1.0 - a * dt / 2.0)
                lam = np.real(a * B) + EPSILON_0 * np.real(c_map)
                sigma_rate = sigma_rate \
                    + 2.0 * lam / (EPSILON_0 * np.real(eps_r))
                continue
            mid = pole.mask_ids[ci]
            c = pole.c_vals[ci]
            if mid < 0 or c == 0:
                continue
            B = EPSILON_0 * c * (dt / 2.0) / (1.0 - a * dt / 2.0)
            lam = float(np.real(a * B) + EPSILON_0 * np.real(c))
            mask = pole_masks[mid]
            term = 2.0 * lam / (EPSILON_0 * np.real(eps_r))
            # uniform-support poles (mask all-ones) keep scalar coeffs
            sigma_rate = sigma_rate + (term if mask.all()
                                       else term * mask)
        pec_mask = eps_r.real <= 0.5 * pec_val  # marked PEC cells
        loss = sigma_rate * dt / 2.0
        ca = (1.0 - loss) / (1.0 + loss)
        cb = dt / (EPSILON_0 * np.real(np.where(pec_mask, 1.0, eps_r))) / (1.0 + loss)
        ca = np.where(pec_mask, 0.0, ca)
        cb = np.where(pec_mask, 0.0, cb)
        # (PEC domain walls are enforced in the stepping core via cheap 1D
        # edge masks, keeping these coefficient arrays spatially uniform for
        # uniform media.)
        coeffs_E[comp] = (ca.astype(np.float32), cb.astype(np.float32))

    for comp in H_COMPS:
        # magnetic loss only from absorber profiles
        sigma_m = abs_sigma[comp]
        loss = sigma_m * dt / 2.0
        da = np.asarray((1.0 - loss) / (1.0 + loss))
        db = np.asarray((dt / MU_0) / (1.0 + loss))
        coeffs_H[comp] = (da.astype(np.float32), db.astype(np.float32))

    # ------------------------------------------------------------------ #
    # sources
    # ------------------------------------------------------------------ #
    source_plans, waveforms = _lower_sources(simulation, grid, tmesh, dt)

    # ------------------------------------------------------------------ #
    # monitors
    # ------------------------------------------------------------------ #
    monitor_plans = _lower_monitors(simulation, grid, tmesh, dt)

    eps_yee = {comp: eps_arrays[comp] for comp in E_COMPS}

    return SimulationPlan(
        simulation=simulation, shape=shape, dt=dt, num_steps=num_steps, tmesh=tmesh,
        coeffs_E=coeffs_E, coeffs_H=coeffs_H,
        inv_primal=tuple(inv_primal), inv_dual=tuple(inv_dual),
        pml_dual=tuple(pml_dual), pml_primal=tuple(pml_primal),
        boundaries=tuple(boundaries), bloch_phases=tuple(bloch_phases),
        poles=pole_plans, disp_ee=disp_ee, nonlinear=nonlinear, modulation=modulation,
        sources=source_plans, waveforms=waveforms,
        monitors=monitor_plans, is_complex=is_complex, eps_yee=eps_yee,
        pole_masks=pole_masks,
    )


# --------------------------------------------------------------------------- #
# materials
# --------------------------------------------------------------------------- #


def _medium_static_eps_sigma(medium: AbstractMedium, comp_index: int,
                             freq0: Optional[float]) -> Tuple[float, float, list]:
    """(eps_inf-like real eps, conductivity, poles) of a medium component for
    the time-domain update."""
    if isinstance(medium, PECMedium):
        return pec_val, 0.0, []
    if isinstance(medium, AnisotropicMedium):
        sub = (medium.xx, medium.yy, medium.zz)[comp_index]
        return _medium_static_eps_sigma(sub, comp_index, freq0)
    if isinstance(medium, Medium):
        return medium.permittivity, medium.conductivity, []
    if isinstance(medium, DispersiveMedium):
        pr = medium.pole_residue if not isinstance(medium, PoleResidue) else medium
        eps_inf = float(np.real(pr.eps_inf)) if np.ndim(pr.eps_inf) == 0 else 1.0
        sigma = 0.0
        poles = []
        for a, c in pr.poles:
            a = complex(a)
            c = complex(c)
            if a == 0 and abs(c.imag) < abs(c.real) * 1e-12:
                # pure conductivity pole: sigma = 2 eps0 Re(c)
                sigma += 2 * EPSILON_0 * c.real
            else:
                poles.append((a, c))
        return eps_inf, sigma, poles
    if isinstance(medium, CustomMedium):
        # handled separately (spatial); fall back to mean for coefficients
        return float(np.mean(medium.permittivity.values)), (
            float(np.mean(medium.conductivity.values))
            if medium.conductivity is not None else 0.0
        ), []
    # other media: evaluate at source frequency
    if freq0 is not None:
        eps_c = medium.eps_diagonal(freq0)[comp_index]
        eps, sigma = AbstractMedium.eps_complex_to_eps_sigma(eps_c, freq0)
        return float(np.real(eps)), float(sigma), []
    return 1.0, 0.0, []


def _material_arrays(simulation: Simulation, freq0: Optional[float]):
    """Per-component eps/sigma arrays with SDF subpixel averaging, plus
    dispersive pole plans."""
    grid = simulation.grid
    shape = grid.num_cells
    structures = list(simulation.volumetric_structures)

    eps_arrays = {}
    sigma_arrays = {}
    # pole slots: one per (structure medium, pole); background too
    pole_slots: List[Tuple[complex, complex, Dict[str, np.ndarray]]] = []

    # local dl scale for subpixel fraction: use average cell size per axis
    avg_dl = [float(np.mean(np.diff(np.asarray(grid.boundaries.to_list[a]))))
              for a in range(3)]
    # the subpixel smear width must come from REAL axes only: a zero-size
    # (2D) axis carries one placeholder cell of ZERO_DIM_CELL_SIZE whose
    # inclusion would fix the interface transition width at ~1/3 um
    # regardless of dl (order-0 convergence; caught by
    # scripts/subpixel_convergence.py)
    real_axes = [a for a in range(3) if grid.num_cells[a] > 1]
    dl_subpixel = float(np.mean([avg_dl[a] for a in real_axes])) \
        if real_axes else float(np.mean(avg_dl))

    # pole bookkeeping, compressed: per source structure (or 'bg') ONE
    # boolean support mask per component — shared by every pole of that
    # structure — plus per-pole scalar (a, c) values per component.
    # Dense maps are never materialized for uniform media (a 7-pole metal
    # at 256^3 shipped 2.8 GB of residue maps in the dense layout).
    pole_mask_acc: Dict[object, Dict[str, np.ndarray]] = {}
    pole_defs: Dict[Tuple[object, int], Dict[int, Tuple[complex, complex]]] \
        = {}

    chi3_arrays: Dict[str, np.ndarray] = {}
    ktpa_arrays: Dict[str, np.ndarray] = {}
    nl_num_iters = 0

    # per-structure modulation entries: si -> entry dict
    mod_entries: Dict[int, dict] = {}

    for ci, comp in enumerate(E_COMPS):
        coords = yee_coords(grid, comp)
        xs, ys, zs = coords["x"], coords["y"], coords["z"]
        bg_eps, bg_sigma, bg_poles = _medium_static_eps_sigma(
            simulation.medium, ci, freq0)
        # Lazy materialization: stay scalar (0-d) until a structure actually
        # writes spatial variation. Full-volume allocations are expensive on
        # paged-memory hosts (see _malloc.py) and pure-background components
        # never need them — the runner compacts uniform arrays to scalars
        # anyway. f32 is the solver's coefficient precision.
        eps = np.float32(bg_eps)
        sigma = np.float32(bg_sigma)
        chi3 = np.float32(0.0)
        ktpa = np.float32(0.0)

        def _mat(arr):
            """Materialize a lazy scalar to a full-volume f32 array."""
            if np.ndim(arr) == 0:
                return np.full(shape, arr, dtype=np.float32)
            return arr
        if bg_poles:
            pole_mask_acc.setdefault("bg", {})[comp] = \
                np.ones(shape, dtype=bool)
            for pole_id, (a, c) in enumerate(bg_poles):
                pole_defs.setdefault(("bg", pole_id), {})[ci] = (a, c)

        for si, structure in enumerate(structures):
            geometry = structure.geometry
            medium = structure.medium
            rmin, rmax = geometry.bounds
            ix = _crop_inds(xs, rmin[0], rmax[0], avg_dl[0])
            iy = _crop_inds(ys, rmin[1], rmax[1], avg_dl[1])
            iz = _crop_inds(zs, rmin[2], rmax[2], avg_dl[2])
            if ix is None or iy is None or iz is None:
                continue
            sl = np.ix_(ix, iy, iz)
            xg, yg, zg = np.meshgrid(xs[ix], ys[iy], zs[iz], indexing="ij", sparse=True)

            s_eps, s_sigma, s_poles = _medium_static_eps_sigma(medium, ci, freq0)
            is_pec = isinstance(medium, PECMedium) or s_eps <= 0.5 * pec_val

            # per-material-type subpixel scheme (reference schema:
            # subpixel_spec.py:15-117; scheme selection actually changes
            # the lowered arrays — tested by the convergence-order suite)
            from ..components.subpixel_spec import (
                PECConformal,
                PolarizedAveraging,
                VolumetricAveraging,
            )

            sp_spec = simulation.subpixel_spec
            scheme = sp_spec.pec if is_pec else sp_spec.dielectric
            smooth_ok = (not s_poles
                         and not getattr(medium, "is_custom", False)
                         and not isinstance(medium, AnisotropicMedium))
            use_polarized = (not is_pec and smooth_ok
                             and isinstance(scheme, PolarizedAveraging))
            use_volumetric = (not is_pec and smooth_ok
                              and isinstance(scheme, VolumetricAveraging))
            use_conformal = is_pec and isinstance(scheme, PECConformal)
            if use_polarized or use_volumetric:
                sdf = geometry.sdf(xg, yg, zg)
                sdf = np.broadcast_to(sdf, (len(ix), len(iy), len(iz)))
                dl_loc = dl_subpixel
                frac = np.clip(0.5 - sdf / dl_loc, 0.0, 1.0)
                if np.all(frac == 0):
                    continue
                eps, sigma = _mat(eps), _mat(sigma)
                eps_old = eps[sl]
                eps_arith = frac * s_eps + (1 - frac) * eps_old
                if use_volumetric:
                    # straight volume-fraction averaging for every component
                    eps_new = eps_arith
                else:
                    # polarized: harmonic along the interface normal (from
                    # the SDF gradient), arithmetic transverse
                    grads = np.gradient(sdf, xs[ix], ys[iy], zs[iz],
                                        edge_order=1) \
                        if min(len(ix), len(iy), len(iz)) > 1 \
                        else [np.zeros_like(sdf)] * 3
                    gnorm = np.sqrt(sum(g**2 for g in grads)) + 1e-30
                    n_comp = grads[ci] / gnorm
                    eps_harm = 1.0 / (frac / s_eps
                                      + (1 - frac) / np.maximum(eps_old, 1e-6))
                    w_n = n_comp**2
                    eps_new = (1 - w_n) * eps_arith + w_n * eps_harm
                eps[sl] = eps_new
                sigma[sl] = frac * s_sigma + (1 - frac) * sigma[sl]
            elif use_conformal:
                # Benkler-style conformal PEC (first-order edge variant):
                # an E edge fully inside the metal is pinned (PEC value);
                # a partially covered edge keeps only its free length, so
                # its update stiffens by 1/f_free — realized as an
                # effective eps_bg/f_free on that edge. Stability is paid
                # for by the scheme's timestep_reduction (Simulation.dt).
                dl_ci = avg_dl[ci]
                off = np.zeros(3)
                off[ci] = 0.5 * dl_ci
                pts = np.meshgrid(xs[ix], ys[iy], zs[iz], indexing="ij",
                                  sparse=True)
                sdf_a = np.broadcast_to(geometry.sdf(
                    pts[0] - off[0], pts[1] - off[1], pts[2] - off[2]),
                    (len(ix), len(iy), len(iz)))
                sdf_b = np.broadcast_to(geometry.sdf(
                    pts[0] + off[0], pts[1] + off[1], pts[2] + off[2]),
                    (len(ix), len(iy), len(iz)))
                inside_both = (sdf_a <= 0) & (sdf_b <= 0)
                partial = ((sdf_a <= 0) ^ (sdf_b <= 0))
                if not np.any(inside_both | partial):
                    continue
                eps, sigma = _mat(eps), _mat(sigma)
                denom = np.abs(sdf_a) + np.abs(sdf_b) + 1e-30
                f_free = np.where(sdf_a > 0, sdf_a, sdf_b) / denom
                f_free = np.clip(f_free, 0.0, 1.0)
                F_MIN = 0.05
                eps_part = eps[sl] / np.maximum(f_free, F_MIN)
                eps_new = np.where(inside_both | (partial
                                                  & (f_free < F_MIN)),
                                   np.float32(pec_val), eps[sl])
                eps_new = np.where(partial & (f_free >= F_MIN), eps_part,
                                   eps_new)
                eps[sl] = eps_new
            else:
                mask = np.broadcast_to(geometry.inside(xg, yg, zg),
                                       (len(ix), len(iy), len(iz)))
                if not np.any(mask):
                    continue
                eps, sigma = _mat(eps), _mat(sigma)
                if getattr(medium, "is_custom", False) and hasattr(
                        medium, "eps_dataarray_freq") and freq0 is not None:
                    comp_arr = medium.eps_dataarray_freq(freq0)[ci]
                    interp_method = getattr(medium, "interp_method", "nearest")
                    vals = comp_arr.interp(
                        x=xs[ix], y=ys[iy], z=zs[iz], method=interp_method,
                    ).values
                    eps_val = np.real(vals)
                    sig_val = np.imag(vals) * 2 * np.pi * freq0 * EPSILON_0
                    eps[sl] = np.where(mask, eps_val, eps[sl])
                    sigma[sl] = np.where(mask, sig_val, sigma[sl])
                else:
                    eps[sl] = np.where(mask, s_eps, eps[sl])
                    sigma[sl] = np.where(mask, s_sigma, sigma[sl])
                # dispersive poles of this structure: record ONE support
                # mask per (structure, comp) shared by all its poles
                full_mask = np.zeros(shape, dtype=bool)
                full_mask[sl] = mask
                if s_poles:
                    acc = pole_mask_acc.setdefault(si, {})
                    if comp in acc:
                        acc[comp] |= full_mask
                    else:
                        acc[comp] = full_mask.copy()
                    for pole_id, (a, c) in enumerate(s_poles):
                        pole_defs.setdefault((si, pole_id), {})[ci] = (a, c)
                # structures on top clear underlying poles
                for skey, comp_masks in pole_mask_acc.items():
                    if skey != si and comp in comp_masks:
                        comp_masks[comp][full_mask] = False

            # nonlinear response of this structure (mask-based; applied on
            # top of whichever eps path was used above)
            nl_models = getattr(medium, "_nonlinear_models", []) or []
            if nl_models:
                from ..components.medium import (
                    KerrNonlinearity,
                    NonlinearSpec,
                    NonlinearSusceptibility,
                    TwoPhotonAbsorption,
                )

                spec = medium.nonlinear_spec
                iters = spec.num_iters if isinstance(spec, NonlinearSpec) else 5
                nl_num_iters = max(nl_num_iters, int(iters))
                nl_mask = np.broadcast_to(geometry.inside(xg, yg, zg),
                                          (len(ix), len(iy), len(iz)))
                n0_lin = float(np.sqrt(max(s_eps, 1e-12)))
                chi3_val = 0.0
                ktpa_val = 0.0
                for model in nl_models:
                    if isinstance(model, NonlinearSusceptibility):
                        chi3_val += float(model.chi3)
                    elif isinstance(model, KerrNonlinearity):
                        n0 = float(np.real(model.n0)) if model.n0 is not None \
                            else n0_lin
                        # n2 [um^2/W] -> chi3 [um^2/V^2]
                        chi3_val += (4.0 / 3.0) * n0**2 * EPSILON_0 * C_0 \
                            * float(np.real(model.n2))
                    elif isinstance(model, TwoPhotonAbsorption):
                        n0 = float(np.real(model.n0)) if model.n0 is not None \
                            else n0_lin
                        # sigma_NL = beta c^2 eps0^2 n0^2 E_inst^2 gives the
                        # cycle-averaged absorption alpha = beta I
                        ktpa_val += float(np.real(model.beta)) * C_0**2 \
                            * EPSILON_0**2 * n0**2
                if chi3_val:
                    chi3 = _mat(chi3)
                    chi3[sl] = np.where(nl_mask, chi3_val, chi3[sl])
                if ktpa_val:
                    ktpa = _mat(ktpa)
                    ktpa[sl] = np.where(nl_mask, ktpa_val, ktpa[sl])

            # time modulation of this structure's medium
            mod_spec = getattr(medium, "modulation_spec", None)
            if mod_spec is not None and getattr(mod_spec, "applied_modulation",
                                                False):
                from ..components.data.data_array import SpatialDataArray

                entry = mod_entries.setdefault(si, dict(
                    eps_maps={}, sigma_maps={}))
                mod_mask = np.broadcast_to(geometry.inside(xg, yg, zg),
                                           (len(ix), len(iy), len(iz)))

                def _spatial(stm, what):
                    """(M1, M2) = A_s (cos phi_s, sin phi_s) on this comp."""
                    sm = stm.space_modulation
                    amp = getattr(sm, "amplitude", 1.0)
                    ph = getattr(sm, "phase", 0.0)
                    if isinstance(amp, SpatialDataArray):
                        amp = amp.interp(x=xs[ix], y=ys[iy], z=zs[iz],
                                         method=getattr(sm, "interp_method",
                                                        "nearest"),
                                         kwargs=dict(fill_value=0.0)).values
                    if isinstance(ph, SpatialDataArray):
                        ph = ph.interp(x=xs[ix], y=ys[iy], z=zs[iz],
                                       method=getattr(sm, "interp_method",
                                                      "nearest"),
                                       kwargs=dict(fill_value=0.0)).values
                    m1 = np.zeros(shape)
                    m2 = np.zeros(shape)
                    m1_loc = np.where(mod_mask, amp * np.cos(ph), 0.0)
                    m2_loc = np.where(mod_mask, amp * np.sin(ph), 0.0)
                    m1[sl] = np.broadcast_to(m1_loc, m1[sl].shape)
                    m2[sl] = np.broadcast_to(m2_loc, m2[sl].shape)
                    maps = entry[what].setdefault(comp, [np.zeros(shape),
                                                         np.zeros(shape)])
                    maps[0] = maps[0] + m1
                    maps[1] = maps[1] + m2

                if mod_spec.permittivity is not None and not \
                        mod_spec.permittivity.negligible_modulation:
                    stm = mod_spec.permittivity
                    tm = stm.time_modulation
                    entry["eps_freq"] = float(tm.freq0)
                    entry["eps_phase"] = float(tm.phase)
                    entry["eps_amp"] = float(tm.amplitude)
                    _spatial(stm, "eps_maps")
                if mod_spec.conductivity is not None and not \
                        mod_spec.conductivity.negligible_modulation:
                    stm = mod_spec.conductivity
                    tm = stm.time_modulation
                    entry["sigma_freq"] = float(tm.freq0)
                    entry["sigma_phase"] = float(tm.phase)
                    entry["sigma_amp"] = float(tm.amplitude)
                    _spatial(stm, "sigma_maps")

        eps_arrays[comp] = np.asarray(eps)
        sigma_arrays[comp] = np.asarray(sigma)
        if np.any(chi3 != 0):
            chi3_arrays[comp] = _mat(chi3)
        if np.any(ktpa != 0):
            ktpa_arrays[comp] = _mat(ktpa)

    # build compressed pole plans: dedup support masks, split any
    # anisotropic pole whose `a` differs between components
    pole_plans: List[PolePlan] = []
    pole_masks: List[np.ndarray] = []
    disp_ee: Dict[str, np.ndarray] = {}
    mask_index: Dict[Tuple[object, str], int] = {}

    def _mask_id(skey, comp) -> int:
        key = (skey, comp)
        if key in mask_index:
            return mask_index[key]
        m = pole_mask_acc.get(skey, {}).get(comp)
        mid = -1
        if m is not None and m.any():
            for i, ex in enumerate(pole_masks):
                if np.array_equal(ex, m):
                    mid = i
                    break
            else:
                pole_masks.append(m)
                mid = len(pole_masks) - 1
        mask_index[key] = mid
        return mid

    for (skey, _pid), per_comp in pole_defs.items():
        for a_val in dict.fromkeys(a for a, _ in per_comp.values()):
            c_vals = []
            mids = []
            for ci2, comp in enumerate(E_COMPS):
                ac = per_comp.get(ci2)
                if ac is None or ac[0] != a_val:
                    c_vals.append(0j)
                    mids.append(-1)
                    continue
                mid = _mask_id(skey, comp)
                c_vals.append(ac[1] if mid >= 0 else 0j)
                mids.append(mid if ac[1] != 0 else -1)
            if any(m >= 0 for m in mids):
                pole_plans.append(PolePlan(
                    a=a_val, c_vals=tuple(c_vals), mask_ids=tuple(mids)))
    nonlinear = None
    if chi3_arrays or ktpa_arrays:
        nonlinear = dict(chi3=chi3_arrays, ktpa=ktpa_arrays,
                         num_iters=max(nl_num_iters, 1))
    modulation = list(mod_entries.values()) or None
    return (eps_arrays, sigma_arrays, pole_plans, pole_masks,
            (disp_ee or None), nonlinear, modulation)


def _crop_inds(coords: np.ndarray, lo: float, hi: float, pad: float):
    inds = np.nonzero((coords >= lo - pad) & (coords <= hi + pad))[0]
    if len(inds) == 0:
        return None
    return inds


def _absorber_profiles(simulation, bounds, centers, dt):
    """Electric/magnetic conductivity-rate arrays from Absorber boundaries."""
    shape = tuple(len(bounds[d]) - 1 for d in "xyz")
    # scalar zeros unless an Absorber boundary exists (lazy materialization —
    # full-volume allocations are expensive on paged-memory hosts)
    profiles = {comp: np.float32(0.0) for comp in E_COMPS + H_COMPS}
    for axis, dim in enumerate("xyz"):
        minus, plus = simulation.boundary_spec.to_list[axis]
        n_lo = minus.num_layers if isinstance(minus, Absorber) else 0
        n_hi = plus.num_layers if isinstance(plus, Absorber) else 0
        if n_lo == 0 and n_hi == 0:
            continue
        p_lo = minus.parameters if isinstance(minus, Absorber) else None
        p_hi = plus.parameters if isinstance(plus, Absorber) else None
        for comp in E_COMPS + H_COMPS:
            coords = yee_coords(simulation.grid, comp)[dim]
            prof = cpml_mod.absorber_sigma_profile(coords, n_lo, n_hi, p_lo, p_hi, dt)
            reshape = [1, 1, 1]
            reshape[axis] = len(prof)
            profiles[comp] = profiles[comp] + prof.reshape(reshape)
    return profiles


# --------------------------------------------------------------------------- #
# sources
# --------------------------------------------------------------------------- #


def _lower_sources(simulation, grid, tmesh, dt):
    """Lower sources to injection plans + waveform table."""
    plans: List[SourcePlan] = []
    waveform_list: List[np.ndarray] = []

    def add_waveform(values: np.ndarray) -> int:
        waveform_list.append(np.asarray(values))
        return len(waveform_list) - 1

    for source in simulation.sources:
        st = source.source_time
        # J injected in E update at integer steps; waveform evaluated at
        # t_n + dt/2 (current between E^n and E^{n+1}), standard staggering
        amp_e = st.amp_time(tmesh + dt / 2)
        wf_key = add_waveform(np.real(amp_e))
        wf_key_im = (add_waveform(np.imag(amp_e))
                     if np.max(np.abs(np.imag(amp_e))) > 0 else None)

        if isinstance(source, (PointDipole, UniformCurrentSource)):
            comp = source.polarization
            plans.extend(_current_source_plans(grid, source, comp, wf_key,
                                               wf_key_im))
        elif isinstance(source, CustomCurrentSource):
            plans.extend(_custom_current_plans(grid, source, tmesh, dt, add_waveform))
        elif isinstance(source, (PlaneWave, GaussianBeam, AstigmaticGaussianBeam,
                                 ModeSource, CustomFieldSource)):
            plans.extend(_field_source_plans(simulation, grid, source, tmesh, dt,
                                             add_waveform))
        elif isinstance(source, TFSF):
            plans.extend(_tfsf_plans(simulation, grid, source, tmesh, dt,
                                     add_waveform))
        else:
            log.warning(f"source type {type(source).__name__} not lowered yet.")

    num_steps = len(tmesh)
    if waveform_list:
        is_c = any(np.iscomplexobj(w) for w in waveform_list)
        dtype = np.complex64 if is_c else np.float32
        waveforms = np.zeros((len(waveform_list), num_steps), dtype=dtype)
        for i, w in enumerate(waveform_list):
            waveforms[i, :len(w)] = w[:num_steps]
    else:
        waveforms = np.zeros((1, num_steps), dtype=np.float32)
    return plans, waveforms


def _current_source_plans(grid, source, comp: str, wf_key: int,
                          wf_key_im: Optional[int] = None) -> List[SourcePlan]:
    """Current source: inject J at Yee points of `comp` within the source box,
    with linear interpolation weights for off-grid positions."""
    coords_all = yee_coords(grid, comp)
    shape = grid.num_cells
    slices = []
    weights = []
    for axis, dim in enumerate("xyz"):
        coords = coords_all[dim]
        lo = source.bounds[0][axis]
        hi = source.bounds[1][axis]
        if hi - lo <= 0:  # point-like along this axis: interpolate 2 neighbors
            pos = source.center[axis]
            idx = int(np.clip(np.searchsorted(coords, pos) - 1, 0, len(coords) - 2))
            if getattr(source, "interpolate", True) and len(coords) > 1:
                w_hi = (pos - coords[idx]) / (coords[idx + 1] - coords[idx])
                w_hi = float(np.clip(w_hi, 0.0, 1.0))
                slices.append(slice(idx, idx + 2))
                weights.append(np.array([1.0 - w_hi, w_hi]))
            else:
                idx_near = int(np.argmin(np.abs(coords - pos)))
                slices.append(slice(idx_near, idx_near + 1))
                weights.append(np.array([1.0]))
        else:
            inds = np.nonzero((coords >= lo) & (coords <= hi))[0]
            if len(inds) == 0:
                inds = np.array([int(np.argmin(np.abs(coords - source.center[axis])))])
            slices.append(slice(int(inds[0]), int(inds[-1]) + 1))
            weights.append(np.ones(len(inds)))
    profile = (weights[0][:, None, None] * weights[1][None, :, None]
               * weights[2][None, None, :]).astype(np.float32)
    return [SourcePlan(comp=comp, slices=tuple(slices), profile=profile,
                       waveform_key=wf_key, waveform_key_im=wf_key_im)]


def _sheet_plans(grid, source_time, tmesh, dt, add_waveform, fields,
                 plane_axis: int, sign: float, amp_fn=None) -> List[SourcePlan]:
    """Equivalence-current sheets from field profiles on one plane:
    J_s = -n x H, M_s = +n x E with n = sign * e_axis; the wave appears on the
    +n side of the sheet. Component form with cyclic (a, b, c):
    J_b = +n_a H_c, J_c = -n_a H_b, M_b = -n_a E_c, M_c = +n_a E_b."""
    a = plane_axis
    b, c = (a + 1) % 3, (a + 2) % 3

    # surface current -> volume current: divide by the cell thickness along
    # the normal at the injection plane (dual cell for E points, primal for H)
    bounds_a = np.asarray(grid.boundaries.to_list[a])
    primal_a = np.diff(bounds_a)
    centers_a = 0.5 * (bounds_a[1:] + bounds_a[:-1])

    def thickness(comp_out: str, slices) -> float:
        idx = slices[a].start
        if comp_out[0] == "E":
            if idx == 0 or len(centers_a) < 2:
                return float(primal_a[min(idx, len(primal_a) - 1)])
            return float(centers_a[idx] - centers_a[idx - 1])
        return float(primal_a[min(idx, len(primal_a) - 1)])

    plans: List[SourcePlan] = []
    for comp_out, src_field, factor, is_e in (
        (f"E{'xyz'[b]}", f"H{'xyz'[c]}", +sign, True),
        (f"E{'xyz'[c]}", f"H{'xyz'[b]}", -sign, True),
        (f"H{'xyz'[b]}", f"E{'xyz'[c]}", -sign, False),
        (f"H{'xyz'[c]}", f"E{'xyz'[b]}", +sign, False),
    ):
        if src_field not in fields or fields[src_field] is None:
            continue
        profile, slices = fields[src_field]["profile"], fields[src_field]["slices"]
        # inject Re(profile * complex_amp(t)); J drives the E update at half
        # steps, M drives the H update at the following integer step
        amp_time = amp_fn if amp_fn is not None else source_time.amp_time
        amp_t = amp_time((tmesh + dt / 2) if is_e else (tmesh + dt))
        has_im = np.max(np.abs(np.imag(amp_t))) > 0
        key_ar = add_waveform(np.real(amp_t))
        key_nai = add_waveform(-np.imag(amp_t))
        # imaginary-copy waveforms (complex Bloch runs): Im(P a) uses
        # +Im(a) against Re(P) and +Re(a) against Im(P)
        key_ai = add_waveform(np.imag(amp_t)) if has_im else None
        scale = factor / thickness(comp_out, slices)
        plans.append(SourcePlan(comp=comp_out, slices=slices,
                                profile=(scale * np.real(profile)).astype(np.float32),
                                waveform_key=key_ar, waveform_key_im=key_ai))
        if np.iscomplexobj(profile) and np.max(np.abs(np.imag(profile))) > 1e-12 * (
                np.max(np.abs(np.real(profile))) + 1e-300):
            plans.append(SourcePlan(comp=comp_out, slices=slices,
                                    profile=(scale * np.imag(profile)).astype(np.float32),
                                    waveform_key=key_nai, waveform_key_im=key_ar))
    return plans


def _field_source_plans(simulation, grid, source, tmesh, dt, add_waveform
                        ) -> List[SourcePlan]:
    """Unidirectional injection of a planar field source."""
    from .field_sources import (  # deferred: needs mode solver
        make_broadband_mode_fields,
        make_cheb_amp_fn,
        make_source_fields,
    )

    sign = 1.0 if source.direction == "+" else -1.0

    if isinstance(source, ModeSource) and getattr(source, "num_freqs", 1) > 1:
        # broadband injection: Chebyshev-order coefficient maps, each driven
        # by T_k applied to the source signal in the time domain
        plane_axis = tuple(source.size).index(0.0)
        coeff_fields, f0, bw = make_broadband_mode_fields(simulation, source,
                                                          plane_axis)
        plans: List[SourcePlan] = []
        for k, fields_k in enumerate(coeff_fields):
            amp_fn = make_cheb_amp_fn(source.source_time, k, f0, bw)
            plans.extend(_sheet_plans(grid, source.source_time, tmesh, dt,
                                      add_waveform, fields_k, plane_axis,
                                      sign, amp_fn=amp_fn))
        return plans

    try:
        fields, plane_axis = make_source_fields(simulation, source)
    except NotImplementedError as exc:
        log.warning(f"source '{getattr(source, 'name', None)}': {exc}; skipped.")
        return []
    return _sheet_plans(grid, source.source_time, tmesh, dt, add_waveform,
                        fields, plane_axis, sign)


def _tfsf_plans(simulation, grid, source, tmesh, dt, add_waveform
                ) -> List[SourcePlan]:
    """Total-field/scattered-field box: equivalence-current sheets on all six
    faces with inward normals reproduce the incident plane wave exactly inside
    the box and nothing outside (reference: source.py TFSF:1204)."""
    from .field_sources import make_tfsf_face_fields

    plans: List[SourcePlan] = []
    for face_axis in range(3):
        for side in ("-", "+"):
            fields = make_tfsf_face_fields(simulation, grid, source, face_axis,
                                           side)
            # inward normal: +axis on the '-' face, -axis on the '+' face
            sign = 1.0 if side == "-" else -1.0
            plans.extend(_sheet_plans(grid, source.source_time, tmesh, dt,
                                      add_waveform, fields, face_axis, sign))
    return plans


def _custom_current_plans(grid, source, tmesh, dt, add_waveform
                          ) -> List[SourcePlan]:
    """Volume injection of user-supplied J (E keys) / M (H keys) datasets."""
    dataset = source.current_dataset
    if dataset is None:
        return []
    get = (dataset.get if isinstance(dataset, dict)
           else lambda k: getattr(dataset, k, None))
    plans: List[SourcePlan] = []
    st = source.source_time
    for comp in E_COMPS + H_COMPS:
        arr = get(comp)
        if arr is None:
            continue
        sl, coords = _slices_for_box(grid, source, comp, extend=False)
        prof = arr.interp(x=coords["x"], y=coords["y"], z=coords["z"],
                          kwargs=dict(fill_value=0.0)).values
        prof = np.asarray(prof, dtype=np.complex64)
        if prof.ndim == 4:  # trailing frequency axis: take the first
            prof = prof[..., 0]
        is_e = comp in E_COMPS
        amp_t = st.amp_time((tmesh + dt / 2) if is_e else (tmesh + dt))
        has_im = np.max(np.abs(np.imag(amp_t))) > 0
        key_re = add_waveform(np.real(amp_t))
        key_nai = add_waveform(-np.imag(amp_t))
        key_ai = add_waveform(np.imag(amp_t)) if has_im else None
        plans.append(SourcePlan(comp=comp, slices=sl,
                                profile=np.real(prof).astype(np.float32),
                                waveform_key=key_re, waveform_key_im=key_ai))
        if np.max(np.abs(np.imag(prof))) > 1e-12 * (np.max(np.abs(np.real(prof)))
                                                    + 1e-300):
            plans.append(SourcePlan(comp=comp, slices=sl,
                                    profile=np.imag(prof).astype(np.float32),
                                    waveform_key=key_nai, waveform_key_im=key_re))
    return plans


# --------------------------------------------------------------------------- #
# monitors
# --------------------------------------------------------------------------- #


def _lower_monitors(simulation, grid, tmesh, dt) -> List[MonitorPlan]:
    plans: List[MonitorPlan] = []
    for monitor in simulation.monitors:
        if isinstance(monitor, (FieldMonitor,)):
            plans.append(_field_monitor_plan(grid, monitor, monitor.fields, "field"))
        elif isinstance(monitor, FieldTimeMonitor):
            plan = _field_monitor_plan(grid, monitor, monitor.fields, "field_time")
            beg, end = monitor.time_inds(tmesh)
            plan.t_start, plan.t_stop = beg, end
            plan.t_interval = monitor.interval or 1
            plans.append(plan)
        elif isinstance(monitor, PermittivityMonitor):
            plans.append(_field_monitor_plan(grid, monitor, E_COMPS, "permittivity"))
        elif isinstance(monitor, FluxMonitor):
            for surf in monitor.integration_surfaces:
                axis = tuple(surf.size).index(0.0)
                b, c = (axis + 1) % 3, (axis + 2) % 3
                comps = (f"E{'xyz'[b]}", f"E{'xyz'[c]}", f"H{'xyz'[b]}", f"H{'xyz'[c]}")
                plan = _field_monitor_plan(grid, surf, comps, "field")
                plan.mode_info = {"parent": monitor.name, "surface": surf.name,
                                  "axis": axis, "normal_dir": surf.normal_dir}
                plans.append(plan)
        elif isinstance(monitor, FluxTimeMonitor):
            for surf in monitor.integration_surfaces:
                axis = tuple(surf.size).index(0.0)
                b, c = (axis + 1) % 3, (axis + 2) % 3
                comps = (f"E{'xyz'[b]}", f"E{'xyz'[c]}", f"H{'xyz'[b]}", f"H{'xyz'[c]}")
                plan = _field_monitor_plan(grid, surf, comps, "field_time")
                beg, end = monitor.time_inds(tmesh)
                plan.t_start, plan.t_stop = beg, end
                plan.t_interval = monitor.interval or 1
                plan.mode_info = {"parent": monitor.name, "surface": surf.name,
                                  "axis": axis, "normal_dir": surf.normal_dir}
                plans.append(plan)
        elif isinstance(monitor, AbstractFieldProjectionMonitor):
            for surf in monitor.projection_surfaces:
                axis = tuple(surf.size).index(0.0)
                b, c = (axis + 1) % 3, (axis + 2) % 3
                comps = (f"E{'xyz'[b]}", f"E{'xyz'[c]}", f"H{'xyz'[b]}", f"H{'xyz'[c]}")
                plan = _field_monitor_plan(grid, surf, comps, "field")
                plan.mode_info = {"parent": monitor.name, "surface": surf.name,
                                  "axis": axis, "normal_dir": surf.normal_dir,
                                  "projection": True}
                plans.append(plan)
        elif isinstance(monitor, DiffractionMonitor):
            axis = tuple(monitor.size).index(0.0)
            b, c = (axis + 1) % 3, (axis + 2) % 3
            comps = (f"E{'xyz'[b]}", f"E{'xyz'[c]}", f"H{'xyz'[b]}", f"H{'xyz'[c]}")
            plan = _field_monitor_plan(grid, monitor, comps, "field")
            plan.mode_info = {"axis": axis, "diffraction": True}
            plans.append(plan)
        elif isinstance(monitor, (ModeMonitor, ModeSolverMonitor)):
            axis = tuple(monitor.size).index(0.0)
            b, c = (axis + 1) % 3, (axis + 2) % 3
            comps = tuple(f"{f}{'xyz'[ax]}" for f in "EH" for ax in (b, c)) + (
                f"E{'xyz'[axis]}", f"H{'xyz'[axis]}")
            plan = _field_monitor_plan(grid, monitor, comps, "field")
            plan.mode_info = {"axis": axis}
            plans.append(plan)
        else:
            log.warning(f"monitor '{monitor.name}' ({type(monitor).__name__}) "
                        "not lowered yet; it will have no data.")
    return plans


def _field_monitor_plan(grid, monitor, comps, kind) -> MonitorPlan:
    slices = {}
    coords = {}
    for comp in comps:
        sl, crd = _slices_for_box(grid, monitor, comp, extend=True)
        slices[comp] = sl
        coords[comp] = crd
    freqs = np.asarray(getattr(monitor, "freqs", [])) if hasattr(monitor, "freqs") \
        else None
    return MonitorPlan(monitor=monitor, kind=kind, comps=tuple(comps),
                       slices=slices, coords=coords, freqs=freqs)


# --------------------------------------------------------------------------- #
# kernel-alignment padding
# --------------------------------------------------------------------------- #


def pad_plan_for_kernels(plan: SimulationPlan, ndev_x: int = 1
                         ) -> Tuple[SimulationPlan, Tuple[int, int, int]]:
    """Pad the lowered domain with frozen cells so the Pallas kernels'
    alignment gates pass (PARITY known-gap closure: PEC/odd-size grids fell
    to the ~6x-slower XLA path whenever ``nz % 8`` or the x/y block-divide
    checks failed).

    Padding happens at the HIGH end of each PEC-terminated axis only
    (PML/absorber axes terminate in PEC too). The pad cells carry
    ``ca = cb = da = db = 0`` so E and H are frozen at zero there — exactly
    the zero-extension the stepping core already assumes beyond the high
    wall — and the Yee staggering guarantees no true-cell update ever reads
    a pad value that differs from that implicit zero (E reads H backward,
    H reads E forward along each derivative axis). CPML hi-slab coefficient
    vectors are zero-padded and ``n_hi`` is grown so the slab stays anchored
    at the (new) array edge while covering the true PML cone; pad rows are
    self-neutralizing (psi' = 0*psi + 0*d).

    Periodic/Bloch/PMC axes are never padded (wrap reads must hit the true
    opposite edge / the mirror image is not a zero-extension).

    Returns (possibly new) plan and the pad widths applied.
    """
    import dataclasses
    import os

    if os.environ.get("TIDY3D_TPU_PAD_ALIGN", "1") == "0":
        return plan, (0, 0, 0)

    nx, ny, nz = plan.shape

    # y blocks must admit a divisor by >= (rounded PML width + hw, and the
    # two-sided width sum); wide (Stable)PML needs larger blocks
    wy = wy_sum_parts = 0
    w_sides = [0, 0]
    for cf in (plan.pml_dual[1], plan.pml_primal[1]):
        for side, w in enumerate((cf.n_lo, cf.n_hi)):
            if w:
                wq = -(-(w + 1) // 8) * 8
                wy = max(wy, wq)
                w_sides[side] = max(w_sides[side], wq)
    wy_sum_parts = w_sides[0] + w_sides[1]

    def pad_y(n):
        """Minimal pad so some valid by divides ny."""
        for pad in range(0, 97):
            m = n + pad
            for by in (16, 32, 48, 64, 96, 128, 192, 256):
                if m % by:
                    continue
                if wy and by < wy + 8:
                    continue
                if by < wy_sum_parts:
                    continue
                return pad
        return None

    def pad_to(mult):
        return lambda n: (-n) % mult

    rules = (pad_to(16 * max(ndev_x, 1)), pad_y, pad_to(8))

    pads = []
    for axis in range(3):
        n = plan.shape[axis]
        pad = rules[axis](n)
        if pad == 0 or n == 1:
            pads.append(0)
            continue
        if pad is None or plan.boundaries[axis][1] != BK_PEC:
            # misaligned but not paddable: keep the plan unchanged (the
            # runner will fall back to the XLA path as before)
            pads.append(None)
            continue
        pads.append(pad)
    if any(p is None for p in pads) or not any(pads):
        return plan, (0, 0, 0)
    px, py, pz = pads

    def pad3(arr, fill=0.0):
        arr = np.asarray(arr)
        if arr.ndim == 0:
            return arr
        return np.pad(arr, ((0, px), (0, py), (0, pz)),
                      constant_values=fill)

    def pad1(vec, axis, fill):
        vec = np.asarray(vec)
        p = pads[axis]
        if p == 0:
            return vec
        if fill == "edge":
            return np.pad(vec, (0, p), mode="edge")
        return np.pad(vec, (0, p), constant_values=fill)

    coeffs_E = {c: (pad3(a), pad3(b)) for c, (a, b) in plan.coeffs_E.items()}
    coeffs_H = {c: (pad3(a), pad3(b)) for c, (a, b) in plan.coeffs_H.items()}
    inv_primal = tuple(pad1(plan.inv_primal[ax], ax, "edge") for ax in range(3))
    inv_dual = tuple(pad1(plan.inv_dual[ax], ax, "edge") for ax in range(3))

    def pad_pml(cf, axis):
        p = pads[axis]
        if p == 0:
            return cf
        return cpml_mod.PmlCoeffs1D(
            inv_kappa=pad1(cf.inv_kappa, axis, 1.0),
            b=pad1(cf.b, axis, 0.0),
            c=pad1(cf.c, axis, 0.0),
            n_lo=cf.n_lo,
            n_hi=cf.n_hi + p if cf.n_hi else 0,
        )

    pml_dual = tuple(pad_pml(plan.pml_dual[ax], ax) for ax in range(3))
    pml_primal = tuple(pad_pml(plan.pml_primal[ax], ax) for ax in range(3))

    poles = [dataclasses.replace(
        pp, c_maps=(tuple(pad3(m) for m in pp.c_maps)
                    if pp.c_maps is not None else None))
        for pp in plan.poles]
    pole_masks = [np.pad(m, ((0, px), (0, py), (0, pz)),
                         constant_values=False) for m in plan.pole_masks]
    disp_ee = None
    if plan.disp_ee is not None:
        disp_ee = {c: pad3(v) for c, v in plan.disp_ee.items()}
    nonlinear = plan.nonlinear
    if nonlinear is not None:
        nonlinear = {k: ({c: pad3(m) for c, m in v.items()}
                         if isinstance(v, dict) else v)
                     for k, v in nonlinear.items()}
    modulation = plan.modulation
    if modulation is not None:
        modulation = [
            {k: ({c: tuple(pad3(m) for m in maps) for c, maps in v.items()}
                 if k in ("eps_maps", "sigma_maps") else v)
             for k, v in entry.items()}
            for entry in modulation
        ]
    eps_yee = None
    if plan.eps_yee is not None:
        eps_yee = {c: pad3(v, fill=1.0) for c, v in plan.eps_yee.items()}

    new_plan = dataclasses.replace(
        plan, shape=(nx + px, ny + py, nz + pz),
        coeffs_E=coeffs_E, coeffs_H=coeffs_H,
        inv_primal=inv_primal, inv_dual=inv_dual,
        pml_dual=pml_dual, pml_primal=pml_primal,
        poles=poles, disp_ee=disp_ee, nonlinear=nonlinear,
        modulation=modulation, eps_yee=eps_yee, pole_masks=pole_masks)
    return new_plan, (px, py, pz)
