"""Field-source profile generation: plane waves, Gaussian beams, mode sources.

Produces the complex tangential field profiles (E, H) of the desired wave on
the source plane, evaluated at the exact Yee positions of each component
(including the half-cell stagger along the normal via the e^{i k_a da}
factor). The lowering turns these into equivalence-principle currents
J_s = -n x H, M_s = n x E for unidirectional injection
(reference behavior: tidy3d's CustomFieldSource docstring and server-side
mode injection, monitor_data.py:553-570 grid corrections).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..components.medium import PECMedium
from ..components.source import (
    AstigmaticGaussianBeam,
    CustomFieldSource,
    GaussianBeam,
    ModeSource,
    PlaneWave,
)
from ..constants import C_0, EPSILON_0, ETA_0, MU_0
from ..exceptions import SetupError
from .lowering_utils import slices_for_box, yee_coords


def make_source_fields(simulation, source) -> Tuple[Dict[str, dict], int]:
    """Compute tangential (and normal) field profiles of a field source.

    Returns ({comp: {"profile": complex array, "slices": (sx, sy, sz)}}, axis).
    Profiles are the desired propagating-wave fields at each Yee point of the
    source plane; H in units of E/eta0.
    """
    plane_axis = tuple(source.size).index(0.0)
    if isinstance(source, PlaneWave):
        return _plane_wave_fields(simulation, source, plane_axis), plane_axis
    if isinstance(source, (GaussianBeam, AstigmaticGaussianBeam)):
        return _gaussian_beam_fields(simulation, source, plane_axis), plane_axis
    if isinstance(source, ModeSource):
        return _mode_source_fields(simulation, source, plane_axis), plane_axis
    if isinstance(source, CustomFieldSource):
        return _custom_field_fields(simulation, source, plane_axis), plane_axis
    raise NotImplementedError(f"field source type {type(source).__name__}")


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #


def _background_index(simulation, source) -> float:
    """Refractive index at the source center."""
    freq0 = source.source_time.freq0
    x0, y0, z0 = source.center
    medium = simulation.medium
    for structure in simulation.structures:
        if structure.geometry.inside(np.array(x0), np.array(y0), np.array(z0)):
            medium = structure.medium
    if isinstance(medium, PECMedium):
        raise SetupError("source is embedded in PEC")
    eps = medium.eps_model(freq0)
    return float(np.real(np.sqrt(eps)))


def _tangential_slices_coords(simulation, source, plane_axis: int):
    """Per-component slices/coords on the source plane (1 cell thick along
    the plane axis).

    Discrete TF/SF consistency (Taflove ch. 5): the J sheet on the primal
    plane i0 must sample the incident H at the dual plane i0+1/2, and the M
    sheet must sit at that SAME dual plane i0+1/2 sampling the incident E at
    i0 — for both propagation directions. In array indices (dual point j sits
    at position j+1/2) this means every tangential component uses plane index
    i0: independent nearest-point rounding per component lands the pair a full
    cell apart and leaks ~sin(k dx) backward."""
    grid = simulation.grid
    out = {}
    dim = "xyz"[plane_axis]
    pos = source.center[plane_axis]
    primal = np.asarray(grid.boundaries.to_list[plane_axis])
    i0 = int(np.argmin(np.abs(primal - pos)))
    for comp in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"):
        sl, coords = slices_for_box(grid, source, comp, extend=False)
        axis_coords = yee_coords(grid, comp)[dim]
        idx = min(i0, len(axis_coords) - 1)
        sl = list(sl)
        sl[plane_axis] = slice(idx, idx + 1)
        coords = dict(coords)
        coords[dim] = axis_coords[idx:idx + 1]
        out[comp] = (tuple(sl), coords)
    return out


def _numerical_k(freq: float, n_medium: float, dl: float, dt: float) -> float:
    """Wavenumber satisfying the discrete 1D Yee dispersion relation
    sin(k dl / 2)/dl = (n/(c dt)) sin(w dt / 2): using it for source phases
    makes equivalence-sheet cancellation consistent with the grid's own
    propagation (reduces TFSF/plane-source leakage substantially)."""
    omega = 2 * np.pi * freq
    c_n = C_0 / n_medium
    arg = (dl / (c_n * dt)) * np.sin(omega * dt / 2.0)
    arg = np.clip(arg, -1.0, 1.0)
    return float(2.0 / dl * np.arcsin(arg))


def _wave_vectors(source, plane_axis: int, n_medium: float, dl_dt=None):
    """(k_vec, E_pol, H_pol) in global coordinates for an angled wave."""
    freq0 = source.source_time.freq0
    k0 = 2 * np.pi * freq0 * n_medium / C_0
    if dl_dt is not None:
        dl, dt = dl_dt
        k0 = _numerical_k(freq0, n_medium, dl, dt)
    theta = getattr(source, "angle_theta", 0.0)
    phi = getattr(source, "angle_phi", 0.0)
    psi = getattr(source, "pol_angle", 0.0)
    s = 1.0 if source.direction == "+" else -1.0

    # local frame: z' = plane_axis, (x', y') = the two other axes in cyclic order
    b, c = (plane_axis + 1) % 3, (plane_axis + 2) % 3
    k_local = np.array([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                        s * np.cos(theta)])
    theta_hat = np.array([np.cos(theta) * np.cos(phi), np.cos(theta) * np.sin(phi),
                          -s * np.sin(theta)])
    phi_hat = np.array([-np.sin(phi), np.cos(phi), 0.0])
    e_local = np.cos(psi) * theta_hat + np.sin(psi) * phi_hat
    h_local = np.cos(psi) * phi_hat - np.sin(psi) * theta_hat  # k x E direction

    def to_global(v_local):
        v = np.zeros(3)
        v[b], v[c], v[plane_axis] = v_local[0], v_local[1], v_local[2]
        return v

    k_vec = k0 * to_global(k_local)
    e_pol = to_global(e_local)
    h_pol = (n_medium / ETA_0) * to_global(h_local)
    return k_vec, e_pol, h_pol


def _grid_dl_dt(simulation, axis: int):
    sizes = np.asarray(simulation.grid.sizes.to_list[axis])
    return float(np.min(sizes)), simulation.dt


def _plane_wave_fields(simulation, source, plane_axis: int) -> Dict[str, dict]:
    n_medium = _background_index(simulation, source)
    k_vec, e_pol, h_pol = _wave_vectors(
        source, plane_axis, n_medium,
        dl_dt=_grid_dl_dt(simulation, plane_axis)
        if getattr(source, "angle_theta", 0.0) == 0.0 else None)
    slices_coords = _tangential_slices_coords(simulation, source, plane_axis)
    origin = np.asarray(source.center)

    fields = {}
    for ci, comp in enumerate(("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")):
        pol = e_pol if comp[0] == "E" else h_pol
        amp = pol[ci % 3]
        sl, coords = slices_coords[comp]
        xs, ys, zs = np.meshgrid(coords["x"], coords["y"], coords["z"],
                                 indexing="ij", sparse=True)
        phase = np.exp(1j * (k_vec[0] * (xs - origin[0]) + k_vec[1] * (ys - origin[1])
                             + k_vec[2] * (zs - origin[2])))
        profile = amp * np.broadcast_to(
            phase, tuple(len(coords[d]) for d in "xyz")).astype(np.complex64)
        fields[comp] = {"profile": profile, "slices": sl}
    return fields


def _gaussian_beam_fields(simulation, source, plane_axis: int) -> Dict[str, dict]:
    """Paraxial (possibly astigmatic) Gaussian beam fields at the source
    plane (normal incidence exact; angles applied as a phase ramp +
    polarization rotation). AstigmaticGaussianBeam carries independent
    waists/waist distances along the two transverse axes (reference:
    source.py AstigmaticGaussianBeam:1157)."""
    n_medium = _background_index(simulation, source)
    freq0 = source.source_time.freq0
    k0 = 2 * np.pi * freq0 * n_medium / C_0
    k_vec, e_pol, h_pol = _wave_vectors(source, plane_axis, n_medium)
    slices_coords = _tangential_slices_coords(simulation, source, plane_axis)
    origin = np.asarray(source.center)
    s = 1.0 if source.direction == "+" else -1.0
    # per-transverse-axis (waist, distance): positive waist_distance means
    # the waist is *behind* the source plane
    if hasattr(source, "waist_sizes"):
        w0s = tuple(float(w) for w in source.waist_sizes)
        z_ws = tuple(float(z) for z in source.waist_distances)
    else:
        w0s = (float(source.waist_radius),) * 2
        z_ws = (float(source.waist_distance),) * 2

    b, c = (plane_axis + 1) % 3, (plane_axis + 2) % 3

    fields = {}
    for ci, comp in enumerate(("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")):
        pol = e_pol if comp[0] == "E" else h_pol
        amp = pol[ci % 3]
        sl, coords = slices_coords[comp]
        xs, ys, zs = np.meshgrid(coords["x"], coords["y"], coords["z"],
                                 indexing="ij", sparse=True)
        pts = (xs - origin[0], ys - origin[1], zs - origin[2])
        envelope = 1.0 + 0j
        for t_ax, w0, z in zip((b, c), w0s, z_ws):
            zr = k0 * w0**2 / 2.0
            wz = w0 * np.sqrt(1 + (z / zr) ** 2)
            inv_R = z / (z**2 + zr**2)
            gouy = np.arctan2(z, zr)
            u2 = pts[t_ax] ** 2
            envelope = envelope * np.sqrt(w0 / wz) * np.exp(-u2 / wz**2) \
                * np.exp(1j * (s * k0 * inv_R * u2 / 2 - gouy / 2))
        phase = np.exp(1j * (k_vec[0] * pts[0] + k_vec[1] * pts[1] + k_vec[2] * pts[2]))
        profile = (amp * envelope * phase)
        profile = np.broadcast_to(profile, tuple(len(coords[d]) for d in "xyz"))
        fields[comp] = {"profile": profile.astype(np.complex64), "slices": sl}
    return fields


def _mode_source_fields(simulation, source, plane_axis: int) -> Dict[str, dict]:
    """Mode fields from the native mode solver, at the Yee points of the plane."""
    from ..plugins.mode.mode_solver import ModeSolver

    freq0 = source.source_time.freq0
    solver = ModeSolver(
        simulation=simulation,
        plane=source.geometry,
        mode_spec=source.mode_spec,
        freqs=[freq0],
        direction=source.direction,
        colocate=False,
    )
    data = solver.data_raw
    return _mode_fields_from_data(simulation, source, plane_axis, data, 0,
                                  freq0)


def _mode_fields_from_data(simulation, source, plane_axis, data, f_index,
                           freq) -> Dict[str, dict]:
    """Sheet field profiles from solved mode data at one frequency index."""
    slices_coords = _tangential_slices_coords(simulation, source, plane_axis)

    # propagation phase across the staggered sheet offsets: each Yee component
    # sits at a slightly different normal position z_comp; the mode varies as
    # exp(+/- i beta (z - z0)), which sets the J/M relative phase that makes
    # the injection unidirectional
    n_eff = complex(data.n_complex.values[f_index, int(source.mode_index)])
    k0 = 2 * np.pi * freq / C_0
    beta = k0 * n_eff
    sign = 1.0 if source.direction == "+" else -1.0
    z0 = source.center[plane_axis]
    n_dim = "xyz"[plane_axis]

    fields = {}
    for comp in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"):
        sl, coords = slices_coords[comp]
        arr = getattr(data, comp, None)
        if arr is None:
            fields[comp] = None
            continue
        sel = arr.isel(f=f_index, mode_index=int(source.mode_index))
        prof = sel.interp(
            x=coords["x"], y=coords["y"], z=coords["z"],
            kwargs=dict(fill_value=0.0),
        ).values
        delta = float(coords[n_dim][0]) - z0
        phase = np.exp(1j * sign * beta * delta)
        fields[comp] = {"profile": np.asarray(prof * phase, dtype=np.complex64),
                        "slices": sl}
    return fields


# band half-width of the broadband Chebyshev fit in units of fwidth
CHEB_GRID_WIDTH = 1.5


def make_broadband_mode_fields(simulation, source, plane_axis: int):
    """Chebyshev-coefficient field maps for a broadband mode source.

    Solves the modes at ``num_freqs`` Chebyshev-Gauss nodes across
    freq0 +/- CHEB_GRID_WIDTH fwidth (one multi-frequency solve), aligns the
    eigenvector gauge against the center node, and returns per-order
    coefficient maps C_k so that sum_k C_k T_k(f~) interpolates the
    frequency-dependent injection profile (reference: source.py ModeSource
    broadband num_freqs Chebyshev fit:737-779)."""
    from ..plugins.mode.mode_solver import ModeSolver

    num_freqs = int(source.num_freqs)
    f0 = source.source_time.freq0
    bw = CHEB_GRID_WIDTH * source.source_time.fwidth
    x_nodes = np.cos(np.pi * (np.arange(num_freqs) + 0.5) / num_freqs)
    freqs = f0 + bw * x_nodes

    solver = ModeSolver(
        simulation=simulation, plane=source.geometry,
        mode_spec=source.mode_spec, freqs=freqs.tolist(),
        direction=source.direction, colocate=False,
    )
    data = solver.data_raw

    per_freq = [_mode_fields_from_data(simulation, source, plane_axis, data,
                                       j, freqs[j])
                for j in range(num_freqs)]

    # gauge alignment: remove the eigensolver's arbitrary per-frequency
    # phase/sign by overlapping each node against the center node
    j_ref = num_freqs // 2
    for j in range(num_freqs):
        if j == j_ref:
            continue
        ov = 0.0 + 0j
        for comp in ("Ex", "Ey", "Ez"):
            a = per_freq[j_ref][comp]
            b = per_freq[j][comp]
            if a is None or b is None:
                continue
            ov += np.sum(np.conj(a["profile"]) * b["profile"])
        if abs(ov) > 0:
            g = np.conj(ov) / abs(ov)
            for comp in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"):
                if per_freq[j][comp] is not None:
                    per_freq[j][comp] = {
                        "profile": per_freq[j][comp]["profile"] * g,
                        "slices": per_freq[j][comp]["slices"]}

    # Chebyshev coefficients: C_k = (2 - delta_k0)/N sum_j P_j T_k(x_j)
    coeff_fields = []
    for k in range(num_freqs):
        t_k = np.cos(k * np.arccos(np.clip(x_nodes, -1, 1)))
        scale = (1.0 if k == 0 else 2.0) / num_freqs
        fk = {}
        for comp in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"):
            if per_freq[0][comp] is None:
                fk[comp] = None
                continue
            acc = sum(t_k[j] * per_freq[j][comp]["profile"]
                      for j in range(num_freqs))
            fk[comp] = {"profile": (scale * acc).astype(np.complex64),
                        "slices": per_freq[0][comp]["slices"]}
        coeff_fields.append(fk)
    return coeff_fields, f0, bw


def make_cheb_amp_fn(source_time, order: int, f0: float, bw: float):
    """Waveform for the k-th Chebyshev order: T_k applied to the frequency
    operator f~ = ((i/2pi) d/dt - f0)/bw acting on the source signal, so the
    injected spectrum is A(f) T_k((f-f0)/bw)."""

    def fn(times):
        times = np.asarray(times, dtype=float)
        a = source_time.amp_time(times)
        if order == 0:
            return a

        def op(v):
            dv = np.gradient(v, times)
            return ((1j / (2 * np.pi)) * dv - f0 * v) / bw

        b_prev, b_cur = a, op(a)
        for _ in range(order - 1):
            b_prev, b_cur = b_cur, 2 * op(b_cur) - b_prev
        return b_cur

    return fn


def make_tfsf_face_fields(simulation, grid, source, face_axis: int, side: str
                          ) -> Dict[str, dict]:
    """Incident plane-wave fields evaluated at the Yee points of one face of
    a TFSF box (global phase reference at the box's injection plane)."""
    from .lowering_utils import yee_coords

    n_medium = _background_index(simulation, source)
    k_vec, e_pol, h_pol = _wave_vectors(
        source, source.injection_axis, n_medium,
        dl_dt=_grid_dl_dt(simulation, source.injection_axis)
        if getattr(source, "angle_theta", 0.0) == 0.0 else None)

    rmin, rmax = source.bounds
    pos = rmin[face_axis] if side == "-" else rmax[face_axis]
    origin = np.asarray(source.injection_plane_center)

    # primal face indices of the box along every axis; the total-field region
    # for a primal-staggered component spans indices [t0+1, t1] and for a
    # dual-staggered one [t0, t1-1] (Taflove discrete TF/SF consistency) —
    # the sheet transverse extents must match these EXACTLY or corner cells
    # get extra/missing corrections and leak
    primal_all = [np.asarray(b) for b in grid.boundaries.to_list]
    t0t1 = []
    domain_min, domain_max = simulation.bounds
    for ax in range(3):
        full = (rmin[ax] <= domain_min[ax] + 1e-10 * (1 + abs(domain_min[ax]))
                or rmax[ax] >= domain_max[ax] - 1e-10 * (1 + abs(domain_max[ax])))
        t0 = int(np.argmin(np.abs(primal_all[ax] - rmin[ax])))
        t1 = int(np.argmin(np.abs(primal_all[ax] - rmax[ax])))
        t0t1.append((t0, t1, full))
    i0 = int(np.argmin(np.abs(primal_all[face_axis]
                              - (rmin if side == "-" else rmax)[face_axis])))

    fields = {}
    dims = "xyz"
    for ci, comp in enumerate(("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")):
        pol = e_pol if comp[0] == "E" else h_pol
        amp = pol[ci % 3]
        all_coords = yee_coords(grid, comp)
        sl = []
        coords = {}
        for ax in range(3):
            dim = dims[ax]
            axis_coords = np.asarray(all_coords[dim])
            if ax == face_axis:
                # normal: E sheet on primal plane i0, H sheet at dual i0+1/2
                # (same array index); direction sign handled by the caller
                idx = min(i0, len(axis_coords) - 1)
                s = slice(idx, idx + 1)
            else:
                t0, t1, full = t0t1[ax]
                is_dual = (comp[0] == "E") == (comp[1] == dim)
                if full or len(axis_coords) == 1:
                    s = slice(0, len(axis_coords))
                elif is_dual:
                    s = slice(t0, max(t1, t0 + 1))
                else:
                    s = slice(t0 + 1, max(t1 + 1, t0 + 2))
            sl.append(s)
            coords[dim] = axis_coords[s]
        xs, ys, zs = np.meshgrid(coords["x"], coords["y"], coords["z"],
                                 indexing="ij", sparse=True)
        phase = np.exp(1j * (k_vec[0] * (xs - origin[0])
                             + k_vec[1] * (ys - origin[1])
                             + k_vec[2] * (zs - origin[2])))
        profile = amp * np.broadcast_to(
            phase, tuple(len(coords[d]) for d in "xyz")).astype(np.complex64)
        fields[comp] = {"profile": profile, "slices": tuple(sl)}
    return fields


def _custom_field_fields(simulation, source, plane_axis: int) -> Dict[str, dict]:
    """Tangential fields from a user-provided FieldDataset."""
    dataset = source.field_dataset
    if dataset is None:
        raise NotImplementedError("CustomFieldSource with no dataset")
    slices_coords = _tangential_slices_coords(simulation, source, plane_axis)
    fields = {}
    get = dataset.get if isinstance(dataset, dict) else lambda k, d=None: getattr(
        dataset, k, d)
    for comp in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"):
        arr = get(comp, None) if isinstance(dataset, dict) else get(comp)
        if arr is None:
            continue
        sl, coords = slices_coords[comp]
        prof = arr.interp(
            x=coords["x"], y=coords["y"], z=coords["z"], kwargs=dict(fill_value=0.0),
        ).values
        fields[comp] = {"profile": np.asarray(prof, dtype=np.complex64), "slices": sl}
    return fields
