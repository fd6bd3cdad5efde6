"""EME solver: per-cell mode solve + mode-matching transfer matrices.

The reference keeps its EME engine cloud-side (SURVEY.md §2.3 item 8); here
it is built on the native mode solver. Per cell the cross-section modes are
solved at the cell center; interfaces couple neighboring mode bases through
unconjugated reciprocal overlap integrals (mode matching):

    F' + B' = D^-1 P^T (F + B),   F' - B' = D^-1 R (F - B)

with P_ab = 1/2 int (E^A_a x H^B_b).n, R_ba = 1/2 int (E^B_b x H^A_a).n and
D the self-overlap normalization of basis B. Cells propagate with diagonal
exp(+i beta L) phases; the cascade is accumulated as transfer matrices and
converted to the port S-matrix.

``run_eme(eme_sim, device=None)`` solves every cell's modes inside
``device_solver.solve_on(device)``: with no device, the innermost scope's,
else CUDA, so that a plane of 2N >= 20000 takes the Chebyshev filter on
the card and smaller planes the host solvers (``TIDY3D_TPU_MODE_SOLVER``
routes as for every mode solve). ``CELL_SECONDS`` holds the last run's
host seconds per cell solve.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..components.data.data_array import EMESMatrixDataArray, EMEModeIndexDataArray
from ..components.eme.data import EMESimulationData, EMESMatrixDataset
from ..components.eme.simulation import EMESimulation
from ..components.eme.sweep import EMEFreqSweep, EMELengthSweep, EMEModeSweep
from ..components.geometry.base import Box
from ..constants import C_0, inf
from ..exceptions import SetupError
from ..log import log

CELL_SECONDS: List[float] = []


def run_eme(eme_sim: EMESimulation, verbose: bool = False,
            device=None) -> EMESimulationData:
    """Solve an EME simulation; the cells' mode solves run on ``device``
    (None: the innermost ``solve_on`` scope's, else CUDA)."""
    import time

    from ..plugins.mode.device_solver import solve_device, solve_on
    from ..plugins.mode.mode_solver import ModeSolver

    fdtd_sim = eme_sim._to_fdtd_sim()
    freqs = np.atleast_1d(np.asarray(eme_sim.freqs, dtype=float))
    axis = eme_sim.axis
    centers = eme_sim.cell_centers
    lengths = eme_sim.cell_lengths
    mode_specs = eme_sim.mode_specs
    num_cells = len(centers)

    # sweep handling: length scaling, perturbative frequency scaling (both
    # scale the accumulated propagation phase), or retained-mode-count sweep
    sweep_spec = eme_sim.sweep_spec
    sweep_mode_counts = None
    if isinstance(sweep_spec, EMELengthSweep):
        sweep_scales = np.asarray(sweep_spec.scale_factors, dtype=float)
    elif isinstance(sweep_spec, EMEFreqSweep):
        sweep_scales = np.asarray(sweep_spec.freq_scale_factors, dtype=float)
    elif isinstance(sweep_spec, EMEModeSweep):
        sweep_mode_counts = [int(n) for n in sweep_spec.num_modes]
        sweep_scales = np.ones(len(sweep_mode_counts))
    else:
        sweep_scales = np.array([1.0])
    num_sweep = len(sweep_scales)

    # solve modes per cell
    cell_modes = []
    CELL_SECONDS.clear()
    for ci, (pos, mode_spec) in enumerate(zip(centers, mode_specs)):
        plane_center = list(eme_sim.center)
        plane_center[axis] = float(pos)
        plane_size = list(eme_sim.size)
        plane_size[axis] = 0.0
        # 2D EME sims: a zero-extent transverse dim is the homogeneous axis;
        # the mode plane spans it fully (same convention as ModeMonitor)
        for d in range(3):
            if d != axis and plane_size[d] == 0.0:
                plane_size[d] = inf
        solver = ModeSolver(
            simulation=fdtd_sim, plane=Box(center=tuple(plane_center),
                                           size=tuple(plane_size)),
            mode_spec=mode_spec, freqs=freqs.tolist(), colocate=False,
        )
        t0 = time.perf_counter()
        with solve_on(solve_device(device)):
            cell_modes.append(solver.data_raw)
        CELL_SECONDS.append(time.perf_counter() - t0)
        if verbose:
            log.info(f"EME cell {ci + 1}/{num_cells} solved.")

    num_modes = min(ms.num_modes for ms in mode_specs)
    n_complex = np.zeros((len(freqs), num_sweep, num_cells, num_modes),
                         dtype=complex)

    s11 = np.zeros((len(freqs), num_sweep, num_modes, num_modes), dtype=complex)
    s12 = np.zeros_like(s11)
    s21 = np.zeros_like(s11)
    s22 = np.zeros_like(s11)

    # cell-entry [F; B] states per (fi, si, port): the EME monitors read
    # the expansion coefficients along the device (reference
    # eme/monitor.py EMECoefficientMonitor:249, EMEFieldMonitor:187)
    entry_states: Dict[Tuple[int, int, int], List[np.ndarray]] = {}
    betas_all: Dict[int, List[np.ndarray]] = {}

    for fi, freq in enumerate(freqs):
        k0 = 2 * np.pi * freq / C_0
        betas = []
        for ci in range(num_cells):
            n_c = cell_modes[ci].n_complex.values[fi, :num_modes]
            betas.append(k0 * n_c)
        betas_all[fi] = betas
        iface_cache: Dict[int, List[np.ndarray]] = {}
        for si, scale in enumerate(sweep_scales):
            n_complex[fi, si] = np.stack(betas) / k0
            nm = num_modes if sweep_mode_counts is None \
                else min(sweep_mode_counts[si], num_modes)
            if nm not in iface_cache:
                iface_cache[nm] = [
                    _interface_transfer(cell_modes[ci], cell_modes[ci + 1],
                                        fi, nm, axis)
                    for ci in range(num_cells - 1)]
            ifaces = iface_cache[nm]
            T_cells = []
            T = np.eye(2 * nm, dtype=complex)
            for ci in range(num_cells):
                # propagation through the cell
                phase = np.exp(1j * betas[ci][:nm] * lengths[ci] * scale)
                P = np.zeros((2 * nm, 2 * nm), dtype=complex)
                P[:nm, :nm] = np.diag(phase)
                P[nm:, nm:] = np.diag(1.0 / phase)
                T_cells.append(P)
                T = P @ T
                if ci < num_cells - 1:
                    T = ifaces[ci] @ T
            s = _transfer_to_smatrix(T, nm)
            s = _apply_constraint(s, eme_sim.constraint, nm)
            s11[fi, si, :nm, :nm], s12[fi, si, :nm, :nm], \
                s21[fi, si, :nm, :nm], s22[fi, si, :nm, :nm] = s

            # march the cell-entry states for both port excitations
            # (port 0: unit forward inputs; port 1: unit backward inputs)
            eye = np.eye(nm, dtype=complex)
            zero = np.zeros((nm, nm), dtype=complex)
            for port, st0 in ((0, np.vstack([eye, s[0]])),
                              (1, np.vstack([zero, s[1]]))):
                st = st0
                states = []
                for ci in range(num_cells):
                    states.append(st)
                    st = T_cells[ci] @ st
                    if ci < num_cells - 1:
                        st = ifaces[ci] @ st
                entry_states[(fi, si, port)] = states

    coords = dict(
        f=freqs, sweep_index=np.arange(num_sweep),
        mode_index_out=np.arange(num_modes), mode_index_in=np.arange(num_modes),
    )
    smatrix = EMESMatrixDataset(
        S11=EMESMatrixDataArray(s11, coords=coords),
        S12=EMESMatrixDataArray(s12, coords=coords),
        S21=EMESMatrixDataArray(s21, coords=coords),
        S22=EMESMatrixDataArray(s22, coords=coords),
    )
    n_da = EMEModeIndexDataArray(
        n_complex, coords=dict(f=freqs, sweep_index=np.arange(num_sweep),
                               eme_cell_index=np.arange(num_cells),
                               mode_index=np.arange(num_modes)))

    mon_data = _monitor_data(
        eme_sim, cell_modes, entry_states, betas_all, freqs, sweep_scales,
        sweep_mode_counts, num_modes, axis)

    return EMESimulationData(
        simulation=eme_sim, smatrix=smatrix, n_complex=n_da,
        data=tuple(mon_data),
        port_modes=(cell_modes[0], cell_modes[-1]))


# --------------------------------------------------------------------------- #
# monitor data (reference: eme/monitor.py + eme/data/monitor_data.py)
# --------------------------------------------------------------------------- #


def _monitor_data(eme_sim, cell_modes, entry_states, betas_all, freqs,
                  sweep_scales, sweep_mode_counts, num_modes, axis):
    """Build EME monitor data from the expansion: per-cell mode bases,
    reconstructed propagated fields, and forward/backward coefficients."""
    from ..components.data.data_array import (
        EMECoefficientDataArray,
        EMEModeIndexDataArray,
        EMEScalarFieldDataArray,
        EMEScalarModeFieldDataArray,
    )
    from ..components.eme.data import (
        EMECoefficientData,
        EMEFieldData,
        EMEModeSolverData,
    )
    from ..components.eme.monitor import (
        EMECoefficientMonitor,
        EMEFieldMonitor,
        EMEModeSolverMonitor,
    )

    monitors = list(getattr(eme_sim, "monitors", ()) or ())
    if not monitors:
        return []
    boundaries = eme_sim.cell_boundaries
    centers = eme_sim.cell_centers
    lengths = eme_sim.cell_lengths
    num_cells = len(centers)
    num_sweep = len(sweep_scales)
    nf = len(freqs)
    n_dim = "xyz"[axis]
    comps = ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")

    def nm_of(si):
        return num_modes if sweep_mode_counts is None \
            else min(sweep_mode_counts[si], num_modes)

    def comp_sign(comp):
        """Backward-mode sign: E_t, H_n keep sign (F+B); E_n, H_t flip
        (F-B) — matches the solver's direction='-' transform."""
        normal = comp[1] == n_dim
        if comp[0] == "E":
            return -1.0 if normal else 1.0
        return 1.0 if normal else -1.0

    def crop_inds(coords_1d, lo, hi):
        c = np.asarray(coords_1d, dtype=float)
        inds = np.nonzero((c >= lo - 1e-12) & (c <= hi + 1e-12))[0]
        return inds if len(inds) else np.array([int(np.argmin(
            np.abs(c - 0.5 * (lo + hi))))])

    def cells_in(mon):
        rmin, rmax = mon.bounds
        inds = [ci for ci in range(num_cells)
                if rmin[axis] - 1e-12 <= centers[ci] <= rmax[axis] + 1e-12]
        return inds or [int(np.argmin(np.abs(
            centers - mon.center[axis])))]

    out = []
    for mon in monitors:
        nm_rec = num_modes if mon.num_modes is None \
            else min(int(mon.num_modes), num_modes)
        rmin, rmax = mon.bounds

        if isinstance(mon, EMEModeSolverMonitor):
            cells = cells_in(mon)[::mon.eme_cell_interval_space]
            arrs = {}
            for comp in comps:
                vals_cells = []
                for ci in cells:
                    arr = cell_modes[ci].field_components[comp]
                    vals_cells.append(np.take(
                        np.asarray(arr.values), 0, axis=axis)[..., :nm_rec])
                stack = np.stack(vals_cells, axis=-2)  # (d1, d2, f, cell, m)
                # crop transverse dims to the monitor bounds
                arr0 = cell_modes[cells[0]].field_components[comp]
                tdims = [d for d in arr0.dims if d not in (n_dim, "f",
                                                           "mode_index")]
                for di, dim in enumerate(tdims):
                    gi = "xyz".index(dim)
                    inds = crop_inds(arr0.coords[dim], rmin[gi], rmax[gi])
                    stack = np.take(stack, inds, axis=di)
                # -> dims (x, y, z, f, sweep, cell, mode)
                full = np.expand_dims(stack, axis=axis)  # singleton normal
                full = full[:, :, :, :, None, :, :] * np.ones(
                    (1, 1, 1, 1, num_sweep, 1, 1))
                coords = {}
                for dim in ("x", "y", "z"):
                    if dim == n_dim:
                        coords[dim] = np.array([mon.center[axis]])
                    else:
                        gi = "xyz".index(dim)
                        c0 = np.asarray(arr0.coords[dim])
                        coords[dim] = c0[crop_inds(c0, rmin[gi], rmax[gi])]
                coords.update(f=freqs, sweep_index=np.arange(num_sweep),
                              eme_cell_index=np.array(cells),
                              mode_index=np.arange(nm_rec))
                arrs[comp] = EMEScalarModeFieldDataArray(full, coords=coords)
            n_sub = np.stack(
                [cell_modes[ci].n_complex.values[:, :nm_rec]
                 for ci in cells], axis=1)  # (f, cell, m)
            n_sub = np.broadcast_to(n_sub[:, None], (nf, num_sweep,
                                                     len(cells), nm_rec))
            n_da = EMEModeIndexDataArray(n_sub, coords=dict(
                f=freqs, sweep_index=np.arange(num_sweep),
                eme_cell_index=np.array(cells),
                mode_index=np.arange(nm_rec)))
            out.append(EMEModeSolverData(monitor=mon, n_complex=n_da, **arrs))

        elif isinstance(mon, EMECoefficientMonitor):
            cells = cells_in(mon)[::mon.eme_cell_interval_space]
            A = np.zeros((nf, num_sweep, len(cells), num_modes, num_modes),
                         dtype=complex)
            B = np.zeros_like(A)
            for fi in range(nf):
                betas = betas_all[fi]
                for si, scale in enumerate(sweep_scales):
                    nm = nm_of(si)
                    states = entry_states[(fi, si, 0)]
                    for rec_i, ci in enumerate(cells):
                        st = states[ci]
                        ph = np.exp(1j * betas[ci][:nm]
                                    * lengths[ci] * scale / 2.0)
                        A[fi, si, rec_i, :nm, :nm] = ph[:, None] * st[:nm]
                        B[fi, si, rec_i, :nm, :nm] = \
                            (1.0 / ph)[:, None] * st[nm:]
            coords = dict(f=freqs, sweep_index=np.arange(num_sweep),
                          eme_cell_index=np.array(cells),
                          mode_index_out=np.arange(num_modes),
                          mode_index_in=np.arange(num_modes))
            out.append(EMECoefficientData(
                monitor=mon, A=EMECoefficientDataArray(A, coords=coords),
                B=EMECoefficientDataArray(B, coords=coords)))

        elif isinstance(mon, EMEFieldMonitor):
            # axis sample positions: plane position for planar monitors,
            # cell centers within the box otherwise
            if mon.size[axis] == 0.0:
                zs = np.array([mon.center[axis]])
            else:
                zs = np.asarray([c for c in centers
                                 if rmin[axis] <= c <= rmax[axis]])
                if len(zs) == 0:
                    zs = np.array([mon.center[axis]])
            z_cells = np.clip(np.searchsorted(boundaries, zs) - 1,
                              0, num_cells - 1)
            arrs = {}
            for comp in comps:
                arr0 = cell_modes[0].field_components[comp]
                tdims = [d for d in arr0.dims if d not in (n_dim, "f",
                                                           "mode_index")]
                t_inds = {}
                coords = {}
                for dim in tdims:
                    gi = "xyz".index(dim)
                    c0 = np.asarray(arr0.coords[dim])
                    t_inds[dim] = crop_inds(c0, rmin[gi], rmax[gi])
                    coords[dim] = c0[t_inds[dim]]
                coords[n_dim] = zs
                shape = [len(coords["x"]), len(coords["y"]),
                         len(coords["z"]), nf, num_sweep, 2, nm_rec]
                vals = np.zeros(shape, dtype=complex)
                sgn = comp_sign(comp)
                for zi, (zp, ci) in enumerate(zip(zs, z_cells)):
                    ci = int(ci)
                    v = np.asarray(cell_modes[ci].field_components[
                        comp].values)
                    v = np.take(v, 0, axis=axis)  # (d1, d2, f, m_basis)
                    for di, dim in enumerate(tdims):
                        v = np.take(v, t_inds[dim], axis=di)
                    for fi in range(nf):
                        betas = betas_all[fi]
                        for si, scale in enumerate(sweep_scales):
                            nm = nm_of(si)
                            dz = (zp - boundaries[ci]) * scale
                            phf = np.exp(1j * betas[ci][:nm] * dz)
                            for port in (0, 1):
                                st = entry_states[(fi, si, port)][ci]
                                F = phf[:, None] * st[:nm]
                                Bc = (1.0 / phf)[:, None] * st[nm:]
                                amp = F + sgn * Bc  # (m_basis, m_in)
                                field = np.einsum(
                                    "abm,mn->abn", v[:, :, fi, :nm],
                                    amp[:, :nm_rec])
                                idx = [slice(None)] * 3
                                idx[axis] = zi
                                vals[tuple(idx) + (fi, si, port,
                                                   slice(None))] = field
                arrs[comp] = EMEScalarFieldDataArray(vals, coords=dict(
                    x=coords["x"], y=coords["y"], z=coords["z"], f=freqs,
                    sweep_index=np.arange(num_sweep),
                    eme_port_index=np.array([0, 1]),
                    mode_index=np.arange(nm_rec)))
            out.append(EMEFieldData(monitor=mon, **arrs))
        else:
            log.warning(f"Unsupported EME monitor type "
                        f"{type(mon).__name__}; skipped.")
    return out


# --------------------------------------------------------------------------- #
# overlaps / matrices
# --------------------------------------------------------------------------- #


def _mode_fields_on_common_grid(data_a, data_b, fi: int, num_modes: int, axis: int):
    """Tangential fields of both bases interpolated to basis A's E grid."""
    b_dim = "xyz"[(axis + 1) % 3]
    c_dim = "xyz"[(axis + 2) % 3]

    def get(data, comp, target=None):
        arr = getattr(data, comp)
        arr = arr.isel(f=fi)
        # squeeze the normal axis
        n_dim = "xyz"[axis]
        if n_dim in arr.dims:
            arr = arr.isel(**{n_dim: 0})
        if target is not None:
            arr = arr.interp(coords=target, kwargs=dict(fill_value=0.0))
        return arr

    e_ref = get(data_a, f"E{b_dim}")
    target = {b_dim: e_ref.coords[b_dim], c_dim: e_ref.coords[c_dim]}
    fields = {}
    for tag, data in (("A", data_a), ("B", data_b)):
        for comp in (f"E{b_dim}", f"E{c_dim}", f"H{b_dim}", f"H{c_dim}"):
            fields[f"{tag}_{comp}"] = get(data, comp, target).values[..., :num_modes]
    wb = np.gradient(np.asarray(e_ref.coords[b_dim], dtype=float)) \
        if len(e_ref.coords[b_dim]) > 1 else np.ones(1)
    wc = np.gradient(np.asarray(e_ref.coords[c_dim], dtype=float)) \
        if len(e_ref.coords[c_dim]) > 1 else np.ones(1)
    return fields, b_dim, c_dim, wb, wc


def _interface_transfer(data_a, data_b, fi: int, num_modes: int, axis: int
                        ) -> np.ndarray:
    """Transfer matrix across the interface from basis A to basis B."""
    fields, b_dim, c_dim, wb, wc = _mode_fields_on_common_grid(
        data_a, data_b, fi, num_modes, axis)
    w2 = wb[:, None] * wc[None, :]

    def cross_int(e_tag, h_tag):
        # 1/2 int (E^e x H^h) . n  -> matrix (modes_e, modes_h)
        eb = fields[f"{e_tag}_E{b_dim}"]
        ec = fields[f"{e_tag}_E{c_dim}"]
        hb = fields[f"{h_tag}_H{b_dim}"]
        hc = fields[f"{h_tag}_H{c_dim}"]
        integrand = (np.einsum("xym,xyn->mn", eb * w2[..., None], hc)
                     - np.einsum("xym,xyn->mn", ec * w2[..., None], hb))
        return 0.5 * integrand

    P = cross_int("A", "B")          # (a, b)
    R = cross_int("B", "A")          # (b, a)
    NB = np.diag(cross_int("B", "B"))  # self overlap of B

    D_inv = np.diag(1.0 / NB)
    M1 = D_inv @ P.T   # maps (F+B) -> (F'+B')
    M2 = D_inv @ R     # maps (F-B) -> (F'-B')
    n = num_modes
    T = np.zeros((2 * n, 2 * n), dtype=complex)
    T[:n, :n] = 0.5 * (M1 + M2)
    T[:n, n:] = 0.5 * (M1 - M2)
    T[n:, :n] = 0.5 * (M1 - M2)
    T[n:, n:] = 0.5 * (M1 + M2)
    return T


def _apply_constraint(s_blocks, constraint, n: int):
    """Project the S-matrix onto the passive (singular values <= 1) or
    unitary (= 1) set; truncating the mode basis at an interface can
    otherwise produce slight gain (reference: eme/simulation.py constraint
    field)."""
    if constraint not in ("passive", "unitary"):
        return s_blocks
    s11, s12, s21, s22 = s_blocks
    S = np.block([[s11, s12], [s21, s22]])
    u, sv, vh = np.linalg.svd(S)
    sv = np.minimum(sv, 1.0) if constraint == "passive" else np.ones_like(sv)
    S = (u * sv) @ vh
    return S[:n, :n], S[:n, n:], S[n:, :n], S[n:, n:]


def _transfer_to_smatrix(T: np.ndarray, n: int):
    """Convert a total transfer matrix [F_out; B_out] = T [F_in; B_in] into
    S-matrix blocks (S11, S12, S21, S22)."""
    T11 = T[:n, :n]
    T12 = T[:n, n:]
    T21 = T[n:, :n]
    T22 = T[n:, n:]
    T22_inv = np.linalg.pinv(T22)
    S21 = T11 - T12 @ T22_inv @ T21
    S11 = -T22_inv @ T21
    S12 = T22_inv
    S22_ = T12 @ T22_inv
    return S11, S12, S21, S22_
