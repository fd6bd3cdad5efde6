"""ModeSolver: user-facing mode solving on a plane of a Simulation.

Behavioral model: the upstream tidy3d plugins/mode/mode_solver.py
(ModeSolver:97 — plane discretization, per-freq solve loop, eps construction
on the Yee cross-section, normalization, group index, to_source/to_monitor).

The local coordinate frame maps the plane normal axis ``a`` to the solver's
propagation axis, with in-plane axes in cyclic order (b, c) = (a+1, a+2) mod
3 — the same convention as flux/overlap integrals, so the global Yee
staggering restricts to the solver's local staggering exactly.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import pydantic

from ...components.base import Tidy3dBaseModel, cached_property
from ...components.data.data_array import (
    FreqDataArray,
    GroupIndexDataArray,
    ModeIndexDataArray,
    ScalarModeFieldDataArray,
)
from ...components.data.dataset import ModeSolverDataset
from ...components.data.monitor_data import ModeSolverData, _mode_overlaps
from ...components.geometry.base import Box
from ...components.mode import ModeSpec
from ...components.monitor import ModeMonitor, ModeSolverMonitor
from ...components.simulation import Simulation
from ...components.source import GaussianPulse, ModeSource, SourceTime
from ...components.types import Direction, FreqArray, annotate_type
from ...constants import C_0
from ...exceptions import SetupError, ValidationError
from ...log import log
from .device_solver import solve_on
from .solver import compute_modes

# fraction of cells under which we warn the plane is too coarse
MIN_PLANE_CELLS_WARN = 4


class ModeSolver(Tidy3dBaseModel):
    """Solves for the eigenmodes of a plane cross-section of a simulation."""

    simulation: Simulation = pydantic.Field(..., title="Simulation")
    plane: Box = pydantic.Field(..., title="Plane")
    mode_spec: ModeSpec = pydantic.Field(default_factory=ModeSpec, title="Mode specification")
    freqs: FreqArray = pydantic.Field(..., title="Frequencies")
    direction: Direction = pydantic.Field("+", title="Propagation direction")
    colocate: bool = pydantic.Field(True, title="Colocate fields")

    @pydantic.field_validator("plane")
    @classmethod
    def _plane_is_planar(cls, val):
        if tuple(val.size).count(0.0) != 1:
            raise ValidationError(f"ModeSolver plane must be planar, given size={val.size}")
        return val

    @cached_property
    def normal_axis(self) -> int:
        return tuple(self.plane.size).index(0.0)

    @cached_property
    def plane_axes(self) -> Tuple[int, int]:
        a = self.normal_axis
        return ((a + 1) % 3, (a + 2) % 3)

    @cached_property
    def solver_symmetry(self) -> Tuple[int, int]:
        return (0, 0)

    # ------------------------------------------------------------------ #
    # grid / eps construction
    # ------------------------------------------------------------------ #

    @cached_property
    def _plane_grid(self):
        """In-plane cell boundary coords (b_axis, c_axis) within the plane."""
        grid = self.simulation.grid
        b, c = self.plane_axes
        span = grid.discretize_inds(self.plane, extend=False)
        out = []
        for axis in (b, c):
            beg, end = span[axis]
            coords = np.asarray(grid.boundaries.to_list[axis])[beg:end + 1]
            if len(coords) < MIN_PLANE_CELLS_WARN:
                log.warning("mode plane has very few cells along axis "
                            f"{'xyz'[axis]}; increase plane size or resolution.")
            out.append(coords)
        return tuple(out)

    def _comp_coords(self, comp_local: str):
        """Global (x, y, z) coords of a local Yee component on the plane."""
        a = self.normal_axis
        b, c = self.plane_axes
        x_b, y_b = self._plane_grid
        centers_b = 0.5 * (x_b[1:] + x_b[:-1])
        centers_c = 0.5 * (y_b[1:] + y_b[:-1])
        pos_normal = self.plane.center[a]
        # local component positions: Ex at (cx, y), Ey at (x, cy), Ez at (x, y)
        # Hx at (x, cy), Hy at (cx, y), Hz at (cx, cy)
        local_positions = {
            "Ex": (centers_b, y_b[:-1]), "Ey": (x_b[:-1], centers_c),
            "Ez": (x_b[:-1], y_b[:-1]),
            "Hx": (x_b[:-1], centers_c), "Hy": (centers_b, y_b[:-1]),
            "Hz": (centers_b, centers_c),
        }
        pb, pc = local_positions[comp_local]
        coords = [None, None, None]
        coords[a] = np.array([pos_normal])
        coords[b] = pb
        coords[c] = pc
        return coords

    @cached_property
    def _has_full_anisotropy(self) -> bool:
        media = [self.simulation.medium] + [s.medium
                                            for s in self.simulation.structures]
        return any(getattr(m, "is_fully_anisotropic", False) for m in media)

    def _eps_row_subpixel(self, coords, freq: float, row_axis: int):
        """One row of the 3x3 eps tensor at the given Yee points: the
        diagonal entry gets SDF polarized subpixel averaging (the same
        scheme the FDTD lowering applies, solver/lowering.py:475-502 —
        the reference applies subpixel on the mode plane server-side,
        SURVEY §2.3 item 7), off-diagonals staircase. Returns a dict
        col_axis -> complex array of shape (len(xs), len(ys), len(zs))."""
        from ...components.medium import PECMedium
        from ...components.subpixel_spec import PolarizedAveraging
        from ...constants import pec_val

        sim = self.simulation
        xs, ys, zs = [np.asarray(v, dtype=float) for v in coords]
        shape = (len(xs), len(ys), len(zs))

        def eps_row_of(medium):
            """(row entries) of the medium eps tensor at freq."""
            if isinstance(medium, PECMedium):
                return {ax: (pec_val + 0j if ax == row_axis else 0j)
                        for ax in range(3)}
            if getattr(medium, "is_fully_anisotropic", False):
                return {ax: medium.eps_comp(row_axis, ax, freq)
                        for ax in range(3)}
            diag = medium.eps_diagonal(freq)
            return {ax: (diag[row_axis] if ax == row_axis else 0j)
                    for ax in range(3)}

        bg = eps_row_of(sim.medium)
        row = {ax: np.full(shape, bg[ax], dtype=complex) for ax in range(3)}

        sp_spec = sim.subpixel_spec
        use_polarized = isinstance(sp_spec.dielectric, PolarizedAveraging)
        b, c = self.plane_axes
        plane_bounds = self._plane_grid
        # interface smear width: mean in-plane cell size, EXCLUDING
        # single-cell axes (a collapsed 2D-simulation axis has one fat
        # cell that resolves no variation — folding it in smears the
        # subpixel blend across the whole cross-section)
        dl_axes = [float(np.mean(np.diff(pb))) for pb in plane_bounds
                   if len(pb) > 2]
        if not dl_axes:
            dl_axes = [float(np.mean(np.diff(pb))) for pb in plane_bounds]
        dl = float(np.mean(dl_axes))
        half = dl / 2.0

        for structure in sim.volumetric_structures:
            geometry = structure.geometry
            medium = structure.medium
            rmin, rmax = geometry.bounds
            ix = np.nonzero((xs >= rmin[0] - dl) & (xs <= rmax[0] + dl))[0]
            iy = np.nonzero((ys >= rmin[1] - dl) & (ys <= rmax[1] + dl))[0]
            iz = np.nonzero((zs >= rmin[2] - dl) & (zs <= rmax[2] + dl))[0]
            if len(ix) == 0 or len(iy) == 0 or len(iz) == 0:
                continue
            sl = np.ix_(ix, iy, iz)
            s_row = eps_row_of(medium)
            is_pec = isinstance(medium, PECMedium)
            smooth = (use_polarized and not is_pec
                      and not getattr(medium, "is_custom", False)
                      and not getattr(medium, "is_fully_anisotropic", False)
                      and getattr(medium, "is_spatially_uniform", True)
                      and getattr(medium, "is_isotropic", True)
                      and hasattr(geometry, "sdf"))
            # coordinate stencils: singleton axes get a +-dl/2 stencil so
            # the SDF gradient (interface normal) includes the plane
            # normal direction
            pts = []
            slices = []
            for vals, idx in zip((xs, ys, zs), (ix, iy, iz)):
                v = vals[idx]
                if smooth and len(v) == 1:
                    pts.append(np.array([v[0] - half, v[0], v[0] + half]))
                    slices.append(slice(1, 2))
                else:
                    pts.append(v)
                    slices.append(slice(None))
            xg, yg, zg = np.meshgrid(*pts, indexing="ij", sparse=True)
            if smooth:
                sdf = np.broadcast_to(
                    geometry.sdf(xg, yg, zg),
                    (len(pts[0]), len(pts[1]), len(pts[2])))
                grads = [np.zeros_like(sdf) for _ in range(3)]
                for axg in range(3):
                    if len(pts[axg]) > 1:
                        grads[axg] = np.gradient(sdf, pts[axg], axis=axg,
                                                 edge_order=1)
                gnorm = np.sqrt(sum(g**2 for g in grads)) + 1e-30
                n_comp = (grads[row_axis] / gnorm)[tuple(slices)]
                frac = np.clip(0.5 - sdf / dl, 0.0, 1.0)[tuple(slices)]
                if np.all(frac == 0):
                    continue
                eps_old = row[row_axis][sl]
                s_eps = s_row[row_axis]
                eps_arith = frac * s_eps + (1 - frac) * eps_old
                eps_old_safe = np.where(np.abs(eps_old) < 1e-6, 1e-6,
                                        eps_old)
                eps_harm = 1.0 / (frac / s_eps + (1 - frac) / eps_old_safe)
                w_n = n_comp**2
                row[row_axis][sl] = (1 - w_n) * eps_arith + w_n * eps_harm
                # off-diagonals of an isotropic structure are zero; blend
                # any background off-diagonal out by the coverage fraction
                for ax in range(3):
                    if ax != row_axis:
                        row[ax][sl] = (1 - frac) * row[ax][sl]
            else:
                mask = geometry.inside(xg, yg, zg)
                mask = np.broadcast_to(
                    mask, (len(pts[0]), len(pts[1]), len(pts[2])))
                mask = mask[tuple(slices)]
                if not np.any(mask):
                    continue
                if getattr(medium, "is_custom", False) and hasattr(
                        medium, "eps_dataarray_freq"):
                    comp_arr = medium.eps_dataarray_freq(freq)[row_axis]
                    vals = comp_arr.interp(
                        x=xs[ix], y=ys[iy], z=zs[iz],
                        method="linear" if getattr(medium, "interp_method",
                                                   "nearest") == "linear"
                        else "nearest",
                        kwargs=dict(fill_value=None),
                    ).values
                    row[row_axis][sl] = np.where(mask, vals,
                                                 row[row_axis][sl])
                    for ax in range(3):
                        if ax != row_axis:
                            row[ax][sl] = np.where(mask, 0j, row[ax][sl])
                else:
                    for ax in range(3):
                        row[ax][sl] = np.where(mask, s_row[ax], row[ax][sl])
        return row

    def _solver_eps(self, freq: float):
        """Local-axes eps at the local Yee points: the full 9-component
        Yee-averaged tensor when fully anisotropic media are present
        (reference mode_solver.py:587-653), otherwise the 3 diagonal
        components — in both cases with SDF polarized subpixel averaging
        on the diagonals (closing the staircase-order gap; the FDTD core
        already has real subpixel)."""
        a = self.normal_axis
        b, c = self.plane_axes
        l2g = (b, c, a)  # local (x, y, z) -> global axes

        def to_2d(arr):
            arr2 = np.squeeze(arr, axis=a)
            return arr2.T if b > c else arr2

        rows = []
        for local_row, g_row in (("Ex", b), ("Ey", c), ("Ez", a)):
            coords = self._comp_coords(local_row)
            rows.append(self._eps_row_subpixel(coords, freq, g_row))
        if not self._has_full_anisotropy:
            return tuple(to_2d(rows[i][l2g[i]]) for i in range(3))
        out = []
        for i in range(3):
            for j in range(3):
                out.append(to_2d(rows[i][l2g[j]]))
        return tuple(out)

    # ------------------------------------------------------------------ #
    # solving
    # ------------------------------------------------------------------ #

    @cached_property
    def data_raw(self) -> ModeSolverData:
        """Solve and return un-colocated mode data."""
        x_b, y_b = self._plane_grid
        freqs = np.atleast_1d(np.asarray(self.freqs, dtype=float))
        num_modes = self.mode_spec.num_modes
        a = self.normal_axis
        b, c = self.plane_axes

        field_arrays = {comp: [] for comp in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")}
        n_complex = np.zeros((len(freqs), num_modes), dtype=complex)

        # map local solver components back to global components
        local_to_global = {
            "Ex": f"E{'xyz'[b]}", "Ey": f"E{'xyz'[c]}", "Ez": f"E{'xyz'[a]}",
            "Hx": f"H{'xyz'[b]}", "Hy": f"H{'xyz'[c]}", "Hz": f"H{'xyz'[a]}",
        }

        for fi, freq in enumerate(freqs):
            eps_cross = self._solver_eps(freq)
            fields, n_c = compute_modes(
                eps_cross, (x_b, y_b), freq, self.mode_spec,
                direction=self.direction,
            )
            nm = min(len(n_c), num_modes)
            n_complex[fi, :nm] = n_c[:nm]
            fields = self._normalize_modes(fields, n_c, freq, x_b, y_b)
            for local_comp, arr in fields.items():
                field_arrays[local_to_global[local_comp]].append(arr[:, :, :num_modes])

        # assemble DataArrays with global coords
        data_fields = {}
        for local_comp, global_comp in local_to_global.items():
            stack = np.stack(field_arrays[global_comp], axis=2)  # (nb, nc, nf, nm)
            coords = self._comp_coords(local_comp)
            # expand to (x, y, z, f, mode_index) in global order
            arr = stack[..., None, :, :] if False else stack
            # current dims: (b, c, f, m); insert normal singleton and reorder
            arr = np.expand_dims(arr, axis=2)  # (b, c, 1, f, m)
            # build axis order mapping local (b, c, a) -> global (x, y, z)
            perm = np.argsort([b, c, a])  # positions of sorted global axes
            arr = np.transpose(arr, tuple(perm) + (3, 4))
            coord_dict = {
                "xyz"[axis]: np.asarray(coords[axis]) for axis in range(3)
            }
            coord_dict["f"] = freqs
            coord_dict["mode_index"] = np.arange(num_modes)
            data_fields[global_comp] = ScalarModeFieldDataArray(
                arr, coords={k: coord_dict[k] for k in ("x", "y", "z", "f",
                                                        "mode_index")})

        n_da = ModeIndexDataArray(
            n_complex, coords=dict(f=freqs, mode_index=np.arange(num_modes)))

        monitor = ModeSolverMonitor(
            center=self.plane.center, size=self.plane.size,
            freqs=freqs.tolist(), mode_spec=self.mode_spec,
            direction=self.direction, name="<mode_solver>", colocate=False,
        )
        data = ModeSolverData(monitor=monitor, n_complex=n_da, **data_fields)

        if self.mode_spec.track_freq is not None and len(freqs) > 1:
            data = data.overlap_sort(self.mode_spec.track_freq)
        if self.mode_spec.group_index_step:
            data = self._add_group_index(data)
        return data

    def _normalize_modes(self, fields, n_c, freq, x_b, y_b):
        """Normalize each mode to unit power flux along the normal."""
        # local flux: S_z = Ex Hy* - Ey Hx* integrated over the plane with
        # cell-overlap weights (fields at slightly different Yee points; use
        # simple colocation-free Riemann sum adequate for normalization)
        wx = np.diff(x_b)
        wy = np.diff(y_b)
        nmodes = fields["Ex"].shape[-1]
        for m in range(nmodes):
            sz = np.real(
                fields["Ex"][:, :, m] * np.conj(fields["Hy"][:, :, m])
                - fields["Ey"][:, :, m] * np.conj(fields["Hx"][:, :, m]))
            power = 0.5 * float(np.sum(sz * wx[:, None] * wy[None, :]))
            if abs(power) < 1e-30:
                continue
            scale = 1.0 / np.sqrt(abs(power))
            phase = 1.0
            # fix global phase: make the dominant E component real-positive
            # at its max |value| location
            e_all = np.stack([fields[c][:, :, m] for c in ("Ex", "Ey")])
            idx = np.unravel_index(np.argmax(np.abs(e_all)), e_all.shape)
            val = e_all[idx]
            if abs(val) > 0:
                phase = np.abs(val) / val
            for comp in fields:
                fields[comp][:, :, m] *= scale * phase
        return fields

    def _add_group_index(self, data: ModeSolverData) -> ModeSolverData:
        """3-point finite-difference group index n_g = n - lam dn/dlam."""
        step = float(self.mode_spec.group_index_step)
        freqs = np.atleast_1d(np.asarray(self.freqs, dtype=float))
        n_g = np.zeros((len(freqs), self.mode_spec.num_modes))
        for fi, f0 in enumerate(freqs):
            fp, fm = f0 * (1 + step), f0 * (1 - step)
            solver_pm = self.copy(update=dict(
                freqs=[fm, fp],
                mode_spec=self.mode_spec.copy(update=dict(group_index_step=False)),
            ))
            n_pm = solver_pm.data_raw.n_complex.values
            n0 = data.n_complex.values[fi]
            # n_g = d(f n)/df
            n_g[fi] = np.real(
                (fp * n_pm[1] - fm * n_pm[0]) / (fp - fm))
        return data.copy(update=dict(n_group_raw=GroupIndexDataArray(
            n_g, coords=dict(f=freqs, mode_index=np.arange(self.mode_spec.num_modes)))))

    @cached_property
    def data(self) -> ModeSolverData:
        """Mode data, colocated to the plane grid boundaries if requested."""
        data = self.data_raw
        if not self.colocate:
            return data
        # colocate fields onto the in-plane boundary positions
        x_b, y_b = self._plane_grid
        a = self.normal_axis
        b, c = self.plane_axes
        targets = {"xyz"[b]: x_b[:-1], "xyz"[c]: y_b[:-1]}
        update = {}
        for comp, arr in data.field_components.items():
            update[comp] = ScalarModeFieldDataArray(
                arr.interp(coords=targets, kwargs=dict(fill_value=None)).values,
                coords={**{d: (targets[d] if d in targets else arr.coords[d])
                           for d in ("x", "y", "z")},
                        "f": arr.coords["f"], "mode_index": arr.coords["mode_index"]},
            )
        return data.copy(update=update)

    def solve(self, device=None) -> ModeSolverData:
        """The mode data; a plane routed to the device filter runs it on
        ``device`` (None: the innermost ``device_solver.solve_on`` scope's,
        else CUDA)."""
        if device is None:
            return self.data
        with solve_on(device):
            return self.data

    # ------------------------------------------------------------------ #
    # exports
    # ------------------------------------------------------------------ #

    def to_source(self, source_time: SourceTime, direction: Direction = None,
                  mode_index: int = 0, **kwargs) -> ModeSource:
        return ModeSource(
            center=self.plane.center, size=self.plane.size,
            source_time=source_time, mode_spec=self.mode_spec,
            mode_index=mode_index,
            direction=direction or self.direction, **kwargs,
        )

    def to_monitor(self, freqs=None, name: str = "mode_monitor", **kwargs) -> ModeMonitor:
        freqs = freqs if freqs is not None else list(np.asarray(self.freqs))
        return ModeMonitor(
            center=self.plane.center, size=self.plane.size,
            freqs=list(np.asarray(freqs)), mode_spec=self.mode_spec, name=name,
            **kwargs,
        )

    @cached_property
    def reduced_simulation_copy(self) -> "ModeSolver":
        """Solver with the simulation cropped to the plane surroundings."""
        new_sim = self.simulation.subsection(self.plane)
        return self.copy(update=dict(simulation=new_sim))
