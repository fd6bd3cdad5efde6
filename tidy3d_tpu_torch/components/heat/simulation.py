"""Heat simulation specification + native steady-state solver.

Behavioral model: tidy3d v2.7.6 components/heat/simulation.py
(HeatSimulation:45; the reference's solver is cloud-side/unstructured-FEM).
Here a native structured finite-volume steady-state conduction solver is
provided (scipy sparse CG); the schema mirrors the reference so inputs carry
over.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import pydantic
import scipy.sparse as sp
import scipy.sparse.linalg as spl

from ...exceptions import SetupError
from ...log import log
from ..base import cached_property
from ..data.data_array import SpatialDataArray
from ..geometry.base import Box
from ..grid.grid_spec import GridSpec
from ..medium import Medium, MediumType3D
from ..structure import Structure
from ..types import annotate_type
from .boundary import (
    ConvectionBC,
    HeatBoundarySpec,
    HeatFluxBC,
    MediumMediumInterface,
    SimulationBoundary,
    StructureBoundary,
    StructureSimulationBoundary,
    StructureStructureInterface,
    TemperatureBC,
)
from .data import HeatSimulationData, TemperatureData
from .heat_spec import SolidSpec
from .monitor import TemperatureMonitor
from .source import UniformHeatSource


def _axis_view(vec: np.ndarray, axis: int) -> np.ndarray:
    """Reshape a 1D per-cell vector for broadcasting along `axis`."""
    shape = [1, 1, 1]
    shape[axis] = len(vec)
    return vec.reshape(shape)


def _to_unstructured(T: np.ndarray, cs):
    """Structured monitor temperature -> tri/tet unstructured dataset.

    The FVM solution lives on the structured grid; ``unstructured=True``
    monitors return it on a conforming simplicial mesh of the same nodes
    (2 triangles/quad on planes, 6 Kuhn tetrahedra/hex in 3D) so that
    downstream consumers of the reference's unstructured heat schema
    (plane_slice/interp/sel_inside, ``perturbed_mediums_copy``) work
    unchanged.
    """
    from ..data.unstructured import (
        CellDataArray,
        IndexedDataArray,
        PointDataArray,
        TetrahedralGridDataset,
        TriangularGridDataset,
    )

    dims = [len(c) for c in cs]
    flat_axes = [a for a in range(3) if dims[a] == 1]
    vals = IndexedDataArray(
        np.asarray(T, float).ravel(),
        coords=dict(index=np.arange(T.size)))
    if flat_axes:
        # plane (or line/point degenerate: still a plane dataset)
        ax_n = flat_axes[0]
        uv_axes = [a for a in range(3) if a != ax_n]
        nu, nv = dims[uv_axes[0]], dims[uv_axes[1]]
        U, V = np.meshgrid(cs[uv_axes[0]], cs[uv_axes[1]], indexing="ij")
        pts = np.column_stack([U.ravel(), V.ravel()])
        tris = []
        for i in range(max(nu - 1, 0)):
            for j in range(max(nv - 1, 0)):
                p00 = i * nv + j
                p01 = p00 + 1
                p10 = p00 + nv
                p11 = p10 + 1
                tris += [(p00, p10, p11), (p00, p11, p01)]
        tris = np.asarray(tris, int).reshape(-1, 3)
        return TriangularGridDataset(
            normal_axis=ax_n, normal_pos=float(cs[ax_n][0]),
            points=PointDataArray(pts, coords=dict(
                index=np.arange(len(pts)), axis=np.arange(2))),
            values=vals,
            cells=CellDataArray(tris, coords=dict(
                cell_index=np.arange(len(tris)),
                vertex_index=np.arange(3))))
    nx, ny, nz = dims
    X, Y, Z = np.meshgrid(*cs, indexing="ij")
    pts = np.column_stack([X.ravel(), Y.ravel(), Z.ravel()])

    def pid(i, j, k):
        return (i * ny + j) * nz + k

    # Kuhn triangulation: 6 tets per hex, all sharing the main diagonal
    # c0-c7 -> consistent across neighboring hexes
    corner_paths = [
        (0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7),
        (0, 6, 4, 7), (0, 4, 5, 7), (0, 5, 1, 7),
    ]
    offs = [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
            (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)]
    tets = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            for k in range(nz - 1):
                cid = [pid(i + di, j + dj, k + dk) for di, dj, dk in offs]
                for path in corner_paths:
                    tets.append(tuple(cid[c] for c in path))
    tets = np.asarray(tets, int).reshape(-1, 4)
    return TetrahedralGridDataset(
        points=PointDataArray(pts, coords=dict(
            index=np.arange(len(pts)), axis=np.arange(3))),
        values=vals,
        cells=CellDataArray(tets, coords=dict(
            cell_index=np.arange(len(tets)), vertex_index=np.arange(4))))


class HeatSimulation(Box):
    """Steady-state heat conduction simulation."""

    medium: annotate_type(MediumType3D) = pydantic.Field(
        default_factory=Medium, title="Background medium")
    structures: Tuple[Structure, ...] = pydantic.Field((), title="Structures")
    boundary_spec: Tuple[HeatBoundarySpec, ...] = pydantic.Field(
        (), title="Boundary conditions")
    sources: Tuple[UniformHeatSource, ...] = pydantic.Field((), title="Heat sources")
    monitors: Tuple[TemperatureMonitor, ...] = pydantic.Field((), title="Monitors")
    grid_spec: GridSpec = pydantic.Field(default_factory=lambda: GridSpec.uniform(dl=1.0),
                                         title="Grid specification")
    symmetry: Tuple[int, int, int] = pydantic.Field((0, 0, 0))

    @cached_property
    def grid(self):
        sim_structure = Structure(
            geometry=Box(center=self.center, size=self.size), medium=self.medium)
        return self.grid_spec.make_grid(
            structures=[sim_structure] + list(self.structures))

    # ------------------------------------------------------------------ #
    # native solve
    # ------------------------------------------------------------------ #

    def run(self, verbose: bool = False) -> HeatSimulationData:
        """Solve steady-state div(k grad T) = -q on the structured grid.

        Vectorized 7-point finite-volume assembly (harmonic-mean face
        conductivities) with BC placements (reference: heat/boundary.py
        bc_placement variants):

        * ``SimulationBoundary``: BC on all outer faces of solid cells.
        * ``StructureSimulationBoundary``: same, restricted to cells of the
          named structure.
        * ``StructureBoundary`` + ``TemperatureBC``: cells of the named
          structure are pinned (Dirichlet plate approximation).
        * ``StructureBoundary`` + ``ConvectionBC``/``HeatFluxBC``: applied on
          faces between the named structure's solid cells and fluid cells.
        * ``MediumMediumInterface`` / ``StructureStructureInterface`` +
          ``ConvectionBC``: Robin link on the interface faces.

        Fluid cells (no ``SolidSpec``) are adiabatic holes reported at the
        ambient temperature.
        """
        grid = self.grid
        xs = np.asarray(grid.centers.x)
        ys = np.asarray(grid.centers.y)
        zs = np.asarray(grid.centers.z)
        nx, ny, nz = len(xs), len(ys), len(zs)
        shape = (nx, ny, nz)

        # material maps at cell centers (conductivity 0 marks fluid)
        k_map = np.zeros(shape)
        q_map = np.zeros(shape)
        struct_masks = {}
        bg_spec = getattr(self.medium, "heat_spec", None)
        if isinstance(bg_spec, SolidSpec):
            k_map[:] = bg_spec.conductivity
        xg, yg, zg = np.meshgrid(xs, ys, zs, indexing="ij", sparse=True)
        source_rates = {}
        for src in self.sources:
            for name in src.structures:
                source_rates[name] = src.rate
        medium_masks = {}
        for structure in self.structures:
            spec = getattr(structure.medium, "heat_spec", None)
            mask = np.broadcast_to(structure.geometry.inside(xg, yg, zg), shape)
            if structure.name is not None:
                struct_masks[structure.name] = mask
            med_name = getattr(structure.medium, "name", None)
            if med_name is not None:
                medium_masks[med_name] = np.logical_or(
                    medium_masks.get(med_name, False), mask)
            if isinstance(spec, SolidSpec):
                k_map = np.where(mask, spec.conductivity, k_map)
            else:
                k_map = np.where(mask, 0.0, k_map)
            if structure.name in source_rates:
                q_map = np.where(mask, source_rates[structure.name], q_map)

        dx = np.diff(np.asarray(grid.boundaries.x))
        dy = np.diff(np.asarray(grid.boundaries.y))
        dz = np.diff(np.asarray(grid.boundaries.z))
        steps = (dx, dy, dz)
        vol = dx[:, None, None] * dy[None, :, None] * dz[None, None, :]
        solid = k_map > 0

        # ---- classify boundary specs ---------------------------------- #
        ambient = 300.0
        sim_bcs = []           # (condition, cell mask restriction or None)
        pinT = np.full(shape, np.nan)
        fluid_face_bcs = []    # (condition, solid-side mask)
        interface_bcs = []     # (condition, mask_a, mask_b)
        for bc in self.boundary_spec:
            cond, placement = bc.condition, bc.placement
            if isinstance(placement, SimulationBoundary):
                sim_bcs.append((cond, None))
                if isinstance(cond, TemperatureBC):
                    ambient = cond.temperature
                elif isinstance(cond, ConvectionBC):
                    ambient = cond.ambient_temperature
            elif isinstance(placement, StructureSimulationBoundary):
                mask = struct_masks.get(placement.structure)
                if mask is None:
                    raise SetupError(
                        f"unknown structure '{placement.structure}' in BC")
                sim_bcs.append((cond, mask))
            elif isinstance(placement, StructureBoundary):
                mask = struct_masks.get(placement.structure)
                if mask is None:
                    raise SetupError(
                        f"unknown structure '{placement.structure}' in BC")
                if isinstance(cond, TemperatureBC):
                    pinT = np.where(mask, cond.temperature, pinT)
                else:
                    fluid_face_bcs.append((cond, mask))
            elif isinstance(placement, StructureStructureInterface):
                m_a = struct_masks.get(placement.structures[0])
                m_b = struct_masks.get(placement.structures[1])
                if m_a is None or m_b is None:
                    raise SetupError("unknown structure in interface BC")
                interface_bcs.append((cond, m_a, m_b))
            elif isinstance(placement, MediumMediumInterface):
                m_a = medium_masks.get(placement.mediums[0])
                m_b = medium_masks.get(placement.mediums[1])
                if m_a is None or m_b is None:
                    raise SetupError("unknown medium name in interface BC")
                interface_bcs.append((cond, m_a, m_b))

        pinned = solid & ~np.isnan(pinT)
        free = solid & ~pinned
        n_free = int(np.count_nonzero(free))
        gidx = -np.ones(shape, dtype=np.int64)
        gidx[free] = np.arange(n_free)

        rows, cols, vals = [], [], []
        diag = np.zeros(shape)
        rhs = np.where(free, q_map * vol, 0.0)

        # ---- interior faces per axis ---------------------------------- #
        for axis in range(3):
            sl_a = [slice(None)] * 3
            sl_b = [slice(None)] * 3
            sl_a[axis] = slice(0, shape[axis] - 1)
            sl_b[axis] = slice(1, shape[axis])
            sl_a, sl_b = tuple(sl_a), tuple(sl_b)
            k_a, k_b = k_map[sl_a], k_map[sl_b]
            with np.errstate(divide="ignore", invalid="ignore"):
                k_face = np.where((k_a > 0) & (k_b > 0),
                                  2 * k_a * k_b / np.where(k_a + k_b > 0,
                                                           k_a + k_b, 1.0), 0.0)
            d = steps[axis]
            d_a = _axis_view(d[:-1], axis)
            d_b = _axis_view(d[1:], axis)
            area = (vol[sl_a] / _axis_view(d[:-1], axis))
            dist = 0.5 * (d_a + d_b)
            g = k_face * area / dist

            free_a, free_b = free[sl_a], free[sl_b]
            pin_a, pin_b = pinned[sl_a], pinned[sl_b]

            # free-free: symmetric off-diagonal pair
            ff = (g > 0) & free_a & free_b
            ia, ib = gidx[sl_a][ff], gidx[sl_b][ff]
            gv = g[ff]
            rows.extend([ia, ib])
            cols.extend([ib, ia])
            vals.extend([-gv, -gv])
            d_add = np.zeros_like(g)
            d_add[ff] = gv
            diag[sl_a] += d_add
            dbb = np.zeros_like(g)
            dbb[ff] = gv
            diag[sl_b] += dbb

            # free-pinned: Dirichlet elimination into rhs
            for m_free, m_pin, sl_f, sl_p in (((free_a & pin_b), None, sl_a, sl_b),
                                              ((free_b & pin_a), None, sl_b, sl_a)):
                fp = (g > 0) & m_free
                add_d = np.zeros_like(g)
                add_d[fp] = g[fp]
                diag[sl_f] += add_d
                add_r = np.zeros_like(g)
                add_r[fp] = g[fp] * pinT[sl_p][fp]
                rhs[sl_f] += add_r

            # solid-fluid faces: convection/flux BCs on structure boundaries
            fl_a, fl_b = ~solid[sl_a], ~solid[sl_b]
            for cond, mask in fluid_face_bcs:
                for m_solid, m_fluid, sl_s in (((free_a & mask[sl_a] & fl_b), None, sl_a),
                                               ((free_b & mask[sl_b] & fl_a), None, sl_b)):
                    sel = m_solid
                    if not np.any(sel):
                        continue
                    if isinstance(cond, ConvectionBC):
                        add_d = np.zeros_like(g)
                        add_d[sel] = cond.transfer_coeff * area[sel]
                        diag[sl_s] += add_d
                        add_r = np.zeros_like(g)
                        add_r[sel] = (cond.transfer_coeff * area[sel]
                                      * cond.ambient_temperature)
                        rhs[sl_s] += add_r
                    elif isinstance(cond, HeatFluxBC):
                        add_r = np.zeros_like(g)
                        add_r[sel] = cond.flux * area[sel]
                        rhs[sl_s] += add_r

            # named interface faces (Robin link between two solids, or Robin
            # to ambient when one side is fluid)
            for cond, m_a, m_b in interface_bcs:
                iface = ((m_a[sl_a] & m_b[sl_b]) | (m_b[sl_a] & m_a[sl_b]))
                if not isinstance(cond, ConvectionBC) or not np.any(iface):
                    continue
                h = cond.transfer_coeff
                t_amb = cond.ambient_temperature
                for m_s, sl_s, m_o, sl_o in ((free_a & iface, sl_a, fl_b, sl_b),
                                             (free_b & iface, sl_b, fl_a, sl_a)):
                    sel = m_s & m_o
                    if not np.any(sel):
                        continue
                    add_d = np.zeros_like(g)
                    add_d[sel] = h * area[sel]
                    diag[sl_s] += add_d
                    add_r = np.zeros_like(g)
                    add_r[sel] = h * area[sel] * t_amb
                    rhs[sl_s] += add_r

        # ---- domain-boundary faces ------------------------------------ #
        for axis in range(3):
            for side in (0, -1):
                sl = [slice(None)] * 3
                sl[axis] = slice(0, 1) if side == 0 else slice(shape[axis] - 1,
                                                               shape[axis])
                sl = tuple(sl)
                d_self = steps[axis][0 if side == 0 else -1]
                area = vol[sl] / d_self
                k_here = k_map[sl]
                face_free = free[sl]
                for cond, restrict in sim_bcs:
                    sel = face_free if restrict is None \
                        else (face_free & restrict[sl])
                    if not np.any(sel):
                        continue
                    if isinstance(cond, TemperatureBC):
                        g = np.where(sel, k_here * area / (0.5 * d_self), 0.0)
                        diag[sl] += g
                        rhs[sl] += g * cond.temperature
                    elif isinstance(cond, ConvectionBC):
                        g = np.where(sel, cond.transfer_coeff * area, 0.0)
                        diag[sl] += g
                        rhs[sl] += g * cond.ambient_temperature
                    elif isinstance(cond, HeatFluxBC):
                        rhs[sl] += np.where(sel, cond.flux * area, 0.0)

        # ---- assemble + solve ----------------------------------------- #
        di = gidx[free]
        dv = np.where(diag[free] > 0, diag[free], 1.0)
        rows.append(di)
        cols.append(di)
        vals.append(dv)
        rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)
        cols = np.concatenate(cols) if cols else np.zeros(0, np.int64)
        vals = np.concatenate(vals) if vals else np.zeros(0)
        A = sp.csr_matrix((vals, (rows, cols)), shape=(n_free, n_free))
        b = rhs[free]
        if n_free:
            T_free, info = spl.cg(A, b, rtol=1e-10, maxiter=20000)
            if info != 0:
                T_free = spl.spsolve(A.tocsc(), b)
        else:
            T_free = np.zeros(0)

        T3 = np.full(shape, ambient)
        T3[free] = T_free
        T3[pinned] = pinT[pinned]

        data = []
        for monitor in self.monitors:
            (i0, i1), (j0, j1), (k0, k1) = grid.discretize_inds(monitor)
            Tm = T3[i0:i1, j0:j1, k0:k1]
            cs = (xs[i0:i1], ys[j0:j1], zs[k0:k1])
            if getattr(monitor, "unstructured", False):
                temp = _to_unstructured(Tm, cs)
            else:
                temp = SpatialDataArray(
                    Tm, coords=dict(x=cs[0], y=cs[1], z=cs[2]))
            data.append(TemperatureData(monitor=monitor, temperature=temp))
        return HeatSimulationData(simulation=self, data=tuple(data))
