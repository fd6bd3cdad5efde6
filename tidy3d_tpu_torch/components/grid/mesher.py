"""Structure-aware nonuniform 1D mesh generation.

Behavioral model: /root/reference/tidy3d/components/grid/mesher.py
(GradedMesher:72 — per-axis interval decomposition from structure bounds,
per-interval max step from the medium refractive index, graded growth bounded
by ``max_scale``, snapping points). Re-implemented with bounding-box interval
logic (the reference prunes with shapely/rtree 2D containment; bbox overlap is
a conservative approximation that only ever refines further).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Tuple

import numpy as np
import pydantic

from ...constants import C_0, fp_eps, inf
from ...exceptions import SetupError
from ..base import Tidy3dBaseModel

# minimum relative interval width to keep as a distinct interval
_MIN_INTERVAL_REL = 1e-6


class Mesher(Tidy3dBaseModel, ABC):
    """Abstract mesher."""

    @abstractmethod
    def make_coords(self, axis, structures, wavelength, min_steps_per_wvl, dl_min,
                    snapping_points, domain_bounds) -> np.ndarray:
        """Generate nonuniform boundary coordinates along one axis."""


class GradedMesher(Mesher):
    """Nonuniform mesher with graded step-size transitions."""

    def make_coords(
        self,
        axis: int,
        structures: list,
        wavelength: float,
        min_steps_per_wvl: float,
        dl_min: float,
        max_scale: float,
        snapping_points: List[Tuple[float, float, float]],
        domain_bounds: Tuple[float, float],
    ) -> np.ndarray:
        """Boundary coords in [domain_bounds] refined near structures.

        ``structures`` is a list of (bounds, max_dl) tuples prepared by the
        caller: bounds = ((xmin,ymin,zmin),(xmax,ymax,zmax)), max_dl = max
        allowed step inside that structure (wavelength / n / min_steps_per_wvl).
        The first entry must be the simulation domain with the background max_dl.
        """
        lo, hi = domain_bounds
        if hi <= lo:
            return np.array([lo, hi])
        domain_size = hi - lo

        # 1. collect interval boundaries: structure bounds + snapping points
        interval_coords = [lo, hi]
        for bounds, _ in structures:
            for val in (bounds[0][axis], bounds[1][axis]):
                if lo + fp_eps * domain_size < val < hi - fp_eps * domain_size:
                    interval_coords.append(float(val))
        for point in snapping_points or []:
            val = point[axis]
            if val is not None and lo < val < hi:
                interval_coords.append(float(val))
        interval_coords = np.array(sorted(set(interval_coords)))
        # merge intervals that are too small
        keep = [0]
        for i in range(1, len(interval_coords)):
            if interval_coords[i] - interval_coords[keep[-1]] > _MIN_INTERVAL_REL * domain_size:
                keep.append(i)
        interval_coords = interval_coords[keep]
        if interval_coords[-1] != hi:
            interval_coords[-1] = hi

        # 2. max dl per interval: finest among structures covering the interval
        num_intervals = len(interval_coords) - 1
        max_dl_list = np.full(num_intervals, np.inf)
        centers = 0.5 * (interval_coords[:-1] + interval_coords[1:])
        for bounds, max_dl in structures:
            smin, smax = bounds[0][axis], bounds[1][axis]
            covered = (centers >= smin - fp_eps * domain_size) & (
                centers <= smax + fp_eps * domain_size
            )
            max_dl_list[covered] = np.minimum(max_dl_list[covered], max_dl)
        max_dl_list = np.maximum(max_dl_list, dl_min if dl_min else 0.0)
        # never coarser than the interval itself requires at least 1 cell
        max_dl_list = np.minimum(max_dl_list, domain_size)

        # 3. fill each interval with graded steps
        return self.make_grid_multiple_intervals(
            max_dl_list, interval_coords, max_scale
        )

    # ------------------------------------------------------------------ #
    # graded filling
    # ------------------------------------------------------------------ #

    @staticmethod
    def make_grid_multiple_intervals(
        max_dl_list: np.ndarray, interval_coords: np.ndarray, max_scale: float
    ) -> np.ndarray:
        """Fill intervals with steps <= max_dl, ramping between neighbors by
        at most ``max_scale`` per step, snapping exactly to interval bounds."""
        num_intervals = len(max_dl_list)
        lengths = np.diff(interval_coords)

        # edge step limits: the step allowed at each interface is the min of
        # the two neighboring interval targets
        left_dl = np.empty(num_intervals)
        right_dl = np.empty(num_intervals)
        for i in range(num_intervals):
            left_dl[i] = min(max_dl_list[i], max_dl_list[i - 1]) if i > 0 else max_dl_list[i]
            right_dl[i] = (
                min(max_dl_list[i], max_dl_list[i + 1]) if i < num_intervals - 1
                else max_dl_list[i]
            )

        all_coords = [interval_coords[0]]
        for i in range(num_intervals):
            steps = GradedMesher._fill_interval(
                lengths[i], left_dl[i], right_dl[i], max_dl_list[i], max_scale
            )
            coords = interval_coords[i] + np.cumsum(steps)
            coords[-1] = interval_coords[i + 1]  # exact snap
            all_coords.extend(coords.tolist())
        return np.asarray(all_coords)

    @staticmethod
    def _fill_interval(length: float, dl_left: float, dl_right: float,
                       dl_max: float, max_scale: float) -> np.ndarray:
        """Step sizes filling ``length``: ramp up from dl_left, plateau at
        dl_max, ramp down to dl_right; then uniformly rescaled to fit."""
        if length <= 0:
            return np.array([])
        dl_left = min(dl_left, dl_max)
        dl_right = min(dl_right, dl_max)
        # if even a single smallest step overshoots, one cell
        if length <= min(dl_left, dl_right):
            return np.array([length])

        # build ramps
        def ramp(dl_start: float) -> List[float]:
            out = []
            dl = dl_start
            total = 0.0
            while dl < dl_max * (1 - fp_eps) and total < length / 2:
                out.append(dl)
                total += dl
                dl = min(dl * max_scale, dl_max)
            return out

        ramp_l = ramp(dl_left)
        ramp_r = ramp(dl_right)
        len_l, len_r = sum(ramp_l), sum(ramp_r)

        remaining = length - len_l - len_r
        if remaining < 0:
            # interval too short for full ramps: trim ramps symmetrically
            steps = ramp_l + ramp_r[::-1]
            steps = np.asarray(steps if steps else [length])
            total = steps.sum()
            # greedy trim of the largest steps until we fit
            while steps.sum() > length and len(steps) > 1:
                imax = int(np.argmax(steps))
                steps = np.delete(steps, imax)
            scale = length / steps.sum()
            return steps * scale
        n_mid = int(np.ceil(remaining / dl_max)) if remaining > fp_eps * length else 0
        mid = [remaining / n_mid] * n_mid if n_mid else []
        steps = np.asarray(ramp_l + mid + ramp_r[::-1])
        if len(steps) == 0:
            steps = np.array([length])
        # uniform rescale for exact fit (ratio stays within max_scale bounds)
        return steps * (length / steps.sum())

    @staticmethod
    def insert_snapping_points(coords: np.ndarray, snapping_points: List[float]) -> np.ndarray:
        """Snap the nearest existing boundary to each snapping point."""
        coords = np.array(coords)
        for point in snapping_points:
            if coords[0] < point < coords[-1]:
                idx = int(np.argmin(np.abs(coords - point)))
                if 0 < idx < len(coords) - 1:
                    coords[idx] = point
        return coords


class UniformUnstructuredGrid(Tidy3dBaseModel):
    """Placeholder for heat-solver unstructured grid spec (schema parity)."""

    dl: pydantic.PositiveFloat = pydantic.Field(..., title="Grid size")
    min_edges_per_circumference: pydantic.PositiveFloat = 15
    min_edges_per_side: pydantic.PositiveFloat = 2
    non_refined_structures: Tuple[str, ...] = ()


class DistanceUnstructuredGrid(Tidy3dBaseModel):
    """Placeholder for distance-based unstructured grid spec (schema parity)."""

    dl_interface: pydantic.PositiveFloat = pydantic.Field(..., title="Interface grid size")
    dl_bulk: pydantic.PositiveFloat = pydantic.Field(..., title="Bulk grid size")
    distance_interface: pydantic.NonNegativeFloat = pydantic.Field(..., title="Interface distance")
    distance_bulk: pydantic.NonNegativeFloat = pydantic.Field(..., title="Bulk distance")
    sampling: pydantic.PositiveFloat = 100
    non_refined_structures: Tuple[str, ...] = ()
