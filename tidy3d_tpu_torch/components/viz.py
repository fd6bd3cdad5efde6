"""Visualization defaults and helpers.

Behavioral model: the upstream tidy3d components/viz.py (plot params,
``equal_aspect`` / ``add_ax_if_none`` decorators, ``plot_sim_3d``). The 3D
viewer here renders structure cross-sections with matplotlib (no widget
dependency).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import pydantic

from .base import Tidy3dBaseModel

# --------------------------------------------------------------------------- #
# plot parameter containers (reference: viz.py PlotParams)
# --------------------------------------------------------------------------- #


class PlotParams(Tidy3dBaseModel):
    """Matplotlib patch style parameters."""

    alpha: Any = pydantic.Field(1.0)
    edgecolor: Any = pydantic.Field(None)
    facecolor: Any = pydantic.Field(None)
    fill: bool = pydantic.Field(True)
    hatch: Optional[str] = pydantic.Field(None)
    linewidth: pydantic.NonNegativeFloat = pydantic.Field(1)

    def to_kwargs(self) -> Dict[str, Any]:
        kwargs = self.model_dump()
        kwargs.pop("type", None)
        return {k: v for k, v in kwargs.items() if v is not None}


plot_params_geometry = PlotParams(facecolor="cornflowerblue",
                                  edgecolor="black", alpha=0.8)
plot_params_structure = PlotParams(facecolor="cornflowerblue",
                                   edgecolor="black", alpha=0.8)
plot_params_pml = PlotParams(alpha=0.7, facecolor="gray", edgecolor="gray",
                             hatch="x")
plot_params_symmetry = PlotParams(alpha=0.3, facecolor="lightsteelblue",
                                  edgecolor="lightsteelblue")
plot_params_source = PlotParams(alpha=0.4, facecolor="limegreen",
                                edgecolor="limegreen", linewidth=3)
plot_params_monitor = PlotParams(alpha=0.4, facecolor="orange",
                                 edgecolor="orange", linewidth=3)
plot_params_pec = PlotParams(facecolor="gold", edgecolor="black")
plot_params_pmc = PlotParams(facecolor="lightsteelblue", edgecolor="black")
plot_params_bloch = PlotParams(facecolor="orchid", edgecolor="black")

STRUCTURE_EPS_CMAP = "gist_yarg"
STRUCTURE_HEAT_COND_CMAP = "gist_yarg"


# --------------------------------------------------------------------------- #
# decorators (reference: viz.py equal_aspect:35, add_ax_if_none:50)
# --------------------------------------------------------------------------- #


def make_ax():
    """New matplotlib axis."""
    import matplotlib.pyplot as plt

    _, ax = plt.subplots(1, 1, tight_layout=True)
    return ax


def add_ax_if_none(plot_fn):
    """Create an axis if the wrapped plot function is called without one."""

    @functools.wraps(plot_fn)
    def _plot(*args, **kwargs):
        if kwargs.get("ax") is None:
            kwargs["ax"] = make_ax()
        return plot_fn(*args, **kwargs)

    return _plot


def equal_aspect(plot_fn):
    """Enforce equal axis aspect on the returned plot."""

    @functools.wraps(plot_fn)
    def _plot(*args, **kwargs):
        ax = plot_fn(*args, **kwargs)
        if ax is not None:
            ax.set_aspect("equal")
        return ax

    return _plot


# --------------------------------------------------------------------------- #
# simple 3D viewer
# --------------------------------------------------------------------------- #


def plot_sim_3d(sim, ax=None):
    """Render the simulation's structures as 3D boxes/wireframes
    (matplotlib 3D; a lightweight stand-in for the reference's widget-based
    viewer)."""
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")

    def box_faces(rmin, rmax):
        x0, y0, z0 = rmin
        x1, y1, z1 = rmax
        pts = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]])
        faces_idx = [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4), (2, 3, 7, 6),
                     (1, 2, 6, 5), (0, 3, 7, 4)]
        return [pts[list(f)] for f in faces_idx]

    smin, smax = sim.bounds
    clip = lambda v, lo, hi: float(np.clip(v, lo, hi))
    for si, structure in enumerate(sim.structures):
        rmin, rmax = structure.geometry.bounds
        rmin = [clip(v, lo, hi) for v, lo, hi in zip(rmin, smin, smax)]
        rmax = [clip(v, lo, hi) for v, lo, hi in zip(rmax, smin, smax)]
        coll = Poly3DCollection(box_faces(rmin, rmax), alpha=0.3,
                                facecolor=f"C{si % 10}", edgecolor="k",
                                linewidth=0.3)
        ax.add_collection3d(coll)
    ax.add_collection3d(Poly3DCollection(
        box_faces(smin, smax), alpha=0.05, facecolor="gray", edgecolor="gray",
        linewidth=0.5))
    ax.set_xlim(smin[0], smax[0])
    ax.set_ylim(smin[1], smax[1])
    ax.set_zlim(smin[2] if smax[2] > smin[2] else smin[2] - 0.5,
                smax[2] if smax[2] > smin[2] else smax[2] + 0.5)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    return ax
