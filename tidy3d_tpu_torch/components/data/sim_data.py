"""SimulationData: the container of all monitor results for one run.

Behavioral model: /root/reference/tidy3d/components/data/sim_data.py
(SimulationData:826): dict-like access returning symmetry-expanded,
source-normalized data; ``source_spectrum`` normalization (:931),
``renormalize`` (:955), field colocation helpers, Poynting/intensity, field
plotting, and the adjoint hooks (``make_adjoint_sim``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import pydantic

from ...exceptions import DataError, Tidy3dKeyError
from ...log import log
from ..base import Tidy3dBaseModel, cached_property
from ..monitor import Monitor
from ..simulation import Simulation
from ..types import Ax, FieldVal, annotate_type
from .monitor_data import (
    AbstractFieldData,
    FieldData,
    FieldTimeData,
    MonitorData,
    MonitorDataType,
)


class AbstractSimulationData(Tidy3dBaseModel):
    """Base: simulation + data + log."""

    simulation: Simulation = pydantic.Field(..., title="Simulation")
    data: Tuple[annotate_type(MonitorDataType), ...] = pydantic.Field(..., title="Monitor Data")
    log: Optional[str] = pydantic.Field(None, title="Solver Log")

    @cached_property
    def monitor_data(self) -> Dict[str, MonitorData]:
        return {md.monitor.name: md for md in self.data}

    def __getitem__(self, monitor_name: str) -> MonitorData:
        if monitor_name not in self.monitor_data:
            raise Tidy3dKeyError(
                f"monitor '{monitor_name}' not found in data "
                f"(available: {list(self.monitor_data)})")
        return self.monitor_data[monitor_name].symmetry_expanded_copy

    def __contains__(self, monitor_name: str) -> bool:
        return monitor_name in self.monitor_data


class SimulationData(AbstractSimulationData):
    """Results of a Simulation run; maps monitor names to data."""

    diverged: bool = pydantic.Field(False, title="Diverged")

    @property
    def final_decay_value(self) -> float:
        """Final field decay value parsed from the log."""
        if self.log is None:
            return 1.0
        for line in reversed(self.log.split("\n")):
            if "field decay:" in line:
                try:
                    return float(line.split("field decay: ")[-1])
                except ValueError:
                    return 1.0
        return 1.0

    def source_spectrum(self, source_index: Optional[int]) -> Callable:
        """Normalization function for a given source index."""
        if source_index is None or len(self.simulation.sources) == 0:
            return np.ones_like

        source = self.simulation.sources[source_index]
        source_time = source.source_time
        times = self.simulation.tmesh
        dt = self.simulation.dt

        complex_fields = self.simulation.complex_fields

        def source_spectrum_fn(freqs):
            spectrum = source_time.spectrum(times, np.asarray(freqs), dt,
                                            complex_fields=complex_fields)
            # only normalize out the pulse shape, not user amplitude/phase
            return spectrum / source_time.amplitude / np.exp(1j * source_time.phase)

        return source_spectrum_fn

    def make_adjoint_sim(self, fwidth: float = None) -> "Simulation":
        """Build the adjoint simulation: this data's monitor values are
        interpreted as objective VJPs and synthesized into adjoint sources
        replacing the forward sources (reference: sim_data.py
        make_adjoint_sim:1023). The native gradient path
        (solver.fdtd.make_differentiable_run) does not need this; it exists
        for reference-API parity and for manual adjoint workflows."""
        if fwidth is None and self.simulation.sources:
            fwidth = float(self.simulation.sources[0].source_time.fwidth)
        elif fwidth is None:
            fwidth = 1e13
        adjoint_sources = []
        for md in self.data:
            maker = getattr(md, "make_adjoint_sources", None)
            if maker is None:
                continue
            names = ["amps"] + [c for c in ("Ex", "Ey", "Ez", "Hx", "Hy",
                                            "Hz")]
            try:
                try:
                    adjoint_sources += maker(names, fwidth,
                                             grid=self.simulation.grid,
                                             simulation=self.simulation)
                except TypeError:
                    try:
                        adjoint_sources += maker(names, fwidth,
                                                 grid=self.simulation.grid)
                    except TypeError:
                        adjoint_sources += maker(names, fwidth)
            except NotImplementedError:
                continue
        return self.simulation.copy(update=dict(
            sources=tuple(adjoint_sources), monitors=()))

    def renormalize(self, normalize_index: int) -> "SimulationData":
        """Return a copy normalized by a different source."""
        num_sources = len(self.simulation.sources)
        if normalize_index == self.simulation.normalize_index or num_sources == 0:
            return self.copy()
        if normalize_index and (normalize_index < 0 or normalize_index >= num_sources):
            raise DataError(f"normalize_index {normalize_index} out of bounds "
                            f"for {num_sources} sources")

        def spectrum_fn(freqs):
            new_fn = self.source_spectrum(normalize_index)
            old_fn = self.source_spectrum(self.simulation.normalize_index)
            return new_fn(freqs) / old_fn(freqs)

        data_normalized = [md.normalize(spectrum_fn) for md in self.data]
        simulation = self.simulation.copy(update=dict(normalize_index=normalize_index))
        return self.copy(update=dict(simulation=simulation, data=tuple(data_normalized)))

    # ------------------------------------------------------------------ #
    # field access helpers
    # ------------------------------------------------------------------ #

    def load_field_monitor(self, monitor_name: str) -> AbstractFieldData:
        mon_data = self[monitor_name]
        if not isinstance(mon_data, AbstractFieldData):
            raise DataError(f"data for monitor '{monitor_name}' does not contain "
                            "field data")
        return mon_data

    def at_centers(self, field_monitor_name: str) -> Dict[str, Any]:
        """Colocate the fields of a monitor to the grid cell centers."""
        mon_data = self.load_field_monitor(field_monitor_name)
        monitor = mon_data.monitor
        sub_grid = self.simulation.discretize_monitor(monitor)
        centers = sub_grid.centers
        return mon_data.colocate(x=np.asarray(centers.x), y=np.asarray(centers.y),
                                 z=np.asarray(centers.z))

    def at_boundaries(self, field_monitor_name: str) -> Dict[str, Any]:
        mon_data = self.load_field_monitor(field_monitor_name)
        monitor = mon_data.monitor
        sub_grid = self.simulation.discretize_monitor(monitor)
        bounds = sub_grid.boundaries
        return mon_data.colocate(x=np.asarray(bounds.x), y=np.asarray(bounds.y),
                                 z=np.asarray(bounds.z))

    def get_intensity(self, field_monitor_name: str):
        """|E|^2 of a field monitor, colocated."""
        return self.load_field_monitor(field_monitor_name).intensity

    def get_poynting_vector(self, field_monitor_name: str):
        return self.load_field_monitor(field_monitor_name).poynting

    # ------------------------------------------------------------------ #
    # plotting
    # ------------------------------------------------------------------ #

    def plot_field(self, field_monitor_name: str, field_name: str,
                   val: FieldVal = "real", scale: str = "lin",
                   eps_alpha: float = 0.2, robust: bool = True,
                   vmin: float = None, vmax: float = None, ax: Ax = None,
                   **sel_kwargs) -> Ax:
        """Plot a 2D cross section of a field component."""
        import matplotlib.pyplot as plt

        mon_data = self.load_field_monitor(field_monitor_name)
        if field_name == "int":
            arr = mon_data.intensity
        else:
            arr = mon_data.field_components.get(field_name)
        if arr is None:
            raise DataError(f"field {field_name} not in monitor data")
        # select extra dims
        for key, value in sel_kwargs.items():
            if key in arr.dims:
                arr = arr.sel(**{key: value}, method="nearest") \
                    if isinstance(value, (int, float)) else arr.sel(**{key: value})
        arr = arr.squeeze()
        val_map = {"real": np.real, "imag": np.imag, "abs": np.abs,
                   "abs^2": lambda x: np.abs(x) ** 2, "phase": np.angle}
        vals = val_map[val](arr.values)
        spatial_dims = [d for d in ("x", "y", "z") if d in arr.dims
                        and len(arr.coords[d]) > 1]
        if len(spatial_dims) != 2:
            raise DataError("plot_field requires exactly 2 non-trivial spatial dims; "
                            f"got {spatial_dims}; pass sel_kwargs to reduce.")
        if ax is None:
            _, ax = plt.subplots()
        d1, d2 = spatial_dims
        cmap = "magma" if val in ("abs", "abs^2") else "RdBu"
        mesh_vals = vals if arr.dims.index(d1) < arr.dims.index(d2) else vals.T
        ax.pcolormesh(arr.coords[d1], arr.coords[d2], mesh_vals.T, shading="nearest",
                      cmap=cmap, vmin=vmin, vmax=vmax)
        ax.set_xlabel(d1)
        ax.set_ylabel(d2)
        ax.set_aspect("equal")
        return ax

    # ------------------------------------------------------------------ #
    # export
    # ------------------------------------------------------------------ #

    def to_mat_file(self, fname: str):
        from scipy.io import savemat

        out = {}
        for name, md in self.monitor_data.items():
            if hasattr(md, "field_components"):
                for comp, arr in md.field_components.items():
                    out[f"{name}_{comp}"] = arr.values
        savemat(fname, out)
