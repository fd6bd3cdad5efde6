"""Modal S-matrix ComponentModeler.

Behavioral model: tidy3d v2.7.6 plugins/smatrix/component_modelers/
modal.py (ComponentModeler:28 — ports with mode specs, one sim per excited
(port, mode_index), S columns from ModeMonitor amplitudes).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import pydantic

from ....components.base import Tidy3dBaseModel, cached_property
from ....components.data.data_array import DataArray
from ....components.geometry.base import Box
from ....components.mode import ModeSpec
from ....components.monitor import ModeMonitor
from ....components.simulation import Simulation
from ....components.source import GaussianPulse, ModeSource
from ....components.types import Direction, annotate_type
from ....exceptions import SetupError
from ....log import log
from .base import AbstractComponentModeler

# fraction of the source frequency width used for the excitation pulse
FWIDTH_FRAC = 1.0 / 10


class Port(Box):
    """Port plane with a mode specification and injection direction."""

    direction: Direction = pydantic.Field(..., title="Direction")
    mode_spec: ModeSpec = pydantic.Field(default_factory=ModeSpec, title="Mode Specification")
    name: str = pydantic.Field(..., min_length=1, title="Name")


class ModalPortDataArray(DataArray):
    """S-matrix elements: (port_out, mode_index_out, port_in, mode_index_in, f)."""

    _dims = ("port_out", "mode_index_out", "port_in", "mode_index_in", "f")


class ComponentModeler(AbstractComponentModeler):
    """Computes the modal scattering matrix of a device."""

    ports: Tuple[Port, ...] = pydantic.Field((), title="Ports")

    @cached_property
    def fwidth(self) -> float:
        freqs = np.asarray(self.freqs)
        fdiff = max(abs(freqs.max() - freqs.min()), freqs.mean() * FWIDTH_FRAC)
        return float(fdiff)

    @cached_property
    def _source_time(self) -> GaussianPulse:
        freqs = np.asarray(self.freqs)
        return GaussianPulse(freq0=float(freqs.mean()), fwidth=self.fwidth)

    def _shift_value(self, port: Port) -> float:
        """Shift the source two grid cells BEHIND the port plane (against the
        injection direction) so the launched wave passes through the port
        monitor, whose measured amplitude then self-normalizes the column
        (reference: modal.py _shift_value_signed:208)."""
        normal_axis = tuple(port.size).index(0.0)
        grid = self.simulation.grid
        centers = np.asarray(grid.centers.to_list[normal_axis])
        pos = port.center[normal_axis]
        idx = int(np.argmin(np.abs(centers - pos)))
        shift = -2 if port.direction == "+" else 2
        idx_new = int(np.clip(idx + shift, 0, len(centers) - 1))
        return float(centers[idx_new] - pos)

    def to_source(self, port: Port, mode_index: int) -> ModeSource:
        normal_axis = tuple(port.size).index(0.0)
        center = list(port.center)
        center[normal_axis] += self._shift_value(port)
        return ModeSource(
            center=tuple(center), size=port.size, direction=port.direction,
            source_time=self._source_time, mode_spec=port.mode_spec,
            mode_index=mode_index, name=f"smatrix_src_{port.name}",
        )

    def to_monitor(self, port: Port) -> ModeMonitor:
        return ModeMonitor(
            center=port.center, size=port.size,
            freqs=list(np.asarray(self.freqs)), mode_spec=port.mode_spec,
            name=f"smatrix_mnt_{port.name}",
        )

    @cached_property
    def matrix_indices_monitor(self) -> List[Tuple[str, int]]:
        out = []
        for port in self.ports:
            for mode_index in range(port.mode_spec.num_modes):
                out.append((port.name, mode_index))
        return out

    @cached_property
    def matrix_indices_source(self) -> List[Tuple[str, int]]:
        if self.run_only is not None:
            return [tuple(ri) for ri in self.run_only]
        return self.matrix_indices_monitor

    def sim_dict(self) -> Dict[str, Simulation]:
        sims = {}
        monitors = [self.to_monitor(port) for port in self.ports]
        for port_name, mode_index in self.matrix_indices_source:
            port = self.get_port_by_name(port_name)
            source = self.to_source(port, mode_index)
            sim = self.simulation.copy(update=dict(
                sources=tuple(self.simulation.sources) + (source,),
                monitors=tuple(self.simulation.monitors) + tuple(monitors),
            ))
            sims[self._task_name(port_name, mode_index)] = sim
        return sims

    @staticmethod
    def _task_name(port_name: str, mode_index: int) -> str:
        return f"smatrix_{port_name}_{mode_index}"

    def get_port_by_name(self, port_name: str) -> Port:
        for port in self.ports:
            if port.name == port_name:
                return port
        raise SetupError(f"port '{port_name}' not found")

    def _construct_smatrix(self, batch_data) -> ModalPortDataArray:
        freqs = np.asarray(self.freqs)
        port_names = [p.name for p in self.ports]
        max_modes = max(p.mode_spec.num_modes for p in self.ports)
        shape = (len(port_names), max_modes, len(port_names), max_modes, len(freqs))
        values = np.zeros(shape, dtype=complex)

        for port_in_name, mode_in in self.matrix_indices_source:
            task = self._task_name(port_in_name, mode_in)
            sim_data = batch_data[task]
            col_in = port_names.index(port_in_name)
            port_in = self.get_port_by_name(port_in_name)
            # self-normalization: the launched amplitude measured at the input
            # port in the injection direction (reference: modal.py
            # _normalization_factor:276) — cancels injection imperfections and
            # backward-mode sign conventions
            in_data = sim_data[f"smatrix_mnt_{port_in_name}"]
            source_norm = in_data.amps.sel(
                direction=port_in.direction).values[:, mode_in]
            for port_out_name, mode_out in self.matrix_indices_monitor:
                port_out = self.get_port_by_name(port_out_name)
                mode_data = sim_data[f"smatrix_mnt_{port_out_name}"]
                # amplitude leaving the device through the port: opposite of
                # the port's injection direction for the same port, and the
                # port direction convention for others
                direction = "-" if port_out.direction == "+" else "+"
                amp = mode_data.amps.sel(direction=direction).values[:, mode_out]
                row_out = port_names.index(port_out_name)
                values[row_out, mode_out, col_in, mode_in, :] = amp / source_norm

        # fill elements via symmetry mappings
        for mapping in self.element_mappings:
            (row_in, col_in), (row_out, col_out), mult = mapping
            i_po = port_names.index(row_in[0])
            i_pi = port_names.index(col_in[0])
            o_po = port_names.index(row_out[0])
            o_pi = port_names.index(col_out[0])
            values[o_po, row_out[1], o_pi, col_out[1], :] = (
                mult * values[i_po, row_in[1], i_pi, col_in[1], :])

        return ModalPortDataArray(values, coords=dict(
            port_out=np.array(port_names), mode_index_out=np.arange(max_modes),
            port_in=np.array(port_names), mode_index_in=np.arange(max_modes),
            f=freqs,
        ))
