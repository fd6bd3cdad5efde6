"""Terminal (lumped-port) component modeler for RF circuits.

Behavioral model: tidy3d v2.7.6 plugins/smatrix/component_modelers/
terminal.py (TerminalComponentModeler:26 — lumped ports excited by current
sources; Z-matrix from V/I path integrals via the microwave plugin).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import pydantic

from ....components.base import cached_property
from ....components.data.data_array import DataArray
from ....components.geometry.base import Box
from ....components.monitor import FieldMonitor
from ....components.simulation import Simulation
from ....components.source import GaussianPulse, UniformCurrentSource
from ....components.types import Axis
from ....exceptions import SetupError
from .base import AbstractComponentModeler

FWIDTH_FRAC = 1.0 / 10


class LumpedPort(Box):
    """Rectangular lumped port with a voltage drop along ``voltage_axis``."""

    voltage_axis: Axis = pydantic.Field(..., title="Voltage axis")
    impedance: complex = pydantic.Field(50.0 + 0j, title="Reference impedance")
    num_grid_cells: Optional[pydantic.PositiveInt] = pydantic.Field(3)
    name: str = pydantic.Field(..., min_length=1, title="Name")

    @cached_property
    def injection_axis(self) -> Axis:
        return tuple(self.size).index(0.0)


class TerminalPortDataArray(DataArray):
    _dims = ("port_out", "port_in", "f")


class TerminalComponentModeler(AbstractComponentModeler):
    """Scattering matrix of lumped ports (RF) via V/I path integrals."""

    ports: Tuple[LumpedPort, ...] = pydantic.Field((), title="Ports")

    @cached_property
    def _source_time(self) -> GaussianPulse:
        freqs = np.asarray(self.freqs)
        fwidth = max(abs(freqs.max() - freqs.min()), freqs.mean() * FWIDTH_FRAC)
        return GaussianPulse(freq0=float(freqs.mean()), fwidth=float(fwidth))

    def to_source(self, port: LumpedPort) -> UniformCurrentSource:
        return UniformCurrentSource(
            center=port.center, size=port.size, source_time=self._source_time,
            polarization=f"E{'xyz'[port.voltage_axis]}",
            name=f"terminal_src_{port.name}",
        )

    def to_monitor(self, port: LumpedPort) -> FieldMonitor:
        return FieldMonitor(
            center=port.center, size=port.size,
            freqs=list(np.asarray(self.freqs)), name=f"terminal_mnt_{port.name}",
            colocate=False,
        )

    def sim_dict(self) -> Dict[str, Simulation]:
        sims = {}
        monitors = [self.to_monitor(p) for p in self.ports]
        for port in self.ports:
            source = self.to_source(port)
            sims[f"terminal_{port.name}"] = self.simulation.copy(update=dict(
                sources=tuple(self.simulation.sources) + (source,),
                monitors=tuple(self.simulation.monitors) + tuple(monitors),
            ))
        return sims

    def _construct_smatrix(self, batch_data) -> TerminalPortDataArray:
        from ...microwave.path_integrals import (
            AxisAlignedPathIntegral,
            VoltageIntegralAxisAligned,
        )

        freqs = np.asarray(self.freqs)
        names = [p.name for p in self.ports]
        nports = len(names)
        z_matrix = np.zeros((nports, nports, len(freqs)), dtype=complex)

        for col, port_in in enumerate(self.ports):
            sim_data = batch_data[f"terminal_{port_in.name}"]
            for row, port_out in enumerate(self.ports):
                field_data = sim_data[f"terminal_mnt_{port_out.name}"]
                v_int = VoltageIntegralAxisAligned(
                    center=port_out.center,
                    size=_axis_size(port_out, port_out.voltage_axis),
                    extrapolate_to_endpoints=False, snap_path_to_grid=True,
                    sign="+",
                )
                voltage = v_int.compute_voltage(field_data)
                z_matrix[row, col, :] = np.asarray(voltage.values)

        # normalize to S-parameters with the port reference impedances
        z0 = np.array([p.impedance for p in self.ports], dtype=complex)
        s = np.zeros_like(z_matrix)
        for fi in range(len(freqs)):
            z = z_matrix[:, :, fi]
            d = np.diag(np.sqrt(1.0 / np.real(z0)))
            zref = np.diag(z0)
            s[:, :, fi] = d @ np.linalg.solve(z + zref, z - zref) @ np.linalg.inv(d)

        return TerminalPortDataArray(s, coords=dict(
            port_out=np.array(names), port_in=np.array(names), f=freqs))


def _axis_size(port: LumpedPort, axis: Axis):
    size = [0.0, 0.0, 0.0]
    size[axis] = port.size[axis]
    return tuple(size)
