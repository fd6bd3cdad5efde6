"""EME result containers.

Behavioral model: tidy3d v2.7.6 components/eme/data/
(EMESimulationData sim_data.py:41 with ``port_modes`` :81,
``smatrix_in_basis`` :134, ``field_in_basis`` :324; monitor data types
monitor_data.py:15-33). Numpy-native DataArrays instead of xarray.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import pydantic

from ...exceptions import DataError, SetupError
from ..base import Tidy3dBaseModel, cached_property
from ..data.data_array import (
    EMECoefficientDataArray,
    EMEModeIndexDataArray,
    EMEScalarFieldDataArray,
    EMEScalarModeFieldDataArray,
    EMESMatrixDataArray,
)
from .monitor import EMECoefficientMonitor, EMEFieldMonitor, EMEModeSolverMonitor
from .simulation import EMESimulation

FIELD_COMPS = ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")


class EMESMatrixDataset(Tidy3dBaseModel):
    """Port-to-port S matrices in the mode bases of the two end cells."""

    S11: EMESMatrixDataArray = pydantic.Field(...)
    S12: EMESMatrixDataArray = pydantic.Field(...)
    S21: EMESMatrixDataArray = pydantic.Field(...)
    S22: EMESMatrixDataArray = pydantic.Field(...)


class EMEFieldData(Tidy3dBaseModel):
    """Propagated fields of an EMEFieldMonitor, reconstructed from the
    mode expansion: dims (x, y, z, f, sweep_index, eme_port_index,
    mode_index) with mode_index = the input port-mode (reference
    eme/data/monitor_data.py:25)."""

    monitor: EMEFieldMonitor = pydantic.Field(...)
    Ex: EMEScalarFieldDataArray = pydantic.Field(...)
    Ey: EMEScalarFieldDataArray = pydantic.Field(...)
    Ez: EMEScalarFieldDataArray = pydantic.Field(...)
    Hx: EMEScalarFieldDataArray = pydantic.Field(...)
    Hy: EMEScalarFieldDataArray = pydantic.Field(...)
    Hz: EMEScalarFieldDataArray = pydantic.Field(...)

    @property
    def field_components(self) -> Dict[str, EMEScalarFieldDataArray]:
        return {c: getattr(self, c) for c in FIELD_COMPS}


class EMEModeSolverData(Tidy3dBaseModel):
    """The EME expansion modes within the monitor geometry, per cell:
    dims (x, y, z, f, sweep_index, eme_cell_index, mode_index) with the
    normal coordinate at the recorded cell centers (reference
    eme/data/monitor_data.py:15)."""

    monitor: EMEModeSolverMonitor = pydantic.Field(...)
    Ex: EMEScalarModeFieldDataArray = pydantic.Field(...)
    Ey: EMEScalarModeFieldDataArray = pydantic.Field(...)
    Ez: EMEScalarModeFieldDataArray = pydantic.Field(...)
    Hx: EMEScalarModeFieldDataArray = pydantic.Field(...)
    Hy: EMEScalarModeFieldDataArray = pydantic.Field(...)
    Hz: EMEScalarModeFieldDataArray = pydantic.Field(...)
    n_complex: EMEModeIndexDataArray = pydantic.Field(...)

    @property
    def field_components(self) -> Dict[str, EMEScalarModeFieldDataArray]:
        return {c: getattr(self, c) for c in FIELD_COMPS}


class EMECoefficientData(Tidy3dBaseModel):
    """Forward (A) / backward (B) mode coefficients in each recorded
    cell: dims (f, sweep_index, eme_cell_index, mode_index_out,
    mode_index_in) — out = basis mode of the cell, in = exciting
    port-1 mode (reference eme/data/monitor_data.py:33)."""

    monitor: EMECoefficientMonitor = pydantic.Field(...)
    A: EMECoefficientDataArray = pydantic.Field(...)
    B: EMECoefficientDataArray = pydantic.Field(...)


EMEMonitorDataType = Union[EMEModeSolverData, EMEFieldData,
                           EMECoefficientData]


class EMESimulationData(Tidy3dBaseModel):
    """Results of an EME simulation."""

    simulation: EMESimulation = pydantic.Field(...)
    smatrix: EMESMatrixDataset = pydantic.Field(...)
    n_complex: Optional[EMEModeIndexDataArray] = pydantic.Field(None)
    data: Tuple[Any, ...] = pydantic.Field(
        (), title="Monitor data",
        description="EME monitor data, one entry per simulation monitor.")
    port_modes: Optional[Tuple[Any, Any]] = pydantic.Field(
        None, title="Port modes",
        description="ModeSolverData of the first / last EME cell — the "
        "bases the port S-matrix indices refer to (reference "
        "eme/data/sim_data.py:81).")

    def __getitem__(self, name: str):
        for md in self.data:
            if md.monitor.name == name:
                return md
        raise DataError(f"No monitor data named '{name}'.")

    @cached_property
    def port_modes_tuple(self):
        """(port_modes_1, port_modes_2) ModeSolverData pair."""
        if self.port_modes is None:
            raise SetupError("'port_modes' were not stored for this run.")
        return self.port_modes

    # ------------------------------------------------------------------ #
    # basis changes (reference eme/data/sim_data.py:134, :324)
    # ------------------------------------------------------------------ #

    def _port_overlaps(self, modes, port_modes) -> np.ndarray:
        """Unconjugated outer overlaps O[new_mode, port_mode] per freq:
        O = 1/4 int (E^n x H^m + E^m x H^n) . n dA, shape
        (nf, n_new, n_port) (reference outer_dot, monitor_data.py:724)."""
        axis = self.simulation.axis
        b_dim, c_dim = "xyz"[(axis + 1) % 3], "xyz"[(axis + 2) % 3]
        n_dim = "xyz"[axis]
        fc2 = port_modes.field_components
        ref = fc2[f"E{b_dim}"]
        target = {b_dim: np.asarray(ref.coords[b_dim]),
                  c_dim: np.asarray(ref.coords[c_dim])}

        def get(fc, name):
            arr = fc[name].interp(coords=target, kwargs=dict(fill_value=0.0))
            if n_dim in arr.dims:
                arr = arr.isel(**{n_dim: 0})
            want = [d for d in (b_dim, c_dim, "f", "mode_index")
                    if d in arr.dims]
            if tuple(arr.dims) != tuple(want):
                arr = arr.transpose(*want)
            vals = np.asarray(arr.values)
            if "mode_index" not in arr.dims:
                vals = vals[..., None]
            return vals  # (nb, nc, nf, nm)

        fc1 = modes.field_components
        e1b, e1c = get(fc1, f"E{b_dim}"), get(fc1, f"E{c_dim}")
        h1b, h1c = get(fc1, f"H{b_dim}"), get(fc1, f"H{c_dim}")
        e2b, e2c = get(fc2, f"E{b_dim}"), get(fc2, f"E{c_dim}")
        h2b, h2c = get(fc2, f"H{b_dim}"), get(fc2, f"H{c_dim}")
        wb = np.gradient(target[b_dim]) if len(target[b_dim]) > 1 \
            else np.ones(1)
        wc = np.gradient(target[c_dim]) if len(target[c_dim]) > 1 \
            else np.ones(1)
        w2 = wb[:, None, None, None] * wc[None, :, None, None]
        t1 = np.einsum("bcfn,bcfm->fnm", e1b * w2, h2c) \
            - np.einsum("bcfn,bcfm->fnm", e1c * w2, h2b)
        t2 = np.einsum("bcfm,bcfn->fnm", e2b * w2, h1c) \
            - np.einsum("bcfm,bcfn->fnm", e2c * w2, h1b)
        return 0.25 * (t1 + t2)

    def smatrix_in_basis(self, modes1=None, modes2=None) -> EMESMatrixDataset:
        """S-matrix re-expressed in user-provided mode bases via
        unconjugated overlaps with the port modes; identity (the stored
        S-matrix) when no bases are given."""
        if modes1 is None and modes2 is None:
            return self.smatrix
        if self.port_modes is None:
            raise SetupError(
                "Cannot change S-matrix basis: 'port_modes' missing.")
        pm1, pm2 = self.port_modes
        s11 = np.asarray(self.smatrix.S11.values)
        s12 = np.asarray(self.smatrix.S12.values)
        s21 = np.asarray(self.smatrix.S21.values)
        s22 = np.asarray(self.smatrix.S22.values)
        nf, ns = s11.shape[:2]
        o1 = self._port_overlaps(modes1, pm1) if modes1 is not None else None
        o2 = self._port_overlaps(modes2, pm2) if modes2 is not None else None
        n1 = o1.shape[1] if o1 is not None else s11.shape[2]
        n2 = o2.shape[1] if o2 is not None else s22.shape[2]
        out11 = np.zeros((nf, ns, n1, n1), dtype=complex)
        out12 = np.zeros((nf, ns, n1, n2), dtype=complex)
        out21 = np.zeros((nf, ns, n2, n1), dtype=complex)
        out22 = np.zeros((nf, ns, n2, n2), dtype=complex)
        for fi in range(nf):
            a1 = o1[fi] if o1 is not None else np.eye(s11.shape[2])
            a2 = o2[fi] if o2 is not None else np.eye(s22.shape[2])
            for si in range(ns):
                out11[fi, si] = a1 @ s11[fi, si] @ a1.T
                out12[fi, si] = a1 @ s12[fi, si] @ a2.T
                out21[fi, si] = a2 @ s21[fi, si] @ a1.T
                out22[fi, si] = a2 @ s22[fi, si] @ a2.T
        f = np.asarray(self.smatrix.S11.coords["f"])
        sw = np.asarray(self.smatrix.S11.coords["sweep_index"])

        def mk(arr, n_out, n_in):
            return EMESMatrixDataArray(arr, coords=dict(
                f=f, sweep_index=sw, mode_index_out=np.arange(n_out),
                mode_index_in=np.arange(n_in)))

        return EMESMatrixDataset(S11=mk(out11, n1, n1), S12=mk(out12, n1, n2),
                                 S21=mk(out21, n2, n1), S22=mk(out22, n2, n2))

    def field_in_basis(self, field: EMEFieldData, modes=None,
                       port_index: int = 0) -> EMEFieldData:
        """Express an EMEFieldMonitor field in the provided modal basis:
        new_field[..., n] = sum_m O[n, m] field[..., port_index, m]
        (reference eme/data/sim_data.py:324)."""
        if self.port_modes is None:
            raise SetupError(
                "Cannot change field basis: 'port_modes' missing.")
        pm = self.port_modes[port_index]
        if modes is None:
            modes = pm
        o = self._port_overlaps(modes, pm)  # (nf, n_new, n_port)
        update = {}
        n_new = o.shape[1]
        for name, comp in field.field_components.items():
            vals = np.asarray(comp.values)
            # dims (x, y, z, f, sweep_index, eme_port_index, mode_index)
            sub = vals[..., port_index, :]
            out = np.einsum("...fsm,fnm->...fsn", sub, o)
            out = out[..., None, :]  # restore eme_port_index (len 1)
            coords = dict(comp.coords)
            coords["eme_port_index"] = np.array([port_index])
            coords["mode_index"] = np.arange(n_new)
            update[name] = EMEScalarFieldDataArray(out, coords=coords)
        return field.copy(update=update)
