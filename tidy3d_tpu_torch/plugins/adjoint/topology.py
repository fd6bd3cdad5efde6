"""Differentiable FDTD objectives for topology optimization: the counterpart
of ``tidy3d_tpu/plugins/adjoint/topology.py``.

The gradient is exact reverse-mode differentiation through the
checkpointed time loop (``FDTDRunner.make_differentiable_run``): PyTorch
autograd through the plain out-of-place step sequence on the objective's
device, no kernel (the JAX package differentiates its XLA step, with its
Pallas tiers turned off). The production gradient route, two ordinary
``web.run`` solves on the kernels, is ``InverseDesign(method="adjoint")``.

Contract: a design ``Box`` region whose cells take permittivity
eps = eps_min + density * (eps_max - eps_min), one density value per Yee
cell of the region. The objective is a real function of the monitors' DFT
field accumulators (supplied as (re, im)-stacked real tensors).

``TopologyObjective`` takes a ``device`` (default ``"cuda"``, as every
entry point of the port), which the reference's lacks: it runs on the one
device JAX was given.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...components.geometry.base import Box
from ...components.simulation import Simulation
from ...constants import EPSILON_0
from ...exceptions import SetupError
from ...log import log
from ...solver.fdtd import AUTODIFF_TIER, FDTDRunner
from ...solver.lowering import E_COMPS, lower
from ..autograd.functions import _clip01
from ..mode.device_solver import solve_on


class DesignRegion:
    """Maps a density array onto the solver's coefficient arrays."""

    def __init__(self, simulation: Simulation, region: Box,
                 eps_min: float = 1.0, eps_max: float = 4.0):
        self.simulation = simulation
        self.region = region
        self.eps_min = eps_min
        self.eps_max = eps_max
        grid = simulation.grid
        (i0, i1), (j0, j1), (k0, k1) = grid.discretize_inds(region)
        self.slices = (slice(i0, i1), slice(j0, j1), slice(k0, k1))
        self.shape = (i1 - i0, j1 - j0, k1 - k0)
        nx, ny, nz = grid.num_cells
        # F.pad widths (last axis first) placing the region in the grid
        self._pad = (k0, nz - k1, j0, ny - j1, i0, nx - i1)

    def apply(self, consts: dict, density, dt: float) -> dict:
        """New consts with the design-region E coefficients from
        ``density`` (a tensor), out of place: a scalar (compacted) ``cb``
        is expanded to the grid by ``torch.full`` and the region written by
        ``torch.where``, so the gradient reaches the density."""
        density = _clip01(torch.as_tensor(density).to(torch.float32))
        if tuple(density.shape) != self.shape:
            raise SetupError(f"density shape {tuple(density.shape)} != "
                             f"region cells {self.shape}")
        eps = self.eps_min + density * (self.eps_max - self.eps_min)
        cb_region = torch.tensor(dt / EPSILON_0, dtype=torch.float32,
                                 device=density.device) / eps
        full_shape = tuple(self.simulation.grid.num_cells)
        inside = torch.zeros(full_shape, dtype=torch.bool,
                             device=density.device)
        inside[self.slices] = True
        cb_full = F.pad(cb_region, self._pad)
        new_consts = dict(consts)
        new_coeffs = dict(consts["coeffs_E"])
        for comp in E_COMPS:
            ca, cb = new_coeffs[comp]
            if not torch.is_tensor(cb) or cb.ndim == 0:
                cb = torch.full(full_shape, float(cb), dtype=torch.float32,
                                device=density.device)
            new_coeffs[comp] = (ca, torch.where(inside, cb_full, cb))
        new_consts["coeffs_E"] = new_coeffs
        return new_consts


class ModeAmpWeights:
    """Host-precomputed weights turning DFT accumulators into mode amps.

    amp(direction, f) = sum over comps/pixels of w * DFT_field, evaluated in
    real arithmetic on the accumulators' device.

    Caveat: this raw-Yee quadrature of the overlap carries radiation
    leakage (measured ~1% amplitude crosstalk on a launched mode) relative
    to the monitor pipeline's colocated amps — adequate as an optimization
    surrogate, but gradients of the REAL pipeline amp should use
    ``InverseDesign(method="adjoint")`` (two kernel forward solves)."""

    def __init__(self, simulation: Simulation, plan, monitor_idx: int,
                 direction: str = "+", mode_index: int = 0,
                 normalize_source: bool = True):
        from ..mode.mode_solver import ModeSolver

        mp = plan.monitors[monitor_idx]
        monitor = mp.monitor
        axis = tuple(monitor.size).index(0.0)
        b_ax, c_ax = (axis + 1) % 3, (axis + 2) % 3
        b_dim, c_dim = "xyz"[b_ax], "xyz"[c_ax]
        freqs = np.asarray(mp.freqs)

        solver = ModeSolver(simulation=simulation, plane=monitor.geometry,
                            mode_spec=monitor.mode_spec, freqs=freqs.tolist(),
                            colocate=False)
        mode_data = solver.data_raw

        self.monitor_idx = monitor_idx
        self.weights: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self._on_device: Dict[str, dict] = {}
        # overlap table (matches _mode_overlaps with conjugate=True):
        # amp = 1/4 int [ conj(Em_b) Hf_c - conj(Em_c) Hf_b
        #                + conj(Hm_c) Ef_b - conj(Hm_b) Ef_c ]
        # backward ('-') modes have tangential H negated -> flips the Ef terms.
        table = {
            f"H{'xyz'[c_ax]}": (f"E{'xyz'[b_ax]}", +1.0),
            f"H{'xyz'[b_ax]}": (f"E{'xyz'[c_ax]}", -1.0),
            f"E{'xyz'[b_ax]}": (f"H{'xyz'[c_ax]}", +1.0),
            f"E{'xyz'[c_ax]}": (f"H{'xyz'[b_ax]}", -1.0),
        }
        for comp in mp.comps:
            if comp not in table:
                continue  # normal components don't enter the overlap
            partner, s = table[comp]
            if comp[0] == "E" and direction == "-":
                s = -s
            coords = mp.coords[comp]
            arr = getattr(mode_data, partner)
            sel = arr.isel(mode_index=mode_index)
            interp = sel.interp(x=coords["x"], y=coords["y"], z=coords["z"],
                                kwargs=dict(fill_value=0.0))
            mode_vals = s * np.conj(interp.values)  # (nx, ny, nz, f)
            # integration weights over the plane
            wb = _overlap_w(coords[b_dim], monitor.bounds[0][b_ax],
                            monitor.bounds[1][b_ax])
            wc = _overlap_w(coords[c_dim], monitor.bounds[0][c_ax],
                            monitor.bounds[1][c_ax])
            w_geo = np.ones([len(coords[d]) for d in "xyz"])
            shape_b = [1, 1, 1]
            shape_b["xyz".index(b_dim)] = len(wb)
            shape_c = [1, 1, 1]
            shape_c["xyz".index(c_dim)] = len(wc)
            w_geo = w_geo * wb.reshape(shape_b) * wc.reshape(shape_c)
            total = 0.25 * mode_vals * w_geo[..., None]
            if normalize_source and simulation.sources:
                src = simulation.sources[simulation.normalize_index or 0]
                spectrum = src.source_time.spectrum(
                    simulation.tmesh, freqs, simulation.dt)
                spectrum = spectrum / src.source_time.amplitude / np.exp(
                    1j * src.source_time.phase)
                total = total / spectrum.reshape((1, 1, 1, -1))
            self.weights[comp] = (np.real(total).astype(np.float32),
                                  np.imag(total).astype(np.float32))

    def _weights_on(self, device) -> dict:
        """The weights as float32 tensors on ``device`` (made once)."""
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = {
                comp: tuple(torch.from_numpy(w).to(device) for w in pair)
                for comp, pair in self.weights.items()}
        return self._on_device[key]

    def amps(self, mon_out) -> Tuple[torch.Tensor, torch.Tensor]:
        """(re, im) mode amplitudes per frequency from the run output."""
        acc = mon_out[self.monitor_idx]
        weights = self._weights_on(next(iter(acc.values())).device)
        amp_re = 0.0
        amp_im = 0.0
        for comp, (w_re, w_im) in weights.items():
            arr = acc[comp]  # (2, nx, ny, nz, f) stacked re/im
            f_re, f_im = arr[0], arr[1]
            # (w_re + i w_im)(f_re + i f_im)
            amp_re = amp_re + torch.sum(w_re * f_re - w_im * f_im,
                                        dim=(0, 1, 2))
            amp_im = amp_im + torch.sum(w_re * f_im + w_im * f_re,
                                        dim=(0, 1, 2))
        return amp_re, amp_im


def _overlap_w(coords, lo, hi):
    coords = np.asarray(coords, dtype=float)
    if len(coords) == 1:
        return np.ones(1)
    mids = 0.5 * (coords[1:] + coords[:-1])
    edges = np.clip(np.concatenate([[lo], mids, [hi]]), lo, hi)
    return np.maximum(np.diff(edges), 0.0)


class TopologyObjective:
    """value_and_grad of an objective over a density-parametrized region,
    on ``device`` (the GPU unless the caller names another)."""

    def __init__(self, simulation: Simulation, region: Box,
                 eps_min: float = 1.0, eps_max: float = 4.0,
                 objective: Callable = None,
                 mode_monitor_name: Optional[str] = None,
                 direction: str = "+", mode_index: int = 0,
                 device="cuda"):
        """With ``mode_monitor_name`` given and no custom ``objective``, the
        objective is |mode amp|^2 summed over frequencies; a custom
        ``objective`` is a torch function of the run output. The runner
        is the ``pallas2`` tier's, whose DFT tables sample every step on
        every device; its differentiable run launches no kernel."""
        self.simulation = simulation
        self.device = torch.device(device)
        with solve_on(self.device):
            self.plan = lower(simulation)
        self.runner = FDTDRunner(self.plan, device=self.device,
                                 kernel="pallas2")
        self.region = DesignRegion(simulation, region, eps_min, eps_max)
        self.run_fn = self.runner.make_differentiable_run()
        self._consts_template = self.runner.consts
        chunk_size, num_chunks = self.runner.checkpoint_chunks
        log.info(f"kernel tier: {AUTODIFF_TIER}, {num_chunks} chunks of "
                 f"{chunk_size} steps, on {self.device}")

        if objective is None:
            if mode_monitor_name is None:
                raise SetupError("provide an objective or a mode_monitor_name")
            idx = next(i for i, mp in enumerate(self.plan.monitors)
                       if mp.monitor.name == mode_monitor_name)
            with solve_on(self.device):
                weights = ModeAmpWeights(simulation, self.plan, idx,
                                         direction=direction,
                                         mode_index=mode_index)

            def objective(mon_out):
                amp_re, amp_im = weights.amps(mon_out)
                return torch.sum(amp_re**2 + amp_im**2)

            self.mode_weights = weights
        self.objective = objective

    @property
    def density_shape(self):
        return self.region.shape

    def loss(self, density: torch.Tensor) -> torch.Tensor:
        """The objective of ``density`` (a tensor on the device)."""
        consts = self.region.apply(self._consts_template, density,
                                   self.plan.dt)
        mon_out, _ = self.run_fn(consts)
        return self.objective(mon_out)

    def _density(self, density) -> torch.Tensor:
        return torch.as_tensor(np.asarray(density, np.float32),
                               device=self.device)

    def value_and_grad(self, density) -> Tuple[float, np.ndarray]:
        """The objective and its gradient with respect to ``density``, both
        on the host (numpy)."""
        rho = self._density(density).requires_grad_(True)
        val = self.loss(rho)
        (grad,) = torch.autograd.grad(val, rho)
        return float(val.detach()), grad.cpu().numpy()

    def value(self, density) -> float:
        """The objective alone (no backward pass)."""
        with torch.no_grad():
            return float(self.loss(self._density(density)))
