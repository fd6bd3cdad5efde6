"""``web.run`` on the port: lower -> time-step on the GPU -> SimulationData.

Mirrors ``tidy3d_tpu.web.run`` (``tidy3d_tpu/web/run.py:55-292``), whose
module cannot be imported without JAX; the builders of the monitor data the
port covers are ported here unchanged. Field, field-time, flux and
flux-time monitors are covered; other monitor types and checkpointing
raise ``NotImplementedError`` before the run starts. ``TIDY3D_TPU_SHARD``
asks for a sharded run as in the JAX package
(``solver/distributed.sharding_plan_from_env``): x-slabs, or one y or z
axis rotated onto x, over the visible CUDA devices (on the CPU, over
virtual shards). The
runner decides what media it takes (``solver/fdtd.py``: linear, float32, up
to 8 dispersive pole slots in a real run, none in a Bloch (complex) run) and
which kernel tier steps the run; the run log names the tier (and k on the
kstep tier).

``run`` takes this package's ``Simulation``. One of the JAX package crosses
over through its JSON: ``tidy3d_tpu_torch.Simulation.parse_raw(sim.json())``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..components.data.data_array import (
    FluxDataArray,
    FluxTimeDataArray,
    ScalarFieldDataArray,
    ScalarFieldTimeDataArray,
)
from ..components.data.monitor_data import (
    FieldData,
    FieldTimeData,
    FluxData,
    FluxTimeData,
)
from ..components.data.sim_data import SimulationData
from ..components.monitor import (
    FieldMonitor,
    FieldTimeMonitor,
    FluxMonitor,
    FluxTimeMonitor,
)
from ..components.simulation import Simulation
from ..log import log
from ..solver.distributed import sharding_plan_from_env
from ..solver.fdtd import FDTDRunner
from ..solver.lowering import lower
from ..solver.profiling import RunMetrics

_COVERED = (FieldMonitor, FieldTimeMonitor, FluxMonitor, FluxTimeMonitor)


def _check_covered(simulation: Simulation, checkpoint_path) -> None:
    for mon in simulation.monitors:
        if type(mon) not in _COVERED:
            raise NotImplementedError(
                f"monitor '{mon.name}' ({type(mon).__name__}) is not ported "
                "yet; covered: " + ", ".join(t.__name__ for t in _COVERED))
    if checkpoint_path is not None:
        raise NotImplementedError("checkpoint/resume is not ported yet")


def run(
    simulation: Simulation,
    task_name: str = "local",
    folder_name: str = "default",
    path: str = None,
    callback_url: str = None,
    verbose: bool = True,
    solver_version: str = None,
    checkpoint_path: str = None,
    checkpoint_every: int = 5,
    device="cuda",
    **kwargs,
) -> SimulationData:
    """Run a simulation on ``device`` and return its SimulationData.

    ``device`` defaults to the GPU and raises if there is none; the plain
    PyTorch path runs on the CPU only when asked for with ``device="cpu"``.
    """
    if not isinstance(simulation, Simulation):
        kind = type(simulation)
        raise TypeError(
            f"web.run takes a tidy3d_tpu_torch.Simulation, not "
            f"{kind.__module__}.{kind.__name__}; carry a simulation across "
            "with tidy3d_tpu_torch.Simulation.parse_raw(sim.json())")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("web.run: no CUDA device is available; pass "
                           "device='cpu' to run the plain PyTorch path")
    _check_covered(simulation, checkpoint_path)
    simulation.validate_pre_upload()
    plan = lower(simulation)
    if verbose:
        nx, ny, nz = plan.shape
        log.info(f"[{task_name}] lowered: grid {nx}x{ny}x{nz}, "
                 f"{plan.num_steps} steps, {len(plan.sources)} source terms.")
    sharding_plan = sharding_plan_from_env(plan.shape, device)
    if sharding_plan is not None and verbose:
        log.info(f"[{task_name}] sharded: decomposition "
                 f"{sharding_plan.decomp} over "
                 f"{len(set(sharding_plan.devices))} device(s), "
                 f"{int(np.prod(sharding_plan.decomp))} shards")
    runner = FDTDRunner(plan, device=device, sharding_plan=sharding_plan)
    if verbose:
        log.info(f"[{task_name}] kernel tier: {runner.tier_name}")
    raw = runner.run(verbose=verbose)
    if verbose:
        rate = np.prod(plan.shape) * runner.steps_run \
            / max(runner.wall_time, 1e-9)
        log.info(f"[{task_name}] solved {runner.steps_run} steps in "
                 f"{runner.wall_time:.2f}s ({rate / 1e9:.2f} "
                 "Gcell*steps/s).")
    sim_data = assemble_sim_data(simulation, plan, raw, runner, task_name)
    if path is not None:
        sim_data.to_file(path)
    return sim_data


def assemble_sim_data(simulation, plan, raw, runner,
                      task_name="local") -> SimulationData:
    """Build SimulationData from raw monitor accumulators."""
    metrics = RunMetrics.from_runner(runner)
    log_lines = [
        f"task: {task_name}",
        f"steps run: {runner.steps_run} / {plan.num_steps}",
    ] + metrics.log_lines() + [f"kernel tier: {runner.tier_name}"]

    # group plans by source monitor (flux monitors have per-surface plans)
    surface_groups: Dict[str, List[int]] = {}
    for idx, mp in enumerate(plan.monitors):
        parent = (mp.mode_info or {}).get("parent")
        if parent is not None:
            surface_groups.setdefault(parent, []).append(idx)

    data_list = []
    for idx, mp in enumerate(plan.monitors):
        if (mp.mode_info or {}).get("parent") is not None:
            continue  # handled with its parent group below
        monitor = mp.monitor
        if isinstance(monitor, FieldMonitor):
            data_list.append(_make_field_data(simulation, mp, raw[idx]))
        elif isinstance(monitor, FieldTimeMonitor):
            data_list.append(_make_field_time_data(simulation, plan, mp,
                                                   raw[idx]))
        else:
            raise NotImplementedError(
                f"monitor type {type(monitor).__name__} is not ported yet")

    for mon in simulation.monitors:
        if isinstance(mon, FluxMonitor) and mon.name in surface_groups:
            data_list.append(_make_flux_data(plan, raw,
                                             surface_groups[mon.name], mon))
        elif isinstance(mon, FluxTimeMonitor) and mon.name in surface_groups:
            data_list.append(_make_flux_time_data(
                plan, raw, surface_groups[mon.name], mon))

    sim_data = SimulationData(
        simulation=simulation, data=tuple(data_list),
        log="\n".join(log_lines), diverged=False,
    )
    # normalize frequency-domain data by the source spectrum
    if simulation.normalize_index is not None and simulation.sources:
        spectrum_fn = sim_data.source_spectrum(simulation.normalize_index)
        data_norm = tuple(md.normalize(spectrum_fn) for md in sim_data.data)
        sim_data = sim_data.copy(update=dict(data=data_norm))
    return sim_data


# --------------------------------------------------------------------------- #
# builders
# --------------------------------------------------------------------------- #


def _field_arrays_freq(mp, raw_mon) -> Dict[str, ScalarFieldDataArray]:
    arrays = {}
    freqs = np.asarray(mp.freqs)
    for comp in mp.comps:
        acc = raw_mon.get(comp)
        if acc is None:
            continue
        coords = dict(mp.coords[comp])
        coords["f"] = freqs
        arrays[comp] = ScalarFieldDataArray(acc, coords=coords)
    return arrays


def _make_field_data(simulation, mp, raw_mon) -> FieldData:
    arrays = _field_arrays_freq(mp, raw_mon)
    monitor = mp.monitor
    if monitor.colocate:
        arrays = _colocate_to_boundaries(simulation, monitor, arrays)
    return FieldData(monitor=monitor, symmetry=simulation.symmetry, **arrays)


def _colocate_to_boundaries(simulation, monitor, arrays):
    """Interpolate Yee-positioned fields onto primal-grid boundary points
    within the monitor region (reference colocate semantics)."""
    sub_grid = simulation.discretize_monitor(monitor)
    bounds = sub_grid.boundaries
    out = {}
    for comp, arr in arrays.items():
        coords = {}
        for dim in "xyz":
            axis = "xyz".index(dim)
            if monitor.size[axis] == 0.0:
                continue  # keep the single plane position
            target = np.asarray(getattr(bounds, dim))[:-1]
            if len(target) >= 1:
                coords[dim] = target
        out[comp] = arr.interp(coords=coords, kwargs=dict(fill_value=None)) \
            if coords else arr
        out[comp] = ScalarFieldDataArray(out[comp].values,
                                         coords=out[comp].coords) \
            if set(out[comp].dims) == {"x", "y", "z", "f"} else out[comp]
    return out


def _time_arrays(plan, mp, raw_mon):
    t_coords = plan.tmesh[mp.t_start:mp.t_stop:mp.t_interval] + plan.dt
    arrays = {}
    for comp in mp.comps:
        acc = raw_mon.get(comp)
        if acc is None:
            continue
        # acc shape (n_samples, nx, ny, nz) -> (nx, ny, nz, t)
        vals = np.moveaxis(acc, 0, -1)[..., :len(t_coords)]
        coords = dict(mp.coords[comp])
        coords["t"] = t_coords[:vals.shape[-1]]
        arrays[comp] = ScalarFieldTimeDataArray(np.real(vals), coords=coords)
    return arrays, t_coords


def _make_field_time_data(simulation, plan, mp, raw_mon) -> FieldTimeData:
    arrays, _ = _time_arrays(plan, mp, raw_mon)
    return FieldTimeData(monitor=mp.monitor, symmetry=simulation.symmetry,
                         **arrays)


def _surface_flux(plan, raw, idx, normal_dir: str):
    """Flux through one recorded surface plan (positive along +axis)."""
    mp = plan.monitors[idx]
    data = FieldData(
        monitor=FieldMonitor(
            center=mp.monitor.center, size=mp.monitor.size,
            freqs=mp.freqs.tolist(), name=mp.monitor.name, colocate=False,
        ),
        **_field_arrays_freq(mp, raw[idx]),
    )
    sign = 1.0 if normal_dir == "+" else -1.0
    return sign * np.asarray(data.flux_value().values), np.asarray(mp.freqs)


def _make_flux_data(plan, raw, idxs, monitor) -> FluxData:
    total = None
    freqs = None
    for idx in idxs:
        normal_dir = plan.monitors[idx].mode_info.get("normal_dir") or "+"
        vals, freqs = _surface_flux(plan, raw, idx, normal_dir)
        total = vals if total is None else total + vals
    return FluxData(monitor=monitor,
                    flux=FluxDataArray(total, coords=dict(f=freqs)))


def _make_flux_time_data(plan, raw, idxs, monitor) -> FluxTimeData:
    total = None
    t_coords = None
    for idx in idxs:
        mp = plan.monitors[idx]
        sign = 1.0 if (mp.mode_info.get("normal_dir") or "+") == "+" \
            else -1.0
        arrays, t_coords = _time_arrays(plan, mp, raw[idx])
        ft = FieldTimeData(
            monitor=FieldTimeMonitor(
                center=mp.monitor.center, size=mp.monitor.size,
                name=mp.monitor.name, colocate=False,
            ), **arrays)
        vals = sign * np.asarray(ft.flux_value().values)
        total = vals if total is None else total + vals
    return FluxTimeData(monitor=monitor,
                        flux=FluxTimeDataArray(total, coords=dict(t=t_coords)))
