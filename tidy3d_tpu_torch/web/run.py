"""``web.run`` on the port: lower -> time-step on the GPU -> SimulationData.

Mirrors ``tidy3d_tpu.web.run`` (``tidy3d_tpu/web/run.py:55-524``), whose
module cannot be imported without JAX; the builders of the monitor data are
ported here unchanged (host numpy, after the timed loop): field, field-time,
permittivity, mode and mode-solver, diffraction, flux, flux-time and the
three field-projection monitors (``components/field_projection.py``).
Before anything is launched the runner's memory gate refuses a plan that
does not fit the device (``FDTDRunner.check_memory_budget``: a
``SetupError``); ``TIDY3D_TPU_PROFILE=<dir>`` writes a ``torch.profiler``
trace of the run (``solver/profiling.maybe_profile``); ``checkpoint_path``
saves the state every ``checkpoint_every`` chunks and resumes from the file
when it exists (``FDTDRunner.run_checkpointed``). ``TIDY3D_TPU_SHARD`` asks
for a sharded run as in the JAX package
(``solver/distributed.sharding_plan_from_env``) over the visible CUDA
devices (on the CPU, over virtual shards): x-slabs of the k-step kernel
(one y or z axis rotated onto x) where that route takes the plan, bricks
of the ``pallas2`` tier otherwise (``kernel tier: pallas2 (2x2x1
bricks)``). With a coordinator configured (``TIDY3D_TPU_COORDINATOR``,
``solver/distributed.py``) the process joins the process group before
lowering; process 0 lowers and builds the ``SimulationData`` and every
process returns them, and only process 0 writes ``path``. The runner
decides what media it takes
(``solver/fdtd.py``: linear, up to 8 dispersive pole slots in a real run,
none in a Bloch (complex) run), which kernel tier steps the run and at
which storage types (``TIDY3D_TPU_PRECISION``, and on the kstep tier
``TIDY3D_TPU_PSI_DTYPE`` and ``TIDY3D_TPU_Q_DTYPE``). The log adds to the
reference's the peak and the estimate of device memory, the host seconds
of each monitor's data, the source terms per family (``source terms: E
4, H 4``: the count the tiers' source-table caps read) and the kernel tier
(with k on the kstep tier) and its storage types: ``kernel tier: kstep
(k=2) [storage: fields bfloat16, psi bfloat16, Q bfloat16]``.

``run`` takes this package's ``Simulation``. One of the JAX package crosses
over through its JSON: ``tidy3d_tpu_torch.Simulation.parse_raw(sim.json())``.
"""

from __future__ import annotations

import time as _time
from typing import Dict, List

import numpy as np
import torch

from ..components.data.data_array import (
    DiffractionDataArray,
    FluxDataArray,
    FluxTimeDataArray,
    ModeAmpsDataArray,
    ScalarFieldDataArray,
    ScalarFieldTimeDataArray,
)
from ..components.data.dataset import ModeSolverDataset
from ..components.data.monitor_data import (
    DiffractionData,
    FieldData,
    FieldTimeData,
    FluxData,
    FluxTimeData,
    ModeData,
    ModeSolverData,
    PermittivityData,
    _colocated_tangential_fields,
    _mode_overlaps,
)
from ..components.data.sim_data import SimulationData
from ..components.field_projection import FieldProjector
from ..components.monitor import (
    AbstractFieldProjectionMonitor,
    DiffractionMonitor,
    FieldMonitor,
    FieldTimeMonitor,
    FluxMonitor,
    FluxTimeMonitor,
    ModeMonitor,
    ModeSolverMonitor,
    PermittivityMonitor,
)
from ..components.simulation import Simulation
from ..constants import C_0
from ..log import log
from ..plugins.mode.device_solver import solve_on
from ..plugins.mode.mode_solver import ModeSolver
from ..solver import distributed
from ..solver.distributed import sharding_plan_from_env
from ..solver.fdtd import FDTDRunner
from ..solver.lowering import E_COMPS, lower
from ..solver.profiling import RunMetrics, maybe_profile


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
    ``checkpoint_path`` saves the device state (fields, CPML psi, pole
    currents, monitor accumulators) every ``checkpoint_every`` chunks and
    resumes from the file when it exists, so a long run survives a
    preemption; the file is deleted when the run ends.
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
    simulation.validate_pre_upload()
    # with a coordinator configured the process joins the group first:
    # process 0 lowers and hands every process its plan (a mode source's
    # eigenvectors may differ in sign from one solve to another)
    distributed.initialize(device=device)
    plan = distributed.on_process_zero(_lower, simulation, device)
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
        log.info(f"[{task_name}] kernel tier: {runner.tier_name} "
                 f"[storage: {runner.storage_name}]")
    # refuse an over-budget plan with a SetupError before anything is
    # launched (tidy3d_tpu/web/run.py:91-94)
    runner.check_memory_budget()
    with maybe_profile(device) as trace:
        if checkpoint_path is not None:
            raw = runner.run_checkpointed(checkpoint_path,
                                          checkpoint_every=checkpoint_every,
                                          verbose=verbose)
        else:
            raw = runner.run(verbose=verbose)
    if trace is not None and verbose:
        log.info(f"[{task_name}] profiler trace: {trace}")
    if verbose:
        rate = np.prod(plan.shape) * runner.steps_run \
            / max(runner.wall_time, 1e-9)
        log.info(f"[{task_name}] solved {runner.steps_run} steps in "
                 f"{runner.wall_time:.2f}s ({rate / 1e9:.2f} "
                 "Gcell*steps/s).")
    # in a process group process 0 builds the data (the mode monitors'
    # solves) and every process returns it; only process 0 writes ``path``
    sim_data = distributed.on_process_zero(_assemble, simulation, plan, raw,
                                           runner, task_name, device, path)
    return sim_data


def _lower(simulation, device):
    # every mode solve of the run (the mode sources' in lower(), the mode
    # and mode-solver monitors') runs its device stage on this device
    with solve_on(device):
        return lower(simulation)


def _assemble(simulation, plan, raw, runner, task_name, device, path):
    with solve_on(device):
        sim_data = assemble_sim_data(simulation, plan, raw, runner,
                                     task_name)
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
    ] + metrics.log_lines()

    # group plans by source monitor (flux and projection monitors have
    # per-surface plans)
    surface_groups: Dict[str, List[int]] = {}
    for idx, mp in enumerate(plan.monitors):
        parent = (mp.mode_info or {}).get("parent")
        if parent is not None:
            surface_groups.setdefault(parent, []).append(idx)

    data_list = []
    host_s: Dict[str, float] = {}

    def build(name, fn, *args):
        t0 = _time.perf_counter()
        data_list.append(fn(*args))
        host_s[name] = _time.perf_counter() - t0

    for idx, mp in enumerate(plan.monitors):
        if (mp.mode_info or {}).get("parent") is not None:
            continue  # handled with its parent group below
        monitor = mp.monitor
        if isinstance(monitor, FieldMonitor):
            build(monitor.name, _make_field_data, simulation, mp, raw[idx])
        elif isinstance(monitor, FieldTimeMonitor):
            build(monitor.name, _make_field_time_data, simulation, plan, mp,
                  raw[idx])
        elif isinstance(monitor, PermittivityMonitor):
            build(monitor.name, _make_permittivity_data, plan, mp)
        elif isinstance(monitor, (ModeMonitor, ModeSolverMonitor)):
            build(monitor.name, _make_mode_data, simulation, mp, raw[idx])
        elif isinstance(monitor, DiffractionMonitor):
            build(monitor.name, _make_diffraction_data, simulation, mp,
                  raw[idx])

    # flux and projection monitors: combine their surface plans
    for mon in simulation.monitors:
        idxs = surface_groups.get(mon.name)
        if idxs is None:
            continue
        if isinstance(mon, FluxMonitor):
            build(mon.name, _make_flux_data, plan, raw, idxs, mon)
        elif isinstance(mon, FluxTimeMonitor):
            build(mon.name, _make_flux_time_data, plan, raw, idxs, mon)
        elif isinstance(mon, AbstractFieldProjectionMonitor):
            build(mon.name, _make_projection_data, simulation, plan, raw,
                  idxs, mon)

    est = runner.estimate_device_memory()
    log_lines += [
        f"device memory: peak {getattr(runner, 'hbm_peak_bytes', 0)} B, "
        f"estimate {est['total']} B on {est['device']}",
        "monitor data host seconds: " + ", ".join(
            f"{name} {secs:.3f}" for name, secs in host_s.items()),
        "source terms: " + ", ".join(
            f"{fam} {n}" for fam, n in runner.num_sources.items()),
        f"kernel tier: {runner.tier_name} [storage: {runner.storage_name}]",
    ]
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
    data = _surface_field_data(mp, raw[idx])
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


def _make_permittivity_data(plan, mp) -> PermittivityData:
    """The Yee-grid permittivity of the lowering on the monitor's cells, the
    same at every frequency (the plan has no accumulator)."""
    freqs = np.asarray(mp.freqs)
    arrays = {}
    for comp in E_COMPS:
        eps = plan.eps_yee[comp]
        if np.ndim(eps) == 0:  # uniform background stayed scalar in lowering
            eps = np.broadcast_to(eps, plan.shape)
        vals = eps[mp.slices[comp]][..., None] * np.ones((1, 1, 1, len(freqs)))
        coords = dict(mp.coords[comp])
        coords["f"] = freqs
        arrays[f"eps_{comp[1]}{comp[1]}"] = ScalarFieldDataArray(
            vals.astype(np.complex64), coords=coords)
    return PermittivityData(monitor=mp.monitor, **arrays)


def _surface_field_data(mp, raw_mon) -> FieldData:
    """The DFT fields of one recorded plan as FieldData of a plain field
    monitor over the plan's box."""
    return FieldData(
        monitor=FieldMonitor(
            center=mp.monitor.center, size=mp.monitor.size,
            freqs=np.asarray(mp.freqs).tolist(), name=mp.monitor.name,
            colocate=False,
        ),
        **_field_arrays_freq(mp, raw_mon),
    )


def _make_projection_data(simulation, plan, raw, idxs, monitor):
    """Assemble near-field surfaces and project to the far zone."""
    surfaces = tuple(
        (_surface_field_data(plan.monitors[idx], raw[idx]),
         plan.monitors[idx].mode_info.get("normal_dir") or "+")
        for idx in idxs)
    eps_bg = simulation.medium.eps_model(
        float(np.asarray(plan.monitors[idxs[0]].freqs)[0]))
    projector = FieldProjector(sim_data=None, surfaces=surfaces,
                               medium_n=float(np.real(np.sqrt(eps_bg))))
    return projector.project_fields(monitor)


def _bloch_vec(simulation, axis: int) -> float:
    return getattr(simulation.boundary_spec.to_list[axis][0], "bloch_vec",
                   0.0) or 0.0


def _make_diffraction_data(simulation, mp, raw_mon) -> DiffractionData:
    """Diffraction order amplitudes from the DFT fields on the plane.

    For a plane normal to ``axis`` in a transversely-periodic simulation,
    the order (m, n) amplitudes are the 2D Fourier coefficients of the
    tangential fields, decomposed into s/p polarizations
    (``tidy3d_tpu/web/run.py:345-452``)."""
    monitor = mp.monitor
    axis = mp.mode_info["axis"]
    b_ax, c_ax = (axis + 1) % 3, (axis + 2) % 3
    freqs = np.asarray(mp.freqs)
    comps, (b_dim, c_dim) = _colocated_tangential_fields(
        _surface_field_data(mp, raw_mon), axis)

    # enforce (b, c, f) layout (cyclic ordering is transposed vs the arrays'
    # native xyz dim order for y-normal planes)
    def _ordered(arr):
        want = tuple(d for d in (b_dim, c_dim, "f") if d in arr.dims)
        return arr.transpose(*want) if tuple(arr.dims) != want else arr

    e_b = _ordered(comps[f"E{b_dim}"])
    e_c = _ordered(comps[f"E{c_dim}"])
    bb = np.asarray(e_b.coords[b_dim], dtype=float)
    cc = np.asarray(e_b.coords[c_dim], dtype=float)
    # periodic lengths from the simulation domain; a zero-extent (2D
    # singleton) transverse axis carries no Fourier decomposition: unit
    # effective length and weight
    rmin, rmax = simulation.bounds
    Lb = rmax[b_ax] - rmin[b_ax]
    Lc = rmax[c_ax] - rmin[c_ax]
    Lb_eff = Lb if Lb > 0 else 1.0
    Lc_eff = Lc if Lc > 0 else 1.0
    eps_bg = simulation.medium.eps_model(float(freqs[0]))
    n_med = float(np.real(np.sqrt(eps_bg)))

    # Bloch wavevector offsets (angled incidence): k_t,m = k_bloch + 2 pi m/L
    def _bloch_k(ax, L):
        return 2 * np.pi * _bloch_vec(simulation, ax) / L if L > 0 else 0.0

    kb0 = _bloch_k(b_ax, Lb)
    kc0 = _bloch_k(c_ax, Lc)

    # allowed orders at the highest frequency
    k_max = 2 * np.pi * freqs.max() * n_med / C_0
    m_max = int(np.floor((k_max + abs(kb0)) * Lb / (2 * np.pi))) \
        if Lb > 0 else 0
    n_max = int(np.floor((k_max + abs(kc0)) * Lc / (2 * np.pi))) \
        if Lc > 0 else 0
    orders_b = np.arange(-m_max, m_max + 1)
    orders_c = np.arange(-n_max, n_max + 1)

    # Fourier coefficients via direct projection (nonuniform-grid-safe)
    wb = np.gradient(bb) if len(bb) > 1 else np.full(len(bb), Lb_eff)
    wc = np.gradient(cc) if len(cc) > 1 else np.full(len(cc), Lc_eff)
    w2 = (wb[:, None] * wc[None, :]) / (Lb_eff * Lc_eff)
    amps = np.zeros((len(orders_b), len(orders_c), len(freqs), 2),
                    dtype=complex)
    for mi_, m in enumerate(orders_b):
        for ni_, n in enumerate(orders_c):
            kb = kb0 + (2 * np.pi * m / Lb if Lb > 0 else 0.0)
            kc = kc0 + (2 * np.pi * n / Lc if Lc > 0 else 0.0)
            # the recorded (complex) fields carry the full Bloch phase ramp,
            # so project against the full transverse wavevector
            phase = np.exp(-1j * (kb * bb[:, None] + kc * cc[None, :]))
            for fi in range(len(freqs)):
                k0 = 2 * np.pi * freqs[fi] * n_med / C_0
                kt2 = kb**2 + kc**2
                if kt2 >= k0**2:
                    continue  # evanescent
                coef_b = np.sum(e_b.values[..., fi] * phase * w2)
                coef_c = np.sum(e_c.values[..., fi] * phase * w2)
                # s/p decomposition relative to the in-plane k direction
                if kt2 > 0:
                    ub, uc = kb / np.sqrt(kt2), kc / np.sqrt(kt2)
                else:
                    ub, uc = 1.0, 0.0
                # p: in the plane of incidence (along u); s: perpendicular
                amp_p = coef_b * ub + coef_c * uc
                amp_s = -coef_b * uc + coef_c * ub
                # fold obliquity into the amplitudes so |amp|^2 is the
                # order's diffraction efficiency: P_s = |E_s|^2 cos(theta),
                # P_p = |E_p,tan|^2 / cos(theta)
                cos_t = np.sqrt(k0**2 - kt2) / k0
                amps[mi_, ni_, fi, 0] = amp_s * np.sqrt(cos_t)
                amps[mi_, ni_, fi, 1] = amp_p / np.sqrt(cos_t)

    amps_da = DiffractionDataArray(amps, coords=dict(
        orders_x=orders_b, orders_y=orders_c, f=freqs,
        polarization=np.array(["s", "p"])))
    return DiffractionData(
        monitor=monitor, amps=amps_da, sim_size=(Lb, Lc),
        bloch_vecs=(_bloch_vec(simulation, b_ax),
                    _bloch_vec(simulation, c_ax)),
        medium=simulation.medium)


def _make_mode_data(simulation, mp, raw_mon):
    """ModeData (the DFT fields' overlaps with the solver's modes in both
    directions) or ModeSolverData (the modes), from the mode solver on the
    run's device (``web.run``'s ``solve_on`` scope;
    ``tidy3d_tpu/web/run.py:455-524``)."""
    monitor = mp.monitor
    freqs = np.asarray(mp.freqs)
    mode_spec = monitor.mode_spec
    modes = ModeSolver(
        simulation=simulation, plane=monitor.geometry, mode_spec=mode_spec,
        freqs=freqs.tolist(), colocate=False,
    ).data_raw
    if isinstance(monitor, ModeSolverMonitor):
        return ModeSolverData(
            monitor=monitor,
            Ex=modes.Ex, Ey=modes.Ey, Ez=modes.Ez,
            Hx=modes.Hx, Hy=modes.Hy, Hz=modes.Hz,
            n_complex=modes.n_complex,
        )

    field_data = _surface_field_data(mp, raw_mon)
    axis = mp.mode_info["axis"]
    # backward modes: tangential H negated -> overlap with flipped H
    flipped = {}
    for comp in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"):
        arr = getattr(modes, comp, None)
        if arr is None:
            continue
        flipped[comp] = type(arr)(-arr.values, coords=arr.coords) \
            if comp[0] == "H" else arr

    def to_np(arr):
        vals = np.asarray(arr.values if hasattr(arr, "values") else arr)
        # dims (f, mode_index) expected
        if hasattr(arr, "dims") and tuple(arr.dims) != ("f", "mode_index"):
            order = [arr.dims.index("f"), arr.dims.index("mode_index")]
            vals = np.transpose(vals, order)
        return vals

    amps = np.stack([
        to_np(_mode_overlaps(modes, field_data, axis, conjugate=True)),
        to_np(_mode_overlaps(ModeSolverDataset(**flipped), field_data, axis,
                             conjugate=True)),
    ]).astype(np.complex128)
    amps_arr = ModeAmpsDataArray(
        amps, coords=dict(direction=np.array(["+", "-"]), f=freqs,
                          mode_index=np.arange(mode_spec.num_modes)))
    return ModeData(monitor=monitor, amps=amps_arr, n_complex=modes.n_complex)
