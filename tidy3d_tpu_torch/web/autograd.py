"""Adjoint shape/medium-parameter gradients via the two-solve protocol:
the counterpart of ``tidy3d_tpu/web/autograd.py``, whose numpy parts it
copies; the objective's VJP is taken by ``torch.autograd`` and both solves
are the port's ``web.run`` on ``device`` (the GPU unless the caller names
another), so both run on the kernels.

The reference's differentiable ``web.run`` (its autograd pipeline,
tidy3d/web/api/autograd/autograd.py:86,384,568) traces
structure parameters, runs a forward solve with per-structure gradient
monitors, synthesizes an adjoint simulation from monitor-data VJPs, runs
it, and assembles per-structure gradients client-side via
``Structure.compute_derivatives``. This module implements the same
protocol natively (no tracer machinery — the traced set is explicit).

Derivation (e^{-i w t} phasor convention, DFT kernel e^{+i w t}):
with A(eps) E = i w mu0 J the curl-curl operator and normalized monitor
fields E_m = A^{-1}(i w mu0 P) for a source with spatial profile P,
a perturbation d(eps_r) gives dE_m = k0^2 A^{-1}(d(eps_r) E_m). For a
real objective J_obj with dJ = 2 Re[v . dE_m], reciprocity (A symmetric)
yields

    dJ/d(eps_r)(x) = 2 k0^2 Re[lam(x) . E_m(x)] dV,
    A lam = v  ->  adjoint current J_adj = v / (i w mu0).

No discrete-time phase correction is needed: the monitor DFT kernels
timestamp the true sample times (tmesh + dt for E), so the half-step
injection offsets cancel exactly (the JAX package verified it numerically
against jax.grad through its solver, scripts/adjoint_map_check.py).

``RECORDS`` holds, for each of the last ``RECORDS.maxlen`` calls of
``run_structure_gradients``, the host seconds of its stages, in their order (``forward_s``, ``vjp_s``,
``adjoint_s``, ``assembly_s``), the ``time.perf_counter()`` at which the
first began (``started``) and each run's log (``forward_log``,
``adjoint_log``: the kernel tier and the source-term counts among its
lines).
"""

from __future__ import annotations

import collections
import functools
import time
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

from ..components.autograd.derivative_utils import DerivativeInfo
from ..components.data.monitor_data import (
    DiffractionData,
    FieldData,
    ModeData,
    PermittivityData,
)
from ..components.data.sim_data import SimulationData
from ..components.simulation import Simulation
from ..components.structure import Structure
from ..exceptions import SetupError
from ..log import log

PathLike = Tuple[str, str]
RECORDS: collections.deque = collections.deque(maxlen=32)


def _monitor_fields(sim_data: SimulationData, names: Sequence[str]) -> Dict:
    """Complex arrays of the user monitors the objective consumes."""
    out = {}
    for name in names:
        md = sim_data[name]
        if isinstance(md, (ModeData, DiffractionData)):
            out[name] = {"amps": np.asarray(md.amps.values)}
        elif isinstance(md, FieldData):
            out[name] = {c: np.asarray(arr.values)
                         for c, arr in md.field_components.items()
                         if arr is not None}
        else:
            raise SetupError(
                f"objective monitor {name!r} must be a Field, Mode or "
                f"Diffraction monitor (got {type(md).__name__})")
    return out


def _objective_vjp(objective: Callable, fields: Dict) -> Tuple[float, Dict]:
    """(J, g) with g[name][comp] = dJ/dRe + i dJ/dIm per complex sample,
    by ``torch.autograd`` over float64 (re, im) leaves; ``objective`` is a
    torch function of ``{name: {comp: complex128 tensor}}``."""
    import torch

    flat = {name: {c: tuple(torch.tensor(part, dtype=torch.float64,
                                         requires_grad=True)
                            for part in (np.real(a), np.imag(a)))
                   for c, a in comps.items()}
            for name, comps in fields.items()}
    rebuilt = {name: {c: torch.complex(*parts) for c, parts in comps.items()}
               for name, comps in flat.items()}
    val = objective(rebuilt)
    leaves = [t for comps in flat.values() for pair in comps.values()
              for t in pair]
    grads = iter(torch.autograd.grad(val, leaves, allow_unused=True))

    def part(t, leaf):
        return np.zeros(leaf.shape) if t is None else t.numpy()

    g = {}
    for name, comps in flat.items():
        g[name] = {}
        for c, (re, im) in comps.items():
            g[name][c] = part(next(grads), re) + 1j * part(next(grads), im)
    return float(val.detach()), g


def _vjp_data(sim_data: SimulationData, vjps: Dict) -> SimulationData:
    """Copy of sim_data whose objective-monitor values are the VJPs."""
    new_data = []
    for md in sim_data.data:
        name = md.monitor.name
        if name in vjps:
            update = {}
            if isinstance(md, (ModeData, DiffractionData)):
                update["amps"] = type(md.amps)(vjps[name]["amps"],
                                               coords=md.amps.coords)
            else:
                for c, gval in vjps[name].items():
                    arr = getattr(md, c)
                    update[c] = type(arr)(gval, coords=arr.coords)
            md = md.copy(update=update)
            new_data.append(md)
        else:
            # non-objective monitors carry zero VJP: drop them so they
            # produce no adjoint sources
            continue
    return sim_data.copy(update=dict(data=tuple(new_data)))


def _fit_broadband_sources(sources, freqs, tmesh, dt, fwidth,
                           complex_fields=False):
    """Spectral-coupling correction for a multi-frequency adjoint solve.

    ``make_adjoint_sim`` synthesizes one source per (pattern, frequency)
    with a GaussianPulse at that frequency; injected together, pulse k
    also delivers current at frequency j through its spectral tail
    S_k(f_j). Because the solve is LTI, exactness is restored by remixing:
    per spatial pattern, solve ``S c = a`` where S[j,k] is the unit-pulse
    coupling matrix and a the VJP amplitudes — the adjoint run is then
    UNNORMALIZED (the caller sets normalize_index=None) and its field at
    each f_j is the response to exactly a_j, as in the single-frequency
    path. Reference behavior model: sim_data.py:1132-1281 implements only
    the single-pattern broadband case and raises for several patterns;
    the remix handles several patterns (each pattern's system is
    independent and superposes).

    Mode-source patterns vary (slowly) with the pulse center frequency —
    the same approximation the reference's broadband path makes.
    """
    import json

    from ..components.source import CustomCurrentSource, GaussianPulse

    freqs = [float(f) for f in freqs]
    nf = len(freqs)
    f_idx = {f: j for j, f in enumerate(freqs)}

    # unit-pulse coupling matrix S[j, k] = spectrum of pulse at f_k, at f_j
    pulses = [GaussianPulse(freq0=f, fwidth=fwidth) for f in freqs]
    S = np.stack([p.spectrum(tmesh, np.asarray(freqs), dt,
                             complex_fields=complex_fields)
                  for p in pulses], axis=1)
    # the multi-frequency adjoint runs UNNORMALIZED (normalize_index=None,
    # set by the caller): the target delivered current spectrum at each
    # objective frequency is the VJP amplitude itself
    s_norm = np.ones(nf, dtype=complex)

    groups: Dict[str, dict] = {}
    for src in sources:
        st = src.source_time
        if not isinstance(st, GaussianPulse):
            raise SetupError(
                "multi-frequency adjoint only supports GaussianPulse "
                f"adjoint sources (got {type(st).__name__})")
        j = f_idx.get(float(st.freq0))
        if j is None:
            raise SetupError(
                f"adjoint source frequency {st.freq0} is not an objective "
                "frequency")
        if isinstance(src, CustomCurrentSource):
            kind = "dataset"
            key_fields = {k: v for k, v in src.dict().items()
                          if k not in ("source_time", "current_dataset")}
            amp = src.current_dataset
        else:
            kind = "scalar"
            key_fields = {k: v for k, v in src.dict().items()
                          if k != "source_time"}
            amp = st.amplitude * np.exp(1j * st.phase)
        key = type(src).__name__ + json.dumps(key_fields, default=str,
                                              sort_keys=True)
        g = groups.setdefault(key, {"kind": kind, "template": src,
                                    "amps": {}})
        if j in g["amps"]:
            raise SetupError(
                "duplicate adjoint source pattern at one frequency; "
                "cannot fit broadband sources")
        g["amps"][j] = amp

    out = []
    for g in groups.values():
        if g["kind"] == "scalar":
            a = np.zeros(nf, dtype=complex)
            for j, amp in g["amps"].items():
                a[j] = amp
            c, *_ = np.linalg.lstsq(S, s_norm * a, rcond=None)
            resid = np.linalg.norm(S @ c - s_norm * a) / \
                max(np.linalg.norm(s_norm * a), 1e-300)
            if resid > 1e-6:
                raise SetupError(
                    f"broadband adjoint-source fit residual {resid:.2e} "
                    "too large (spectrally degenerate objective "
                    "frequencies); run one adjoint per frequency")
            cmax = np.abs(c).max()
            for k, ck in enumerate(c):
                if abs(ck) < 1e-12 * cmax:
                    continue
                out.append(g["template"].copy(update=dict(
                    source_time=GaussianPulse(
                        freq0=freqs[k], fwidth=fwidth,
                        amplitude=float(abs(ck)),
                        phase=float(np.angle(ck))))))
        else:
            # dataset pattern: the same scalar solve applies component-wise
            # (W mixes whole spatial datasets across frequencies)
            # W[k, j]: weight of target-j pattern in the pulse-k source
            W = np.linalg.lstsq(S, np.diag(s_norm), rcond=None)[0]
            resid = np.linalg.norm(S @ W - np.diag(s_norm)) / \
                np.linalg.norm(np.diag(s_norm))
            if resid > 1e-6:
                raise SetupError(
                    f"broadband adjoint-source fit residual {resid:.2e} "
                    "too large (spectrally degenerate objective "
                    "frequencies); run one adjoint per frequency")
            # reference arrays per component (coords template)
            ref_arr = {}
            for amp in g["amps"].values():
                for cname, arr in amp.items():
                    ref_arr.setdefault(cname, arr)
            for k in range(nf):
                new_ds = {}
                for cname, ref in ref_arr.items():
                    acc = np.zeros_like(np.asarray(ref.values),
                                        dtype=complex)
                    for j, amp in g["amps"].items():
                        if cname in amp and abs(W[k, j]) > 0:
                            acc = acc + W[k, j] * np.asarray(
                                amp[cname].values)
                    if not np.any(acc):
                        continue
                    coords = {d: np.asarray(ref.coords[d]) for d in "xyz"}
                    coords["f"] = np.array([freqs[k]])
                    new_ds[cname] = type(ref)(acc, coords=coords)
                if not new_ds:
                    continue
                out.append(g["template"].copy(update=dict(
                    source_time=GaussianPulse(freq0=freqs[k],
                                              fwidth=fwidth),
                    current_dataset=new_ds)))
    out.sort(key=lambda s: f_idx[float(s.source_time.freq0)])
    return out


def setup_fwd(simulation: Simulation, traced: Dict[int, Sequence[PathLike]],
              freqs: Sequence[float]) -> Simulation:
    """Forward simulation with per-traced-structure gradient monitors."""
    dls = [float(np.mean(np.asarray(simulation.grid.sizes.to_list[a])))
           for a in range(3)]
    pad = 2.5 * max(dls)
    monitors = list(simulation.monitors)
    for si in sorted(traced):
        structure = simulation.structures[si]
        fld, eps = structure.make_adjoint_monitors(freqs, si, pad=pad)
        monitors += [fld, eps]
    return simulation.copy(update=dict(monitors=tuple(monitors)))


def _field_tuple(md, comps=("Ex", "Ey", "Ez"), freq: float = None):
    """dict comp -> (complex values at freq, coords dict) from monitor data."""
    out = {}
    for c in comps:
        arr = getattr(md, c, None)
        if arr is None:
            continue
        vals = np.asarray(arr.sel(f=freq).values) if freq is not None \
            else np.asarray(arr.values)[..., 0]
        coords = {d: np.asarray(arr.coords[d]) for d in "xyz"}
        out[c] = (vals, coords)
    return out


def _eps_tuple(md: PermittivityData, freq: float):
    out = {}
    for c, key in (("Ex", "eps_xx"), ("Ey", "eps_yy"), ("Ez", "eps_zz")):
        arr = getattr(md, key, None)
        if arr is None:
            continue
        vals = np.asarray(arr.sel(f=freq).values)
        coords = {d: np.asarray(arr.coords[d]) for d in "xyz"}
        out[c] = (vals, coords)
    return out


def run_structure_gradients(
    simulation: Simulation,
    objective: Callable,
    traced: Dict[int, Sequence[PathLike]],
    monitor_names: Sequence[str] = None,
    run_fn: Callable = None,
    adjoint_fwidth: float = None,
    device="cuda",
) -> Tuple[float, Dict[int, Dict[PathLike, np.ndarray]], SimulationData]:
    """Objective value and adjoint gradients for traced structure params.

    Parameters
    ----------
    objective : Callable
        torch function of ``{monitor_name: {comp: complex tensor}}``
        returning a real scalar. Field monitors provide ``Ex..Hz``; mode
        monitors provide ``amps``.
    traced : dict
        structure index -> list of ('geometry'|'medium', field_name) paths.
    device : str
        where both solves run (``web.run``'s ``device``) when ``run_fn`` is
        not given.

    Returns (J, gradients, forward SimulationData).
    """
    from .run import run as _default_run

    run_fn = run_fn or functools.partial(_default_run, device=device)
    t0 = time.perf_counter()
    times = {"started": t0}

    if monitor_names is None:
        monitor_names = [m.name for m in simulation.monitors]
    freqs = sorted({float(f) for name in monitor_names
                    for f in np.atleast_1d(
                        simulation.monitors[[m.name for m in
                                             simulation.monitors].index(name)]
                        .freqs)})
    multi_freq = len(freqs) > 1

    sim_fwd = setup_fwd(simulation, traced, freqs)
    data_fwd = run_fn(sim_fwd, task_name="adjoint_fwd", verbose=False)
    times["forward_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    fields = _monitor_fields(data_fwd, monitor_names)
    value, vjps = _objective_vjp(objective, fields)

    data_vjp = _vjp_data(data_fwd, vjps)
    fwidth = adjoint_fwidth
    if fwidth is None and simulation.sources:
        fwidth = float(simulation.sources[0].source_time.fwidth)
    sim_adj = data_vjp.make_adjoint_sim(fwidth=fwidth)
    if not sim_adj.sources:
        log.warning("adjoint simulation has no sources (zero objective VJP)")
        return value, {si: {tuple(p): 0.0 for p in paths}
                       for si, paths in traced.items()}, data_fwd
    # adjoint sim keeps only the gradient monitors
    grad_monitors = [m for m in sim_fwd.monitors
                     if m.name.startswith("adjoint_fld_")]
    if multi_freq:
        # remix per-frequency sources for spectral pulse coupling and run
        # the adjoint unnormalized (delivered current == VJP amplitude)
        corrected = _fit_broadband_sources(
            list(sim_adj.sources), freqs, simulation.tmesh, simulation.dt,
            fwidth, complex_fields=simulation.complex_fields)
        sim_adj = sim_adj.copy(update=dict(
            sources=tuple(corrected), monitors=tuple(grad_monitors),
            normalize_index=None))
    else:
        sim_adj = sim_adj.copy(update=dict(monitors=tuple(grad_monitors),
                                           normalize_index=0))
    times["vjp_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data_adj = run_fn(sim_adj, task_name="adjoint_bwd", verbose=False)
    times["adjoint_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    dt = simulation.dt
    # identical to the rasterizer's local dl scales (solver/lowering.py)
    avg_dls = tuple(
        float(np.mean(np.diff(np.asarray(
            simulation.grid.boundaries.to_list[a])))) for a in range(3))
    dl_loc = float(np.mean(avg_dls))
    grads: Dict[int, Dict[PathLike, np.ndarray]] = {}
    for si, paths in traced.items():
        structure: Structure = simulation.structures[si]
        md_fwd = data_fwd[f"adjoint_fld_{si}"]
        md_adj = data_adj[f"adjoint_fld_{si}"]
        md_eps = data_fwd[f"adjoint_eps_{si}"]
        acc: Dict[PathLike, np.ndarray] = {}
        for freq0 in freqs:
            eps_in = structure.medium.eps_model(freq0)
            if structure.background_permittivity is not None:
                eps_out = complex(structure.background_permittivity)
            else:
                eps_out = simulation.medium.eps_model(freq0)
            info = DerivativeInfo(
                E_fwd=_field_tuple(md_fwd, freq=freq0),
                E_adj=_field_tuple(md_adj, freq=freq0),
                eps_data=_eps_tuple(md_eps, freq0),
                eps_in=eps_in, eps_out=eps_out,
                frequency=freq0, bounds=structure.geometry.bounds, dt=dt,
                dl_loc=dl_loc, avg_dls=avg_dls)
            g_f = structure.compute_derivatives(
                [tuple(p) for p in paths], info)
            for p, gv in g_f.items():
                acc[p] = gv if p not in acc else acc[p] + gv
        grads[si] = acc
    times["assembly_s"] = time.perf_counter() - t0
    RECORDS.append(dict(times, forward_log=data_fwd.log,
                        adjoint_log=data_adj.log))
    return value, grads, data_fwd
