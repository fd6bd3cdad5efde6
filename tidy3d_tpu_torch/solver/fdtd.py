"""The FDTD time-stepping runner in PyTorch: the counterpart of
``tidy3d_tpu/solver/fdtd.py``.

One step is an E half-step, E-source injection, the dispersive pole update,
an H half-step, H-source injection and running-DFT / time-sample monitor
accumulation, exactly as in ``tidy3d_tpu.solver.fdtd.FDTDRunner._step``.
The field update runs on one of three tiers (``self.tier``), each a
hand-written CUDA kernel for tensors on the GPU and its plain PyTorch
version for tensors on the CPU:

* ``kstep``: one launch of ``kernels.kstep.kstep_group`` per group of k
  steps (both half-steps, the CPML, the J and M sources and the pole update
  of every substep inside), the monitors only at the group ends where a
  sample lands, on Nyquist-strided DFT tables, in the order of
  ``FDTDRunner._step_group``;
* ``fused``: one launch of ``kernels.fused.fused_step`` per step (both
  half-steps, J sources inside), then the H sources, the pole update and
  the monitors, in the order of ``FDTDRunner._step_fused``;
* ``pallas2``: two launches of ``kernels.step.family_update`` per step.

``TIDY3D_TPU_KERNEL`` picks the tier as in the JAX package: ``auto`` (the
default) takes, on a CUDA device, ``kstep`` when the k-step kernel takes the
run, else ``fused`` when the fused kernel does, else ``pallas2``; on the
CPU it starts at ``fused``, as the JAX package's ``auto`` takes its XLA path
off the TPU, so the CPU default samples the monitors at every step.
``kstep``, ``fused`` and ``pallas2`` force a tier, and a forced tier that
does not take the run raises. ``xla``, which selects the JAX package's
two-phase reference path, selects ``pallas2``, and an ``_interpret`` suffix
names the same tier. ``TIDY3D_TPU_KSTEP`` (``auto`` | ``0`` | k) picks k as
the JAX package reads it (``kstep_order``). The choice is made from the
plan alone, before anything is built or launched.

Differences from the JAX runner, all of which leave the arithmetic alone:

* The loop runs eagerly from the host: one chunk of steps at a time, with
  one device-to-host read (the field maximum for the decay shutoff) per
  chunk, where the JAX runner compiles the whole loop into one dispatch.
* Monitor accumulators are updated in place.
* Stencil layout is the XLA path's with tile quanta fixed at 1, 1, 1: psi
  slabs are exactly the CPML width (plus one), with no TPU-tile rounding.
* On the one-step tiers the waveform tables stay on the host: a source
  adds ``profile * w(t)`` with ``w(t)`` passed as a scalar. The kstep tier
  keeps them on the device (``kernels.kstep.SourceTables``), where its
  kernel reads ``w(t0 + j)`` for substep j.
* On the one-step tiers the pole currents are updated in place; the kstep
  tier reads one buffer set and writes the other (ping-pong, allocated
  once in ``init_state``).
* The pole update and the monitor accumulation run inside the profiler
  ranges ``fdtd.poles`` and ``fdtd.monitors``.

Bloch (complex) runs step two real copies of the fields (re and im: ``E``,
``H``, ``psi`` and ``E1``, ``H1``, ``psi1``) that mix only where a stencil
wraps across an axis with a Bloch phase and in the complex source terms.
They run on the kstep tier only, as in the JAX package, whose one-step
kernels have no copy machinery (``tidy3d_tpu/solver/fdtd.py:297-300``):
``auto`` takes kstep on the CPU too, a forced one-step tier raises, and so
does a plan the kstep tier does not take. The DFT adds copy 1 rotated into
both quadratures, time monitors record copy 0.

Covered: unsharded, float32, linear runs, real with up to ``MAX_POLES``
dispersive (pole-residue) pole slots, or complex without poles. Nonlinear
media, time modulation, Bloch runs with poles (the JAX package runs them on
its XLA path only), sharding, bfloat16 storage and checkpointing raise
``NotImplementedError``.
"""

from __future__ import annotations

import os
import time as _time
from typing import Dict, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..constants import EPSILON_0
from ..exceptions import DivergenceError
from ..log import log
from .kernels import fused as fused_kernels
from .kernels import kstep as kstep_kernels
from .kernels import step as step_kernels
from .kernels.step import MAX_POLES
from .lowering import E_COMPS, H_COMPS, SimulationPlan

NUM_CHUNKS = 20
SHUTOFF_MIN_CHUNKS = 4

# TIDY3D_TPU_KERNEL value -> requested tier ("auto" chooses)
_KERNEL_ENV = {"auto": "auto", "kstep": "kstep", "fused": "fused",
               "pallas2": "pallas2", "xla": "pallas2"}


def _axis_reshape(vec: np.ndarray, axis: int) -> np.ndarray:
    shape = [1, 1, 1]
    shape[axis] = len(vec)
    return vec.reshape(shape)


def _check_supported(plan: SimulationPlan, precision) -> None:
    if len(plan.poles) > MAX_POLES:
        raise NotImplementedError(
            f"{len(plan.poles)} dispersive pole slots: the port takes at "
            f"most {MAX_POLES}")
    if plan.nonlinear is not None:
        raise NotImplementedError("nonlinear media are not ported yet")
    if plan.modulation:
        raise NotImplementedError("time-modulated media are not ported yet")
    if plan.is_complex and plan.poles:
        raise NotImplementedError(
            "Bloch boundaries with dispersive poles are not ported yet (the "
            "JAX package runs them on its XLA path only)")
    prec = precision or os.environ.get("TIDY3D_TPU_PRECISION", "float32")
    if str(prec).lower() not in ("float32", "f32", "fp32"):
        raise NotImplementedError(
            f"field storage precision '{prec}' is not ported yet; only "
            "float32 runs")


def bloch_phases(plan: SimulationPlan):
    """``(c, s)`` of each axis's Bloch phase ``e^{i phi}``, or None where
    it is 1 within 1e-12 (a plain periodic axis), as
    ``tidy3d_tpu/solver/fdtd.py:109-114`` decides."""
    return tuple(None if abs(ph - 1.0) <= 1e-12
                 else (float(np.real(ph)), float(np.imag(ph)))
                 for ph in plan.bloch_phases)


def build_constants(plan: SimulationPlan) -> Tuple[dict, dict]:
    """Host (numpy) constants of one plan: ``(consts, pml_meta)``.

    The port of ``FDTDRunner._build_constants`` for the runs the port covers,
    with tile quanta 1, 1, 1. ``pml_meta[(family, axis)]`` is the
    ``(w_lo, w_hi)`` width of the psi slabs, ``family`` being ``"dual"`` (E
    update) or ``"primal"`` (H update)."""
    f32 = np.float32

    def compact(arr):
        arr = np.asarray(arr, f32)
        flat0 = arr.flat[0]
        if np.all(arr == flat0):
            return f32(flat0)
        return arr

    consts: dict = {}
    consts["coeffs_E"] = {c: (compact(a), compact(b))
                          for c, (a, b) in plan.coeffs_E.items()}
    consts["coeffs_H"] = {c: (compact(a), compact(b))
                          for c, (a, b) in plan.coeffs_H.items()}

    # inverse steps with the CPML 1/kappa stretch folded in
    pml_meta: Dict[Tuple[str, int], Tuple[int, int]] = {}
    consts["pml"] = {}
    inv_dual, inv_primal = [], []
    for axis in range(3):
        n = plan.shape[axis]
        cf_d = plan.pml_dual[axis]
        cf_p = plan.pml_primal[axis]
        inv_dual.append(_axis_reshape(
            (plan.inv_dual[axis] * cf_d.inv_kappa).astype(f32), axis))
        inv_primal.append(_axis_reshape(
            (plan.inv_primal[axis] * cf_p.inv_kappa).astype(f32), axis))
        for fam, cf in (("dual", cf_d), ("primal", cf_p)):
            w_lo = min(cf.n_lo + 1, n) if cf.n_lo else 0
            w_hi = min(cf.n_hi + 1, n) if cf.n_hi else 0
            pml_meta[(fam, axis)] = (w_lo, w_hi)
            if w_lo == 0 and w_hi == 0:
                continue
            # c_eff = c * kappa compensates the kappa folded into inv_*
            kappa = 1.0 / np.where(cf.inv_kappa == 0, 1.0, cf.inv_kappa)
            c_eff = cf.c * kappa
            consts["pml"][f"{fam}{axis}"] = dict(
                b_lo=_axis_reshape(cf.b[:w_lo].astype(f32), axis),
                c_lo=_axis_reshape(c_eff[:w_lo].astype(f32), axis),
                b_hi=_axis_reshape(cf.b[n - w_hi:].astype(f32), axis),
                c_hi=_axis_reshape(c_eff[n - w_hi:].astype(f32), axis),
            )
    consts["inv_dual"] = inv_dual
    consts["inv_primal"] = inv_primal

    consts["waveforms"] = np.asarray(plan.waveforms)
    consts["src_profiles"] = [np.asarray(sp.profile) for sp in plan.sources]

    # 1D PEC-wall masks for tangential E on lower domain walls
    consts["wall_masks"] = {}
    for i, comp in enumerate(E_COMPS):
        masks = []
        for axis in range(3):
            if axis == i:
                continue
            if plan.boundaries[axis][0] == "pec":
                m = np.ones(plan.shape[axis], f32)
                m[0] = 0.0
                masks.append(_axis_reshape(m, axis))
        if masks:
            consts["wall_masks"][comp] = masks
    consts["dft"] = build_dft_tables(plan)
    consts.update(build_pole_constants(plan))
    return consts, pml_meta


def build_pole_constants(plan: SimulationPlan) -> dict:
    """The dispersive-pole constants (the port of ``fdtd.py:444-478``).

    ``pole_scalars[p] = (A, Gc)`` with ``A = (1 + a dt/2) / (1 - a dt/2)``
    and ``Gc = a (A + 1)``; ``pole_B_meta[p][ci]`` is ``{"kind": "zero"}``,
    ``{"kind": "mask", "mask_id", "B0": (re, im)}`` or ``{"kind":
    "dense"}``. Residues stay compressed: a uniform medium ships one shared
    float32 indicator per support (``pole_masks``) and a complex scalar per
    pole, and only spatially varying residues ship dense re/im maps
    (``pole_B_dense["p_ci"]``)."""
    f32 = np.float32
    dt = plan.dt
    scalars, metas_all, dense = [], [], {}
    for pi, pole in enumerate(plan.poles):
        a = pole.a
        A = (1.0 + a * dt / 2.0) / (1.0 - a * dt / 2.0)
        Gc = a * (A + 1.0)
        scalars.append((complex(A), complex(Gc)))
        metas = []
        for ci in range(3):
            if pole.c_maps is not None:
                Bm = EPSILON_0 * pole.c_maps[ci] * (dt / 2.0) \
                    / (1.0 - a * dt / 2.0)
                dense[f"{pi}_{ci}"] = (np.asarray(np.real(Bm), f32),
                                       np.asarray(np.imag(Bm), f32))
                metas.append(dict(kind="dense"))
                continue
            mid = pole.mask_ids[ci]
            c = pole.c_vals[ci]
            if mid < 0 or c == 0:
                metas.append(dict(kind="zero"))
                continue
            B0 = EPSILON_0 * c * (dt / 2.0) / (1.0 - a * dt / 2.0)
            metas.append(dict(kind="mask", mask_id=mid,
                              B0=(float(B0.real), float(B0.imag))))
        metas_all.append(metas)
    return {"pole_masks": [np.asarray(m, f32) for m in plan.pole_masks],
            "pole_B_dense": dense, "pole_scalars": scalars,
            "pole_B_meta": metas_all}


def _is_dft(mp) -> bool:
    return mp.kind == "field" and mp.freqs is not None and len(mp.freqs) > 0


def nyquist_fmax(plan: SimulationPlan, freqs) -> float:
    """The highest frequency with energy at a DFT monitor: the monitor's
    own frequencies and ``f0 + 2.5 fwidth`` of every source (the port of
    ``FDTDRunner._nyquist_fmax``), so that the sampling stride resolves
    the source spectrum and nothing aliases onto the monitor band."""
    fmax = float(np.max(np.abs(np.asarray(freqs, np.float64))))
    for src in plan.simulation.sources:
        st = getattr(src, "source_time", None)
        f0 = float(getattr(st, "freq0", 0.0) or 0.0)
        fw = float(getattr(st, "fwidth", 0.0) or 0.0)
        fmax = max(fmax, f0 + 2.5 * fw)
    return fmax


def _nyquist_steps(plan: SimulationPlan, freqs):
    """The Nyquist step count of a DFT monitor, or None without energy."""
    fmax = nyquist_fmax(plan, freqs)
    return max(int(1.0 / (2 * fmax) / plan.dt), 1) if fmax > 0 else None


def _dft_stride(plan: SimulationPlan, freqs, k: int) -> int:
    """The DFT sampling stride of a monitor on k-step groups: 1 for k = 1,
    else ``k * max(1, nyquist // k)``, a whole number of groups."""
    if k <= 1:
        return 1
    nyq = _nyquist_steps(plan, freqs)
    return k * max(1, (nyq if nyq is not None else k) // k)


def monitors_allow_k(plan: SimulationPlan, k: int) -> bool:
    """Whether every monitor can sample at the ends of k-step groups (the
    port of ``FDTDRunner._monitors_allow_k``): a DFT monitor needs k at
    most its Nyquist step count, a time monitor needs
    ``t_start % k == k - 1`` and ``k | t_interval``."""
    for mp in plan.monitors:
        if _is_dft(mp):
            nyq = _nyquist_steps(plan, mp.freqs)
            if nyq is not None and k > nyq:
                return False
        elif mp.kind == "field_time":
            if mp.t_interval % k or mp.t_start % k != k - 1:
                return False
    return True


def monitor_group_stride(plan: SimulationPlan, k: int) -> int:
    """B: the monitors accumulate after group g only where ``(g + 1) % B
    == 0`` (every sampled step lands on such a group end); the largest
    divisor of at most 16 of the gcd of the monitors' group periods, as
    ``FDTDRunner._build_dft_tables`` sets ``_mon_group_stride``."""
    periods = []
    for mp in plan.monitors:
        if _is_dft(mp):
            periods.append(_dft_stride(plan, mp.freqs, k) // k)
        elif mp.kind == "field_time":
            periods.append(max(mp.t_interval // k, 1))
            periods.append(max((mp.t_start + 1) // k, 1))
    B = 0
    for p in periods:
        B = np.gcd(B, p)
    B = int(B) if B else 1
    if B > 16:
        B = max(d for d in range(1, 17) if B % d == 0)
    return B


def build_dft_tables(plan: SimulationPlan, k: int = 1) -> dict:
    """Running-DFT cos/sin tables per frequency-domain monitor (the port of
    ``FDTDRunner._build_dft_tables``).

    Row ``t`` weights the E fields at ``t_e = tmesh[t] + dt`` and the H
    fields at ``t_h = tmesh[t] + 1.5 dt`` by ``dt * apodization``. With
    ``k > 1`` (the k-step tier, whose fields exist only at group ends) the
    DFT samples on the stride ``k * max(1, nyquist // k)``: rows with
    ``(t + 1) % stride == 0`` weigh ``dt * stride * apodization``, the
    others zero."""
    f32 = np.float32
    tmesh = plan.tmesh
    dft = {}
    for mi, mp in enumerate(plan.monitors):
        if not _is_dft(mp):
            continue
        freqs = np.asarray(mp.freqs)
        apod = mp.monitor.apodization.apodization_weights(tmesh) \
            if getattr(mp.monitor, "apodization", None) is not None \
            else np.ones_like(tmesh)
        stride = _dft_stride(plan, freqs, k)
        t_e = tmesh + plan.dt
        t_h = tmesh + 1.5 * plan.dt
        w = plan.dt * apod
        if stride > 1:
            sample = ((np.arange(len(tmesh)) + 1) % stride) == 0
            w = np.where(sample, w * stride, 0.0)
        ang_e = 2 * np.pi * t_e[:, None] * freqs[None, :]
        ang_h = 2 * np.pi * t_h[:, None] * freqs[None, :]
        dft[str(mi)] = (
            (w[:, None] * np.cos(ang_e)).astype(f32),
            (w[:, None] * np.sin(ang_e)).astype(f32),
            (w[:, None] * np.cos(ang_h)).astype(f32),
            (w[:, None] * np.sin(ang_h)).astype(f32),
        )
    return dft


def kstep_unsupported_reason(plan: SimulationPlan, k: int,
                             num_sources: Dict[str, int]):
    """Why the k-step tier does not take the plan at group size k, or
    None if it does. The semantic gates of ``PallasKStepper.supported``
    (real, linear, unmodulated, at most ``MAX_POLES`` pole slots, monitors
    that sample at group ends) and the kernel's own (its k, its source
    tables: ``kstep.unsupported_reason``). The TPU's layout gates (z
    alignment, profile and waveform byte caps, packed z-psi lanes, VMEM
    configuration) do not apply."""
    if plan.nonlinear is not None or plan.modulation:
        return "nonlinear or time-modulated media"
    if len(plan.poles) > MAX_POLES:
        return f"{len(plan.poles)} pole slots (at most {MAX_POLES})"
    if not monitors_allow_k(plan, k):
        return (f"a monitor does not sample at the ends of {k}-step "
                "groups")
    return kstep_kernels.unsupported_reason(k, num_sources)


def kstep_order() -> Tuple[int, ...]:
    """The group sizes k to try, from ``TIDY3D_TPU_KSTEP`` as the JAX
    package reads it (``fdtd.py:274-294``): ``auto`` tries k = 4 then 2, an
    integer tries itself first, ``0`` disables the k-step tier. The kernel
    is built for k = 2 only (``kernels.kstep.KS``), so on this port every
    other k is refused and k = 2 runs."""
    env = os.environ.get("TIDY3D_TPU_KSTEP", "auto") or "auto"
    if env == "0":
        return ()
    first = 4 if env == "auto" else int(env)
    return tuple(dict.fromkeys(k for k in (first, 4, 2) if k >= 2))


def align_chunk(chunk_size: int, k: int, B: int) -> int:
    """The chunk size rounded up to whole loop iterations of the kstep
    tier, k * gpi steps, where gpi is B if B is even and 2B otherwise
    (the port of ``FDTDRunner._align_chunk``: chunks hold whole monitor
    strides and return the ping-pong sets to their places)."""
    unit = k * (B if B % 2 == 0 else 2 * B)
    return -(-chunk_size // unit) * unit


def select_tier(plan: SimulationPlan, num_sources: Dict[str, int],
                device, kernel: str = None) -> Tuple[str, int]:
    """``(tier, k)`` of a run: ``("kstep", k)``, ``("fused", 1)`` or
    ``("pallas2", 1)``, decided from the plan alone (nothing is built or
    launched to find out). ``num_sources`` counts the source terms per
    family (``"E"``, ``"H"``); ``kernel`` defaults to ``TIDY3D_TPU_KERNEL``
    (``auto``). ``auto`` on a CUDA device takes kstep, then fused, then
    pallas2, as the JAX package does on the TPU; ``auto`` on the CPU takes
    fused, as the JAX package takes its XLA path off the TPU, so the CPU
    default keeps every-step monitor sampling. A complex (Bloch) plan takes
    kstep on every device: the one-step tiers have no Bloch copies. A
    forced tier that does not take the run raises, and so does a complex
    plan that the kstep tier does not take. ``_check_supported`` has
    already refused what no tier takes."""
    kernel = kernel or os.environ.get("TIDY3D_TPU_KERNEL", "auto") or "auto"
    # the CPU runs the plain versions, so the interpret modes are the tiers
    want = _KERNEL_ENV.get(kernel.removesuffix("_interpret"))
    if want is None:
        raise ValueError(f"TIDY3D_TPU_KERNEL={kernel!r}: the port has the "
                         "tiers " + ", ".join(sorted(_KERNEL_ENV)))
    if plan.is_complex and want not in ("auto", "kstep"):
        raise ValueError(f"TIDY3D_TPU_KERNEL={kernel}: the {want} tier has "
                         "no Bloch copies; complex runs take the kstep tier")
    if want == "kstep" or plan.is_complex or (
            want == "auto" and torch.device(device).type == "cuda"):
        reasons = [f"TIDY3D_TPU_KSTEP={os.environ.get('TIDY3D_TPU_KSTEP')}"
                   " disables it"] if not kstep_order() else []
        for k in kstep_order():
            reason = kstep_unsupported_reason(plan, k, num_sources)
            if reason is None:
                return "kstep", k
            reasons.append(f"k={k}: {reason}")
        if want == "kstep" or plan.is_complex:
            raise ValueError(f"TIDY3D_TPU_KERNEL={kernel}: the kstep tier "
                             f"does not take this run ({'; '.join(reasons)})")
    reason = fused_kernels.unsupported_reason(num_sources["E"])
    if want == "auto":
        return ("fused", 1) if reason is None else ("pallas2", 1)
    if want == "fused" and reason is not None:
        raise ValueError(f"TIDY3D_TPU_KERNEL={kernel}: the fused tier does "
                         f"not take this run ({reason})")
    return want, 1


def update_poles(new_e: dict, old_e: dict, Q: list, consts: dict) -> list:
    """The semi-implicit pole-current update (the port of
    ``FDTDRunner._update_poles``, ``fdtd.py:1145-1184``), in place on the
    ``(qr, qi)`` buffers of ``Q``, which it returns.

    ``Q' = A Q + B (E^{n+1} + E^n)`` per pole and component, with the
    complex products written out in real and imaginary parts as the
    reference writes them. ``E^{n+1} + E^n`` is formed once per component
    and its product with a support mask once per (mask, component), so the
    poles of one metal share them."""
    cache = {}
    for pi, ((A, _), metas, Qp) in enumerate(zip(
            consts["pole_scalars"], consts["pole_B_meta"], Q)):
        for ci, comp in enumerate(E_COMPS):
            qr, qi = Qp[comp]
            # qr' = Re(A) qr - Im(A) qi, qi' = Im(A) qr + Re(A) qi
            im_qr = qr * A.imag
            qr.mul_(A.real).add_(qi, alpha=-A.imag)
            qi.mul_(A.real).add_(im_qr)
            del im_qr
            m = metas[ci]
            if m["kind"] == "zero":
                continue
            if ("e", ci) not in cache:
                cache[("e", ci)] = new_e[comp] + old_e[comp]
            esum = cache[("e", ci)]
            if m["kind"] == "mask":
                mkey = (m["mask_id"], ci)
                if mkey not in cache:
                    cache[mkey] = consts["pole_masks"][m["mask_id"]] * esum
                mes = cache[mkey]
                b_re, b_im = m["B0"]
                if b_re:
                    qr.add_(mes, alpha=b_re)
                if b_im:
                    qi.add_(mes, alpha=b_im)
            else:
                b_re, b_im = consts["pole_B_dense"][f"{pi}_{ci}"]
                qr.addcmul_(b_re, esum)
                qi.addcmul_(b_im, esum)
    return Q


def _dev(x, device):
    """numpy array -> tensor on ``device``; numpy scalar -> Python float."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return float(x)


def consts_to_device(consts: dict, device) -> dict:
    """The device copy of the stepping constants (waveforms and source
    profiles stay on the host: the runner folds them into its source
    terms)."""
    out = {
        "coeffs_E": {c: (_dev(a, device), _dev(b, device))
                     for c, (a, b) in consts["coeffs_E"].items()},
        "coeffs_H": {c: (_dev(a, device), _dev(b, device))
                     for c, (a, b) in consts["coeffs_H"].items()},
        "inv_dual": [_dev(v, device) for v in consts["inv_dual"]],
        "inv_primal": [_dev(v, device) for v in consts["inv_primal"]],
        "pml": {key: {k: _dev(v, device) for k, v in d.items()}
                for key, d in consts["pml"].items()},
        "wall_masks": {c: [_dev(m, device) for m in ms]
                       for c, ms in consts["wall_masks"].items()},
        "dft": {key: tuple(_dev(t, device) for t in tables)
                for key, tables in consts["dft"].items()},
        "pole_masks": [_dev(m, device) for m in consts["pole_masks"]],
        "pole_B_dense": {key: (_dev(re, device), _dev(im, device))
                         for key, (re, im) in consts["pole_B_dense"].items()},
        "pole_scalars": list(consts["pole_scalars"]),
        "pole_B_meta": consts["pole_B_meta"],
    }
    return out


class FDTDRunner:
    """Runs the time-stepping loop of one ``SimulationPlan`` on ``device``.

    ``use_kernel=False`` steps with the plain PyTorch versions of the tier
    on any device; it exists so that the kernels can be held against them
    on the GPU. ``kernel`` overrides ``TIDY3D_TPU_KERNEL`` for this runner.
    """

    def __init__(self, plan: SimulationPlan, device="cuda",
                 precision: str = None, use_kernel: bool = True,
                 kernel: str = None):
        _check_supported(plan, precision)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
        self.plan = plan
        self.shape = tuple(plan.shape)
        self.num_steps = plan.num_steps
        self.dtype = torch.float32
        self.use_kernel = use_kernel
        self.host_consts, self.pml_meta = build_constants(plan)
        self.consts = consts_to_device(self.host_consts, self.device)
        self.meta = step_kernels.StepMeta(
            shape=self.shape, boundaries=tuple(plan.boundaries),
            pml_meta=dict(self.pml_meta), bloch=bloch_phases(plan))
        self.is_complex = plan.is_complex
        # the state keys that a kstep group reads and writes
        self._group_keys = ("E", "H", "psi", "Q") + (
            kstep_kernels.COPIES[1] if self.is_complex else ())
        self._sources = {"E": [], "H": []}
        self._build_sources()
        self.tier, self.k = select_tier(
            plan, {fam: len(v) for fam, v in self._sources.items()},
            self.device, kernel)
        # monitors accumulate after group g only where (g + 1) % B == 0
        self.mon_group_stride = 1
        self.tables = None
        if self.tier == "kstep":
            self.host_consts["dft"] = build_dft_tables(plan, self.k)
            self.consts["dft"] = {
                key: tuple(_dev(t, self.device) for t in tables)
                for key, tables in self.host_consts["dft"].items()}
            self.mon_group_stride = monitor_group_stride(plan, self.k)
            self.tables = kstep_kernels.SourceTables(
                self._sources, self._waveforms, self.shape, self.device)

    # ------------------------------------------------------------------ #
    # sources
    # ------------------------------------------------------------------ #

    def _build_sources(self):
        """Per family, a ``kstep.SourceTerm`` per current source: the step
        adds ``term * waveform[key, step]``, ``term = -c_b * profile``. In a
        complex run each (re, im) plan pair of lowering is one term
        (``kstep.group_source_plans``), with the im plan's profile in
        ``term_im`` and the re plan's ``waveform_key_im`` in ``key_im``."""
        hc = self.host_consts
        wf = hc["waveforms"]
        if np.iscomplexobj(wf):
            keys = {sp.waveform_key for sp in self.plan.sources}
            if any(np.any(np.imag(wf[k]) != 0) for k in keys):
                raise NotImplementedError(
                    "complex source waveforms are not ported yet")
            wf = np.real(wf)
        self._waveforms = np.asarray(wf, np.float32)

        def term(si, box, cb_sl):
            profile = hc["src_profiles"][si]
            if np.iscomplexobj(profile):
                if np.any(np.imag(profile) != 0):
                    raise NotImplementedError(
                        "complex source profiles are not ported yet")
                profile = np.real(profile)
            return _dev(np.array(np.broadcast_to(
                -cb_sl * np.asarray(profile, np.float32), box), np.float32),
                self.device)

        sources = self.plan.sources
        for i_re, i_im in kstep_kernels.group_source_plans(sources,
                                                           self.is_complex):
            sp = sources[i_re]
            if sp.waveform_key is None:
                continue
            fam = "E" if sp.comp in E_COMPS else "H"
            _, cb = hc["coeffs_E" if fam == "E" else "coeffs_H"][sp.comp]
            cb_sl = cb[sp.slices] if np.ndim(cb) else cb
            box = tuple(len(range(*s.indices(n)))
                        for s, n in zip(sp.slices, self.shape))
            self._sources[fam].append(kstep_kernels.SourceTerm(
                sp.comp, sp.slices, term(i_re, box, cb_sl), sp.waveform_key,
                term(i_im, box, cb_sl) if i_im is not None else None,
                sp.waveform_key_im if self.is_complex else None))

    def step_sources(self, family: str, step: int) -> list:
        """``(comp, slices, term, w)`` of each source term at ``step`` (the
        one-step tiers: real runs only)."""
        return [(s.comp, s.slices, s.term, float(self._waveforms[s.key, step]))
                for s in self._sources[family]]

    def _inject(self, family: str, fields: dict, step: int):
        for comp, sl, term, w in self.step_sources(family, step):
            fields[comp][sl].add_(term * w)

    # ------------------------------------------------------------------ #
    # state
    # ------------------------------------------------------------------ #

    def psi_shapes(self) -> Dict[str, Tuple[int, int, int]]:
        """psi slab shapes keyed ``"comp|axis|side"`` (XLA-path layout)."""
        shapes = {}
        for comp in E_COMPS + H_COMPS:
            fam = "dual" if comp[0] == "E" else "primal"
            i = "xyz".index(comp[1])
            for deriv_axis in ((i + 1) % 3, (i + 2) % 3):
                w_lo, w_hi = self.pml_meta[(fam, deriv_axis)]
                for side, width in (("lo", w_lo), ("hi", w_hi)):
                    if width == 0:
                        continue
                    s = list(self.shape)
                    s[deriv_axis] = width
                    shapes[f"{comp}|{deriv_axis}|{side}"] = tuple(s)
        return shapes

    def init_state(self) -> dict:
        def zeros(s):
            return torch.zeros(s, dtype=self.dtype, device=self.device)

        def fields():
            out = {"Q": [{c: (zeros(self.shape), zeros(self.shape))
                          for c in E_COMPS} for _ in self.plan.poles]}
            # copy 1 of a complex run: the imaginary part
            for e, h, p in kstep_kernels.COPIES[:1 + self.is_complex]:
                out[e] = {c: zeros(self.shape) for c in E_COMPS}
                out[h] = {c: zeros(self.shape) for c in H_COMPS}
                out[p] = {k: zeros(s) for k, s in self.psi_shapes().items()}
            return out

        state = fields()
        state["mon"] = [self._init_monitor_acc(mi, mp)
                        for mi, mp in enumerate(self.plan.monitors)]
        if self.tier == "kstep":
            # the ping-pong set: each group reads one set and writes the
            # other (allocated once; the runner swaps them)
            state["alt"] = fields()
        return state

    def _init_monitor_acc(self, mi, mp):
        acc = {}
        f32 = torch.float32
        if mp.kind == "field" and str(mi) in self.consts["dft"]:
            nf = len(mp.freqs)
            for comp in mp.comps:
                s = tuple(s_.stop - s_.start for s_ in mp.slices[comp]) + (nf,)
                acc[comp] = (torch.zeros(s, dtype=f32, device=self.device),
                             torch.zeros(s, dtype=f32, device=self.device))
        elif mp.kind == "field_time":
            n_samples = max(
                (mp.t_stop - mp.t_start + mp.t_interval - 1)
                // mp.t_interval, 1)
            for comp in mp.comps:
                s = (n_samples,) + tuple(s_.stop - s_.start
                                         for s_ in mp.slices[comp])
                acc[comp] = torch.zeros(s, dtype=f32, device=self.device)
        return acc

    # ------------------------------------------------------------------ #
    # the step
    # ------------------------------------------------------------------ #

    def _family_update(self, family, state, src_fields):
        fn = step_kernels.family_update if self.use_kernel \
            else step_kernels.family_update_reference
        return fn(family, state, self.consts, src_fields, self.meta)

    def _accumulate_monitors(self, step: int, newE, newH, mon, newE1=None,
                             newH1=None):
        """Running-DFT / time-sample accumulation on the fresh fields, in
        place on the accumulators of ``mon``. In a complex run ``newE1`` and
        ``newH1`` are copy 1: the DFT adds it rotated into both quadratures,
        ``(v0 + i v1) e^{i w t}`` (``tidy3d_tpu/solver/fdtd.py:1217-1223``),
        and time monitors record copy 0 only."""
        consts = self.consts
        for mi, (mp, acc) in enumerate(zip(self.plan.monitors, mon)):
            key = str(mi)
            if mp.kind == "field" and key in consts["dft"]:
                cos_e, sin_e, cos_h, sin_h = consts["dft"][key]
                ph = {"E": (cos_e[step], sin_e[step]),
                      "H": (cos_h[step], sin_h[step])}
                for comp in mp.comps:
                    is_e = comp in E_COMPS
                    fields = newE if is_e else newH
                    vals = fields[comp][mp.slices[comp]].unsqueeze(-1)
                    cos_t, sin_t = ph[comp[0]]
                    acc_re, acc_im = acc[comp]
                    acc_re.addcmul_(vals, cos_t)
                    acc_im.addcmul_(vals, sin_t)
                    if newE1 is not None:
                        vals1 = (newE1 if is_e else newH1)[comp][
                            mp.slices[comp]].unsqueeze(-1)
                        acc_re.addcmul_(vals1, sin_t, value=-1.0)
                        acc_im.addcmul_(vals1, cos_t)
            elif mp.kind == "field_time":
                if not (mp.t_start <= step < mp.t_stop
                        and (step - mp.t_start) % mp.t_interval == 0):
                    continue
                idx = (step - mp.t_start) // mp.t_interval
                for comp in mp.comps:
                    fields = newE if comp in E_COMPS else newH
                    acc[comp][idx].copy_(fields[comp][mp.slices[comp]])
        return mon

    def step(self, step: int, state: dict) -> dict:
        """One leapfrog step from ``state`` (the pole currents update and
        the monitors accumulate in place) on a one-step tier."""
        if self.tier == "kstep":
            raise ValueError("the kstep tier steps in groups of k "
                             "(run_steps, step_group)")
        if self.tier == "fused":
            fn = fused_kernels.fused_step if self.use_kernel \
                else fused_kernels.fused_step_reference
            nE, nH, psi = fn(state, self.consts, self.meta,
                             self.step_sources("E", step))
            self._inject("H", nH, step)
            Q = self._update_poles(nE, state)
        else:
            nE, psi_E = self._family_update("E", state, state["H"])
            self._inject("E", nE, step)
            Q = self._update_poles(nE, state)
            nH, psi_H = self._family_update("H", state, nE)
            self._inject("H", nH, step)
            psi = dict(state["psi"])
            psi.update(psi_E)
            psi.update(psi_H)
        with record_function("fdtd.monitors"):
            mon = self._accumulate_monitors(step, nE, nH, state["mon"])
        return {"E": nE, "H": nH, "psi": psi, "Q": Q, "mon": mon}

    def _update_poles(self, new_e, state):
        if not state["Q"]:
            return state["Q"]
        with record_function("fdtd.poles"):
            return update_poles(new_e, state["E"], state["Q"], self.consts)

    def step_group(self, gi: int, state: dict, accumulate: bool = True
                   ) -> dict:
        """Group ``gi`` of the kstep tier: steps ``gi k`` to ``gi k + k -
        1`` in one launch of the k-step kernel (J and M sources, the pole
        update and the CPML of every substep inside), written to the
        ping-pong set, which becomes the state; the set read becomes the
        next ping-pong set. The monitors accumulate on the group-end fields
        at step ``gi k + k - 1`` when ``accumulate`` (the DFT tables are
        strided, so no sample lands elsewhere)."""
        k = self.k
        fn = kstep_kernels.kstep_group if self.use_kernel \
            else kstep_kernels.kstep_group_reference
        new = fn(state, self.consts, self.meta, self.tables, gi * k, k,
                 out=state["alt"])
        mon = state["mon"]
        if accumulate:
            with record_function("fdtd.monitors"):
                mon = self._accumulate_monitors(
                    gi * k + k - 1, new["E"], new["H"], mon, new.get("E1"),
                    new.get("H1"))
        return dict(new, mon=mon, alt={key: state[key]
                                       for key in self._group_keys})

    def run_steps(self, start: int, num: int, state: dict) -> dict:
        """Steps ``start`` to ``start + num - 1``; on the kstep tier both
        are multiples of k and the steps run in groups."""
        if self.tier != "kstep":
            for n in range(num):
                state = self.step(start + n, state)
            return state
        k, B = self.k, self.mon_group_stride
        if start % k or num % k:
            raise ValueError(f"the kstep tier runs whole groups of {k} "
                             f"steps (start {start}, {num} steps)")
        for gi in range(start // k, (start + num) // k):
            state = self.step_group(gi, state, accumulate=(gi + 1) % B == 0)
        return state

    def align_chunk(self, chunk_size: int) -> int:
        """The chunk size, rounded up to whole kstep loop iterations on
        the kstep tier (``align_chunk``)."""
        if self.tier != "kstep":
            return chunk_size
        return align_chunk(chunk_size, self.k, self.mon_group_stride)

    @property
    def tier_name(self) -> str:
        """The tier as the run log names it: ``kstep (k=2)``, ``fused``,
        ``pallas2``."""
        return f"kstep (k={self.k})" if self.tier == "kstep" else self.tier

    def _max_field(self, state) -> torch.Tensor:
        """The largest |E| over both copies of a complex run
        (``tidy3d_tpu/solver/fdtd.py:1765-1776``)."""
        return torch.stack([state[e][c].abs().amax() for c in E_COMPS
                            for e in ("E", "E1") if e in state]).amax()

    # ------------------------------------------------------------------ #
    # run
    # ------------------------------------------------------------------ #

    def _pad_time_tables(self, padded_steps: int):
        """Zero waveforms and DFT weights past the plan's last step (the
        last chunk may run past it)."""
        extra = padded_steps - self._waveforms.shape[1]
        if extra <= 0:
            return
        self._waveforms = np.pad(self._waveforms, ((0, 0), (0, extra)))
        self.host_consts["dft"] = {
            k: tuple(np.pad(t, ((0, extra), (0, 0))) for t in tables)
            for k, tables in self.host_consts["dft"].items()}
        self.consts["dft"] = {
            key: tuple(_dev(t, self.device) for t in tables)
            for key, tables in self.host_consts["dft"].items()}
        if self.tables is not None:
            self.tables.set_waveforms(self._waveforms)

    def run(self, verbose: bool = False) -> dict:
        """Execute the time loop; returns the raw monitor data (numpy) keyed
        by monitor-plan index, as ``tidy3d_tpu``'s runner does."""
        plan = self.plan
        chunk_size = self.align_chunk(max(self.num_steps // NUM_CHUNKS, 1))
        num_chunks = (self.num_steps + chunk_size - 1) // chunk_size
        self._pad_time_tables(num_chunks * chunk_size)
        shutoff = float(plan.simulation.shutoff or 0.0)

        t0 = _time.perf_counter()
        if self.use_kernel:
            {"kstep": kstep_kernels, "fused": fused_kernels,
             "pallas2": step_kernels}[self.tier].prepare(self.device)
        self.compile_time = _time.perf_counter() - t0

        start_time = _time.perf_counter()
        state = self.init_state()
        ci, max_ever, cur = 0, 0.0, 0.0
        while ci < num_chunks:
            if shutoff > 0 and ci >= SHUTOFF_MIN_CHUNKS \
                    and cur < shutoff * max_ever:
                break
            state = self.run_steps(ci * chunk_size, chunk_size, state)
            cur = float(self._max_field(state).item())
            max_ever = float(np.maximum(max_ever, cur))
            ci += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_time = _time.perf_counter() - start_time
        self.steps_run = ci * chunk_size
        self.final_decay = cur / max_ever if max_ever > 0 else 1.0
        if not np.isfinite(cur) or not np.isfinite(max_ever):
            raise DivergenceError(
                "Simulation diverged: non-finite fields detected "
                f"(after {self.steps_run} steps).")
        if verbose:
            log.info(f"ran {self.steps_run} steps in {self.wall_time:.2f}s; "
                     f"final field decay {self.final_decay:.2e}.")

        t1 = _time.perf_counter()
        out = {}
        for idx, (mp, acc) in enumerate(zip(plan.monitors, state["mon"])):
            mon = {}
            for comp, arr in acc.items():
                if mp.kind == "field":
                    re_ = arr[0].cpu().numpy()
                    im_ = arr[1].cpu().numpy()
                    mon[comp] = re_ + 1j * im_
                else:
                    mon[comp] = arr.cpu().numpy()
            out[idx] = mon
        self.transfer_time = _time.perf_counter() - t1
        return out
