"""The FDTD time-stepping runner in PyTorch: the counterpart of
``tidy3d_tpu/solver/fdtd.py``.

One step is an E half-step, E-source injection, the modulation and nonlinear
passes, the dispersive pole update, an H half-step, H-source injection and
running-DFT / time-sample monitor accumulation, exactly as in
``tidy3d_tpu.solver.fdtd.FDTDRunner._step``.
The field update runs on one of three tiers (``self.tier``), each a
hand-written CUDA kernel for tensors on the GPU and its plain PyTorch
version for tensors on the CPU:

* ``kstep``: one launch of ``kernels.kstep.kstep_group`` per group of k
  steps (both half-steps, the CPML, the J and M sources and the pole update
  of every substep inside), the monitors only at the group ends where a
  sample lands, on Nyquist-strided DFT tables, in the order of
  ``FDTDRunner._step_group``;
* ``fused``: one call of ``kernels.fused.fused_step`` per step (both
  half-steps, J sources and the pole update inside), then the H sources
  and the monitors, in the order of ``FDTDRunner._step_fused``;
* ``pallas2``: two calls of the family kernel per step
  (``kernels.step.family_update_copies``: both copies of a Bloch run in one
  launch), with the J sources, the modulation and nonlinear passes
  (``kernels.post_e``, one launch; constants and plain version in
  ``nonlinear``) and the pole update (``update_poles``, plain PyTorch) of
  each copy between them, in the order of ``FDTDRunner._step``.

``TIDY3D_TPU_KERNEL`` picks the tier as in the JAX package: ``auto`` (the
default) takes, on a CUDA device, ``kstep`` when the k-step kernel takes the
run, else ``fused`` when the fused kernel does, else ``pallas2``; on the
CPU it starts at ``fused``, as the JAX package's ``auto`` takes its XLA path
off the TPU, so the CPU default samples the monitors at every step.
Nonlinear and modulated plans take ``pallas2`` (the passes sit between the
E update and the pole update, where neither the fused nor the k-step kernel
leaves a place, as the JAX package's ``supported`` gates decide); more than
``MAX_POLES`` pole slots leave the k-step kernel, as in the JAX package.
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
* On the ``pallas2`` tier the pole currents are updated in place; the
  kstep tier reads one buffer set and writes the other, and the fused tier
  one pole-current set and the other (ping-pong, allocated once in
  ``init_state`` as ``state["alt"]``).
* The plain pole update of the ``pallas2`` tier, its modulation and
  nonlinear passes and the monitor accumulation run inside the profiler
  ranges ``fdtd.poles``, ``fdtd.post_e`` and ``fdtd.monitors``.

Bloch (complex) runs step two real copies of the fields (re and im: ``E``,
``H``, ``psi``, ``Q`` and ``E1``, ``H1``, ``psi1``, ``Q1``) that mix only
where a stencil wraps across an axis with a Bloch phase and in the complex
source terms. They take the kstep tier where the k-step kernel takes them
(``auto`` tries it on the CPU too) and ``pallas2`` otherwise (poles,
modulation, a time monitor off the group ends, more source terms than the
k-step table), where the JAX package steps them on its XLA path
(``tidy3d_tpu/solver/fdtd.py:297-300``); a forced ``fused`` raises (no
copies). The DFT adds copy 1 rotated into both quadratures, time monitors
record copy 0. A nonlinear Bloch run raises, as in the JAX package.

Sharded runs (``sharding_plan``, a ``sharding.ShardingPlan``) split x into
slabs, one per mesh entry, on the kstep tier, as the JAX package's
``_make_run_fn_sharded`` runs its k-step kernel under ``shard_map``
(``tidy3d_tpu/solver/fdtd.py:1823-1906``). One process drives every
shard; a mesh may name one device several times (virtual shards). Shard s
owns ``nx / n`` planes and holds every x-spanning array padded by k halo
planes per side (``sharding.XSlabs``). Each group first refreshes the halo
planes of the buffer set it reads from the neighbours' core edges (a ring:
shard 0's left neighbour is the last shard), then launches the k-step
kernel once per shard in its shard-local mode; the set that was exchanged
is the one carried forward as the next ping-pong set. Each shard
accumulates the part of each monitor it owns, and ``run()`` joins the parts
in x order. A single-axis y or z decomposition rotates the plan onto x
(``plan_rotate.py``) and the raw monitors back. The gate
(``shard_unsupported_reason``) and the refusals: a sharded request runs
sharded on the kstep tier or raises, and mixed 2D/3D decompositions and
sharded Bloch runs, which the JAX package sends to its GSPMD XLA path,
raise ``NotImplementedError``.

Covered: every plan the JAX package runs on one device: real or complex
(Bloch) runs with any number of dispersive (pole-residue) pole slots, time
modulation in either, nonlinear media in real runs. Sharded Bloch runs and
mixed 2D/3D decompositions (the JAX package's GSPMD XLA path) raise
``NotImplementedError``, and so does a nonlinear Bloch run (as the JAX
package refuses it).

Storage types (``storage_types``), as the JAX package picks them
(``tidy3d_tpu/solver/fdtd.py:115-122``, ``pallas_kstep.py:158-175``): the
fields are bfloat16 under ``precision="bfloat16"`` (or ``"bf16"``, or
``TIDY3D_TPU_PRECISION``), float32 otherwise; on the kstep tier the psi
slabs are bfloat16 under ``TIDY3D_TPU_PSI_DTYPE=bfloat16`` and the pole
currents under ``TIDY3D_TPU_Q_DTYPE=bfloat16``, each the fields' type
otherwise; on the one-step tiers psi and the pole currents take the
fields' type. Every kernel computes in float32 and rounds where it stores;
the monitor accumulators stay float32. On the one-step tiers the source
terms are rounded to the fields' type and then added, and a bfloat16 pole
update of the ``pallas2`` tier computes as the reference's
``_update_poles`` does under JAX's promotion rules (``update_poles``);
both round at their stores as ``FDTDRunner._cast_state`` does. The fused
tier computes its pole update in float32 from E' rounded to the fields'
type and rounds Q' once, where it stores it.

``estimate_device_memory`` counts the bytes each device holds for the run
(its constants, the state with its second buffer set, the shards' halo
planes, a step's temporaries and a margin) and ``check_memory_budget``
raises ``SetupError`` when a device's count exceeds its limit
(``TIDY3D_TPU_HBM_BYTES``, else the CUDA device's memory; the CPU is not
checked; ``TIDY3D_TPU_MEM_CHECK=0`` turns it off), as
``tidy3d_tpu/solver/fdtd.py:545-630`` does. ``run`` records the peak of
``torch.cuda.max_memory_allocated`` in ``hbm_peak_bytes``.

``make_differentiable_run`` returns ``fn(consts) -> (mon_out,
final_state)``, the monitor accumulators as a reverse-mode differentiable
function of the constant tree, as ``tidy3d_tpu/solver/fdtd.py:1908-1955``
does. It runs no kernel, by design: the JAX package turns its three
Pallas tiers off while it differentiates (``pallas_call`` has no
transpose) and takes ``jax.grad`` through its XLA step under
``jax.checkpoint``; the port takes PyTorch autograd through the plain
out-of-place step sequence of the ``pallas2`` tier (``_diff_step``) under
``torch.utils.checkpoint``, one chunk at a time, on the runner's device
(``AUTODIFF_TIER``, the ``kernel tier:`` line such a run logs). Real
float32 runs only: Bloch runs, bfloat16 storage and sharded runs raise
``NotImplementedError``.

``run_checkpointed`` saves the state every few chunks into a ``.npz`` of
named arrays (``save_checkpoint``), resumes from it when the file exists
(``load_checkpoint``, which refuses a file of another grid, tier, k or
decomposition) and deletes it when the run ends, as
``tidy3d_tpu/solver/fdtd.py:1961-2069`` does. The kstep tier's ping-pong
set is not saved: a group writes every cell of the set it is given that a
later group reads (a shard's halo planes are refreshed by the exchange
before they are read).
"""

from __future__ import annotations

import os
import time as _time
from typing import Dict, Tuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch.profiler import record_function

from ..constants import EPSILON_0
from ..exceptions import DivergenceError, SetupError
from ..log import log
from .kernels import fused as fused_kernels
from .kernels import kstep as kstep_kernels
from .kernels import step as step_kernels
from .kernels.step import MAX_POLES, StepMeta
from .kernels import post_e as post_e_kernels
from .lowering import E_COMPS, H_COMPS, SimulationPlan
from .nonlinear import (
    build_post_e_constants, compact, has_post_e, pad_mod_tables,
    post_e_reference, post_e_to_device,
)
from .plan_rotate import perm_for_rot, rotate_plan, unrotate_raw
from .sharding import ShardingPlan, XSlabs, mesh_devices

NUM_CHUNKS = 20
SHUTOFF_MIN_CHUNKS = 4
CHECKPOINT_VERSION = 1
# the working margin of the memory estimate: half the state plus this
MARGIN_BYTES = 256 << 20

# what the differentiable run steps with (make_differentiable_run)
AUTODIFF_TIER = ("autodiff: PyTorch autograd through the plain pallas2 step "
                 "sequence, checkpointed per chunk (no kernel: the JAX "
                 "package differentiates its XLA step)")

# TIDY3D_TPU_KERNEL value -> requested tier ("auto" chooses)
_KERNEL_ENV = {"auto": "auto", "kstep": "kstep", "fused": "fused",
               "pallas2": "pallas2", "xla": "pallas2"}
Q_KEYS = ("Q", "Q1")    # the pole currents of copy 0 and copy 1


def _axis_reshape(vec: np.ndarray, axis: int) -> np.ndarray:
    shape = [1, 1, 1]
    shape[axis] = len(vec)
    return vec.reshape(shape)


def field_dtype(precision=None) -> torch.dtype:
    """The fields' storage type: bfloat16 for ``bf16`` or ``bfloat16``,
    float32 for ``float32`` (``f32``, ``fp32``), from ``precision`` or
    else ``TIDY3D_TPU_PRECISION``; any other value raises."""
    prec = precision or os.environ.get("TIDY3D_TPU_PRECISION", "float32")
    value = str(prec).lower()
    if value in ("bf16", "bfloat16"):
        return torch.bfloat16
    if value in ("float32", "f32", "fp32"):
        return torch.float32
    raise NotImplementedError(
        f"field storage precision '{prec}': the port stores float32 or "
        "bfloat16")


def storage_types(precision, tier: str) -> Tuple[torch.dtype, ...]:
    """``(field, psi, q)``: the storage types of the fields, the psi slabs
    and the pole currents of a run on ``tier``. The kstep tier reads
    ``TIDY3D_TPU_PSI_DTYPE`` and ``TIDY3D_TPU_Q_DTYPE`` (``bfloat16``, else
    the fields' type), as the JAX package's k-step kernel does
    (``pallas_kstep.py:158-175``); the one-step tiers store psi and the
    pole currents at the fields' type, as the JAX package's do."""
    field = field_dtype(precision)
    if tier != "kstep":
        return field, field, field
    return (field,) + tuple(
        torch.bfloat16 if os.environ.get(knob, "") == "bfloat16" else field
        for knob in ("TIDY3D_TPU_PSI_DTYPE", "TIDY3D_TPU_Q_DTYPE"))


def type_name(dtype: torch.dtype) -> str:
    """``float32`` or ``bfloat16``."""
    return str(dtype).removeprefix("torch.")


def _check_supported(plan: SimulationPlan, precision) -> None:
    if plan.is_complex and plan.nonlinear is not None:
        # the reference's refusal and words (tidy3d_tpu/solver/fdtd.py:124)
        raise NotImplementedError(
            "nonlinear media with Bloch (complex-field) boundaries are "
            "not supported")
    field_dtype(precision)


def bloch_phases(plan: SimulationPlan):
    """``(c, s)`` of each axis's Bloch phase ``e^{i phi}``, or None where
    it is 1 within 1e-12 (a plain periodic axis), as
    ``tidy3d_tpu/solver/fdtd.py:109-114`` decides."""
    return tuple(None if abs(ph - 1.0) <= 1e-12
                 else (float(np.real(ph)), float(np.imag(ph)))
                 for ph in plan.bloch_phases)


def build_constants(plan: SimulationPlan) -> Tuple[dict, dict]:
    """Host (numpy) constants of one plan: ``(consts, pml_meta)``.

    The port of ``FDTDRunner._build_constants``, with tile quanta 1, 1, 1
    (the modulation and nonlinear constants: ``nonlinear``).
    ``pml_meta[(family, axis)]`` is the
    ``(w_lo, w_hi)`` width of the psi slabs, ``family`` being ``"dual"`` (E
    update) or ``"primal"`` (H update)."""
    f32 = np.float32
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
    consts.update(build_post_e_constants(plan, consts["coeffs_E"]))
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
    (no Bloch copies with poles, linear, unmodulated, at most
    ``MAX_POLES`` pole slots, monitors that sample at group ends;
    ``pallas_kstep.py:290-299``) and the kernel's own (its k, its source
    tables: ``kstep.unsupported_reason``). The TPU's layout gates (z
    alignment, profile and waveform byte caps, packed z-psi lanes, VMEM
    configuration) do not apply."""
    if plan.is_complex and plan.poles:
        return "Bloch copies with dispersive poles"
    if plan.nonlinear is not None or plan.modulation:
        return "nonlinear or time-modulated media"
    if len(plan.poles) > MAX_POLES:
        return f"{len(plan.poles)} pole slots (at most {MAX_POLES})"
    if not monitors_allow_k(plan, k):
        return (f"a monitor does not sample at the ends of {k}-step "
                "groups")
    return kstep_kernels.unsupported_reason(k, num_sources)


def shard_unsupported_reason(shape, pml_meta, k: int, ndev: int):
    """Why an x-slab decomposition over ``ndev`` shards does not take a
    grid of ``shape`` on the k-step kernel at group size k, or None if it
    does: the counterpart of ``PallasKStepper.supported_sharded``
    (``pallas_kstep.py:333-370``) for this kernel, whose blocks need no TPU
    quanta. nx must split evenly; every shard must be at least 2k planes
    thick; and each x-PML slab, with the k planes of its neighbour's halo,
    must lie inside its edge shard, so that no halo plane of another shard
    is a CPML plane."""
    nx = shape[0]
    if nx % ndev:
        return f"{nx} x planes do not split into {ndev} equal shards"
    nx_loc = nx // ndev
    if nx_loc < 2 * k:
        return (f"shards of {nx_loc} planes (at least 2k = {2 * k} for "
                f"the k-plane halos)")
    if ndev > 1:
        for side, name in ((0, "lo"), (1, "hi")):
            w = max(pml_meta[("dual", 0)][side],
                    pml_meta[("primal", 0)][side])
            if w and w + k > nx_loc:
                return (f"the {name} x-PML slab of {w} planes and its "
                        f"{k}-plane cone do not fit in the edge shard of "
                        f"{nx_loc} planes")
    return None


def shard_constants(host_consts: dict, pml_meta: dict, layout: XSlabs,
                    s: int) -> Tuple[dict, dict]:
    """Shard s's host constants and psi slab widths: every x-spanning
    array (per-cell coefficients, the x inverse steps, PEC masks along x,
    pole masks and dense residues) as its padded x-slice
    (``pallas_kstep.py:714-770``, ``:982-1036``, ``:1183-1193``), and the
    x CPML tables and x psi slabs on the sides that are the global edge
    only."""
    nx = layout.nx

    def take(v):
        if isinstance(v, np.ndarray) and v.ndim == 3 and v.shape[0] == nx:
            return layout.take(v, s)
        return v

    out = dict(host_consts)
    for key in ("coeffs_E", "coeffs_H"):
        out[key] = {c: (take(a), take(b))
                    for c, (a, b) in host_consts[key].items()}
    for key in ("inv_dual", "inv_primal"):
        out[key] = [take(v) for v in host_consts[key]]
    out["wall_masks"] = {c: [take(m) for m in ms]
                         for c, ms in host_consts["wall_masks"].items()}
    out["pole_masks"] = [take(m) for m in host_consts["pole_masks"]]
    out["pole_B_dense"] = {key: (take(re), take(im)) for key, (re, im)
                           in host_consts["pole_B_dense"].items()}
    edge = [not h for h in layout.halo(s)]
    meta = dict(pml_meta)
    for fam in ("dual", "primal"):
        w_lo, w_hi = pml_meta[(fam, 0)]
        meta[(fam, 0)] = (w_lo if edge[0] else 0, w_hi if edge[1] else 0)
    out["pml"] = {key: d for key, d in host_consts["pml"].items()
                  if key[-1] != "0" or any(meta[(key[:-1], 0)])}
    return out, meta


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
                device, kernel: str = None,
                sharded: bool = False) -> Tuple[str, int]:
    """``(tier, k)`` of a run: ``("kstep", k)``, ``("fused", 1)`` or
    ``("pallas2", 1)``, decided from the plan alone (nothing is built or
    launched to find out). ``num_sources`` counts the source terms per
    family (``"E"``, ``"H"``); ``kernel`` defaults to ``TIDY3D_TPU_KERNEL``
    (``auto``). ``auto`` on a CUDA device takes kstep, then fused, then
    pallas2, as the JAX package does on the TPU; ``auto`` on the CPU takes
    fused, as the JAX package takes its XLA path off the TPU, so the CPU
    default keeps every-step monitor sampling. A complex (Bloch) plan takes
    kstep where the k-step kernel takes it (on every device) and pallas2
    otherwise (poles, modulation, a time monitor off the group ends, more
    source terms than its table): the fused kernel has no Bloch copies, as
    the JAX package's one-step kernels have none and it steps such plans on
    its XLA path. A nonlinear or modulated plan leaves kstep and fused,
    whose kernels leave no place for the passes between the E update and
    the pole update (``PallasFusedStepper.supported``), and takes pallas2.
    A ``sharded`` run takes kstep: only the k-step kernel has a shard-local
    mode. A forced tier that does not take the run raises, and so does a
    sharded plan that the kstep tier does not take. ``_check_supported``
    has already refused what no tier takes."""
    kernel = kernel or os.environ.get("TIDY3D_TPU_KERNEL", "auto") or "auto"
    # the CPU runs the plain versions, so the interpret modes are the tiers
    want = _KERNEL_ENV.get(kernel.removesuffix("_interpret"))
    if want is None:
        raise ValueError(f"TIDY3D_TPU_KERNEL={kernel!r}: the port has the "
                         "tiers " + ", ".join(sorted(_KERNEL_ENV)))
    if plan.is_complex and want == "fused":
        raise ValueError(f"TIDY3D_TPU_KERNEL={kernel}: the {want} tier has "
                         "no Bloch copies; complex runs take the kstep or "
                         "the pallas2 tier")
    if sharded and want not in ("auto", "kstep"):
        raise ValueError(f"TIDY3D_TPU_KERNEL={kernel}: the {want} tier has "
                         "no shard-local mode; sharded runs take the kstep "
                         "tier")
    only_kstep = want == "kstep" or sharded
    if only_kstep or (want == "auto" and (
            plan.is_complex or torch.device(device).type == "cuda")):
        reasons = [f"TIDY3D_TPU_KSTEP={os.environ.get('TIDY3D_TPU_KSTEP')}"
                   " disables it"] if not kstep_order() else []
        for k in kstep_order():
            reason = kstep_unsupported_reason(plan, k, num_sources)
            if reason is None:
                return "kstep", k
            reasons.append(f"k={k}: {reason}")
        if only_kstep:
            raise ValueError(f"TIDY3D_TPU_KERNEL={kernel}: the kstep tier "
                             f"does not take this run ({'; '.join(reasons)})")
    if plan.is_complex:
        return "pallas2", 1
    reason = fused_unsupported_reason(plan, num_sources)
    if want == "auto":
        return ("fused", 1) if reason is None else ("pallas2", 1)
    if want == "fused" and reason is not None:
        raise ValueError(f"TIDY3D_TPU_KERNEL={kernel}: the fused tier does "
                         f"not take this run ({reason})")
    return want, 1


def fused_unsupported_reason(plan: SimulationPlan,
                             num_sources: Dict[str, int]):
    """Why the fused tier does not take a real plan, or None if it does:
    nonlinear or modulated media (``PallasFusedStepper.supported``: the
    passes run between the E update and the pole update) and the kernel's
    own source-box cap (``fused.unsupported_reason``)."""
    if plan.nonlinear is not None or plan.modulation:
        return "nonlinear or time-modulated media"
    return fused_kernels.unsupported_reason(num_sources["E"])


def update_poles(new_e: dict, old_e: dict, Q: list, consts: dict) -> list:
    """The semi-implicit pole-current update (the port of
    ``FDTDRunner._update_poles``, ``fdtd.py:1145-1184``), in place on the
    ``(qr, qi)`` buffers of ``Q``, which it returns.

    ``Q' = A Q + B (E^{n+1} + E^n)`` per pole and component, with the
    complex products written out in real and imaginary parts as the
    reference writes them. ``E^{n+1} + E^n`` is formed once per component
    and its product with a support mask once per (mask, component), so the
    poles of one metal share them.

    Stored in bfloat16 (fields or currents), the update is
    ``_update_poles_stored``."""
    tensors = list(new_e.values()) + [t for Qp in Q for pair in Qp.values()
                                      for t in pair]
    if any(t.dtype != torch.float32 for t in tensors):
        return _update_poles_stored(new_e, old_e, Q, consts)
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


def _pole_currents(new_e: dict, old_e: dict, Q: list, consts: dict):
    """Yields ``(p, comp, qr', qi')``, the new currents of pole p, one
    component at a time, with the arithmetic of the reference's
    ``_update_poles`` (``fdtd.py:1145-1184``) as new tensors: ``A Q`` and
    its sum, and ``E^{n+1} + E^n``, at the state's types (a Python scalar
    keeps a tensor's type under PyTorch's promotion rules, as under JAX's);
    the float32 masks and residues promote the residue term, and the sum,
    to float32. ``E^{n+1} + E^n`` is formed once per component and its
    product with a support mask once per (mask, component)."""
    cache = {}
    for pi, ((A, _), metas, Qp) in enumerate(zip(
            consts["pole_scalars"], consts["pole_B_meta"], Q)):
        for ci, comp in enumerate(E_COMPS):
            qr, qi = Qp[comp]
            nqr = qr * A.real - qi * A.imag
            nqi = qr * A.imag + qi * A.real
            m = metas[ci]
            if m["kind"] != "zero":
                if ("e", ci) not in cache:
                    cache[("e", ci)] = new_e[comp] + old_e[comp]
                esum = cache[("e", ci)]
                if m["kind"] == "mask":
                    mkey = (m["mask_id"], ci)
                    if mkey not in cache:
                        cache[mkey] = consts["pole_masks"][m["mask_id"]] \
                            * esum
                    b_re, b_im = m["B0"]
                    if b_re:
                        nqr = nqr + b_re * cache[mkey]
                    if b_im:
                        nqi = nqi + b_im * cache[mkey]
                else:
                    b_re, b_im = consts["pole_B_dense"][f"{pi}_{ci}"]
                    nqr = nqr + b_re * esum
                    nqi = nqi + b_im * esum
            yield pi, comp, nqr, nqi


def _update_poles_stored(new_e: dict, old_e: dict, Q: list,
                         consts: dict) -> list:
    """``update_poles`` on bfloat16 fields and currents: the currents of
    ``_pole_currents``, each written back as soon as it is formed, rounded
    once more to its type, as ``_cast_state`` casts the carry."""
    for pi, comp, nqr, nqi in _pole_currents(new_e, old_e, Q, consts):
        qr, qi = Q[pi][comp]
        qr.copy_(nqr)
        qi.copy_(nqi)
    return Q


def pole_update(new_e: dict, old_e: dict, Q: list, consts: dict) -> list:
    """The pole-current update out of place, for the differentiable run
    and the fused step's plain version (float32 currents there): the new
    ``[{comp: (qr, qi)}]`` of ``_pole_currents``, ``Q`` left as it is."""
    out = [{} for _ in Q]
    for pi, comp, nqr, nqi in _pole_currents(new_e, old_e, Q, consts):
        out[pi][comp] = (nqr, nqi)
    return out


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
    out.update(post_e_to_device(consts, lambda v: _dev(v, device)))
    return out


class _Shard:
    """One x-slab of a sharded run: its index and device, its constants
    (padded x-slices of the run's), its ``StepMeta``, source tables and,
    per monitor, the slices of the monitor's cells that it owns, in its
    padded planes (only the components it owns any of)."""

    def __init__(self, index, device, consts, meta, tables, mon_slices):
        self.index = index
        self.device = device
        self.consts = consts
        self.meta = meta
        self.tables = tables
        self.mon_slices = mon_slices


def _owned(mp, slices: dict):
    """``(comp, slices)`` of the monitor's components in ``slices``."""
    return [(comp, slices[comp]) for comp in mp.comps if comp in slices]


def halo_arrays(state: dict) -> list:
    """The arrays of a shard's buffer set whose halo planes the ring
    exchange refreshes (``pallas_kstep.py:1386-1421``): E, H, the pole
    currents and the psi slabs of y and z, which span x (the x slabs, on
    the edge shards only, have no halo)."""
    out = list(state["E"].values()) + list(state["H"].values())
    for Qp in state["Q"]:
        for qr, qi in Qp.values():
            out += [qr, qi]
    out += [v for key, v in state["psi"].items() if key.split("|")[1] != "0"]
    return out


class FDTDRunner:
    """Runs the time-stepping loop of one ``SimulationPlan`` on ``device``.

    ``use_kernel=False`` steps with the plain PyTorch versions of the tier
    on any device; it exists so that the kernels can be held against them
    on the GPU. ``kernel`` overrides ``TIDY3D_TPU_KERNEL`` for this runner.
    ``sharding_plan`` runs the plan sharded over its mesh's devices, which
    must be of ``device``'s kind (see the module's docstring).
    """

    def __init__(self, plan: SimulationPlan, device="cuda",
                 precision: str = None, use_kernel: bool = True,
                 kernel: str = None, sharding_plan: ShardingPlan = None):
        _check_supported(plan, precision)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available")
        # single-axis y/z decompositions rotate onto the x slabs
        # (tidy3d_tpu/solver/fdtd.py:86-100); run() rotates the raw
        # monitors back
        self._plan_rot = 0
        # the decomposition asked for (before a rotation onto x)
        self.decomp = (1, 1, 1) if sharding_plan is None \
            else tuple(sharding_plan.decomp)
        if sharding_plan is not None:
            plan, sharding_plan = self._x_decomposition(plan, sharding_plan)
        self.sharding = sharding_plan
        self.plan = plan
        self.shape = tuple(plan.shape)
        self.num_steps = plan.num_steps
        self.use_kernel = use_kernel
        self.host_consts, self.pml_meta = build_constants(plan)
        sharded = sharding_plan is not None
        # a sharded run keeps its constants per shard (self.shards)
        self.consts = None if sharded else consts_to_device(
            self.host_consts, self.device)
        self.meta = StepMeta(
            shape=self.shape, boundaries=tuple(plan.boundaries),
            pml_meta=dict(self.pml_meta), bloch=bloch_phases(plan))
        self.is_complex = plan.is_complex
        # the state keys that a kstep group reads and writes
        self._group_keys = ("E", "H", "psi", "Q") + (
            kstep_kernels.COPIES[1] if self.is_complex else ())
        self._sources = {"E": [], "H": []}
        self._build_sources()
        self.tier, self.k = select_tier(plan, self.num_sources, self.device,
                                        kernel, sharded=sharded)
        # the storage types of the fields, the psi slabs and the pole
        # currents (compute is float32 everywhere)
        self.dtype, self.psi_dtype, self.q_dtype = storage_types(
            precision, self.tier)
        # monitors accumulate after group g only where (g + 1) % B == 0
        self.mon_group_stride = 1
        self.tables = None
        self.shards = None
        if self.tier == "kstep":
            self.host_consts["dft"] = build_dft_tables(plan, self.k)
            self.mon_group_stride = monitor_group_stride(plan, self.k)
            if sharded:
                self._build_shards()
            else:
                self.consts["dft"] = {
                    key: tuple(_dev(t, self.device) for t in tables)
                    for key, tables in self.host_consts["dft"].items()}
                self.tables = kstep_kernels.SourceTables(
                    self._sources, self._waveforms, self.shape, self.device)

    # ------------------------------------------------------------------ #
    # sharding
    # ------------------------------------------------------------------ #

    def _x_decomposition(self, plan, sharding_plan):
        """The plan and sharding plan of an x-only decomposition: a
        single-axis y or z one rotated onto x; refuses the rest."""
        d = sharding_plan.decomp
        devices = mesh_devices(sharding_plan.mesh)
        if any(torch.device(dv).type != self.device.type for dv in devices):
            raise ValueError(f"the mesh's devices {devices} are not all of "
                             f"the run's kind ({self.device.type})")
        if plan.is_complex:
            raise NotImplementedError(
                "sharded Bloch (complex) runs are not ported yet (the JAX "
                "package runs them on its GSPMD XLA path) (ROADMAP.md: "
                "sharded Bloch runs)")
        if d[0] == 1 and (d[1] > 1) != (d[2] > 1):
            self._plan_rot = 1 if d[1] > 1 else 2
            p = perm_for_rot(self._plan_rot)
            plan = rotate_plan(plan, self._plan_rot)
            sharding_plan = ShardingPlan(
                np.transpose(sharding_plan.mesh, p), plan.shape)
        elif d[1] > 1 or d[2] > 1:
            raise NotImplementedError(
                f"decomposition {d}: mixed 2D/3D decompositions are not "
                "ported yet (the JAX package runs them on its GSPMD XLA "
                "path) (ROADMAP.md: mixed 2D/3D decompositions)")
        return plan, sharding_plan

    def _build_shards(self):
        """The x-slab layout, each shard's constants on its device, its
        ``StepMeta``, its source tables and its monitor slices."""
        plan, k = self.plan, self.k
        devices = [torch.device(dv) for dv in
                   mesh_devices(self.sharding.mesh)]
        ndev = len(devices)
        reason = shard_unsupported_reason(self.shape, self.pml_meta, k, ndev)
        if reason is not None:
            raise ValueError(f"a sharded run over {ndev} x-slabs: {reason}")
        lay = self.layout = XSlabs(self.shape[0], ndev, k,
                                   plan.boundaries[0][0] == "periodic")
        self.shards = []
        for s, dev in enumerate(devices):
            hc, pml_meta = shard_constants(self.host_consts, self.pml_meta,
                                           lay, s)
            meta = StepMeta(
                shape=(lay.nx_loc,) + self.shape[1:],
                boundaries=tuple(plan.boundaries), pml_meta=pml_meta,
                bloch=bloch_phases(plan), xpad=k, x_halo=lay.halo(s))
            sources = {fam: [t._replace(term=t.term.to(dev)) for t in
                             kstep_kernels.shard_sources(
                                 terms, self.shape, lay.x0(s), lay.padded,
                                 k, lay.periodic)]
                       for fam, terms in self._sources.items()}
            tables = kstep_kernels.SourceTables(
                sources, self._waveforms, meta.array_shape, dev, x_origin=k)
            mon_slices = []
            for mp in plan.monitors:
                owned = {}
                for comp, sl in mp.slices.items():
                    rng = lay.owned_range(s, sl[0].start, sl[0].stop)
                    if rng is not None:
                        owned[comp] = (slice(*rng),) + tuple(sl[1:])
                mon_slices.append(owned)
            self.shards.append(_Shard(s, dev, consts_to_device(hc, dev), meta,
                                      tables, mon_slices))

    @property
    def devices(self) -> list:
        """The distinct devices the run steps on."""
        if self.shards is None:
            return [self.device]
        return list(dict.fromkeys(sh.device for sh in self.shards))

    def exchange_halos(self, states: list) -> None:
        """Refreshes the halo planes of each shard's buffer set in
        ``states`` from its neighbours' core edges, in place."""
        self.layout.exchange([halo_arrays(st) for st in states])

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
        one-step tiers of a real run)."""
        return [(s.comp, s.slices, s.term, float(self._waveforms[s.key, step]))
                for s in self._sources[family]]

    def _inject(self, family: str, fields: dict, step: int, part: int = 0):
        """Adds the source terms of ``family`` at ``step`` to copy ``part``,
        each rounded to the fields' type first, as the reference adds
        ``delta.astype(dtype)`` (``tidy3d_tpu/solver/fdtd.py:1522-1527``); a
        complex run's copy takes its part of each complex term
        (``kstep.complex_adds``, what the reference's per-plan deltas of
        that copy add, ``:1127-1143``)."""
        if self.is_complex:
            for comp, sl, *adds in kstep_kernels.complex_adds(
                    self._sources[family], self._waveforms, step):
                fields[comp][sl].add_(adds[part].to(fields[comp].dtype))
            return
        for comp, sl, term, w in self.step_sources(family, step):
            fields[comp][sl].add_((term * w).to(fields[comp].dtype))

    # ------------------------------------------------------------------ #
    # state
    # ------------------------------------------------------------------ #

    def psi_shapes(self, meta: StepMeta = None
                   ) -> Dict[str, Tuple[int, int, int]]:
        """psi slab shapes keyed ``"comp|axis|side"`` (XLA-path layout), of
        the run or of the shard whose ``meta`` is given (its y and z slabs
        span its padded x planes)."""
        meta = meta or self.meta
        shapes = {}
        for comp in E_COMPS + H_COMPS:
            fam = "dual" if comp[0] == "E" else "primal"
            i = "xyz".index(comp[1])
            for deriv_axis in ((i + 1) % 3, (i + 2) % 3):
                w_lo, w_hi = meta.pml_meta[(fam, deriv_axis)]
                for side, width in (("lo", w_lo), ("hi", w_hi)):
                    if width == 0:
                        continue
                    s = list(meta.array_shape)
                    s[deriv_axis] = width
                    shapes[f"{comp}|{deriv_axis}|{side}"] = tuple(s)
        return shapes

    def _fields(self, meta: StepMeta, device) -> dict:
        """Zero fields, psi slabs and pole currents (both copies of a
        complex run, ``Q1`` the second copy's currents) of the run or of
        one shard."""
        shape = meta.array_shape

        def zeros(s, dtype=self.dtype):
            return torch.zeros(s, dtype=dtype, device=device)

        out = {}
        # copy 1 of a complex run: the imaginary part, with its own pole
        # currents Q1 (tidy3d_tpu/solver/fdtd.py:816-821)
        for (e, h, p), q in zip(kstep_kernels.COPIES[:1 + self.is_complex],
                                Q_KEYS):
            out[q] = [{c: (zeros(shape, self.q_dtype),
                           zeros(shape, self.q_dtype)) for c in E_COMPS}
                      for _ in self.plan.poles]
            out[e] = {c: zeros(shape) for c in E_COMPS}
            out[h] = {c: zeros(shape) for c in H_COMPS}
            out[p] = {k: zeros(s, self.psi_dtype)
                      for k, s in self.psi_shapes(meta).items()}
        return out

    def init_state(self, device=None) -> dict:
        """The zero state; a sharded run's is ``{"shards": [...]}``, one
        state per shard, each with its own monitor parts. ``device``
        overrides the run's and every shard's device (``"meta"`` sizes the
        state without allocating it)."""
        if self.shards is not None:
            return {"shards": [dict(
                self._fields(sh.meta, device or sh.device),
                mon=[self._init_monitor_acc(mi, mp, sh.mon_slices[mi],
                                            device or sh.device)
                     for mi, mp in enumerate(self.plan.monitors)],
                alt=self._fields(sh.meta, device or sh.device))
                for sh in self.shards]}
        device = device or self.device
        state = self._fields(self.meta, device)
        state["mon"] = [self._init_monitor_acc(mi, mp, device=device)
                        for mi, mp in enumerate(self.plan.monitors)]
        if self.tier == "kstep":
            # the ping-pong set: each group reads one set and writes the
            # other (allocated once; the runner swaps them)
            state["alt"] = self._fields(self.meta, device)
        elif self.tier == "fused" and self.plan.poles:
            # the fused kernel's second pole-current set: neighbouring
            # blocks read Q while Q' is stored
            state["alt"] = {"Q": self._fields(self.meta, device)["Q"]}
        return state

    def _init_monitor_acc(self, mi, mp, slices: dict = None, device=None):
        """The accumulators of monitor ``mi`` over ``slices`` (default: the
        whole monitor)."""
        slices = mp.slices if slices is None else slices
        device = device or self.device
        acc = {}
        f32 = torch.float32
        if mp.kind == "field" and str(mi) in self.host_consts["dft"]:
            nf = len(mp.freqs)
            for comp, sl in _owned(mp, slices):
                s = tuple(s_.stop - s_.start for s_ in sl) + (nf,)
                acc[comp] = (torch.zeros(s, dtype=f32, device=device),
                             torch.zeros(s, dtype=f32, device=device))
        elif mp.kind == "field_time":
            n_samples = max(
                (mp.t_stop - mp.t_start + mp.t_interval - 1)
                // mp.t_interval, 1)
            for comp, sl in _owned(mp, slices):
                s = (n_samples,) + tuple(s_.stop - s_.start for s_ in sl)
                acc[comp] = torch.zeros(s, dtype=f32, device=device)
        return acc

    # ------------------------------------------------------------------ #
    # the step
    # ------------------------------------------------------------------ #

    def _family_update(self, family, views, srcs) -> list:
        """``[(new_fields, new_psi)]`` of ``family`` per copy (``views``,
        ``srcs``: each copy's state and source fields): the kernel, which
        takes both copies of a complex run in one launch, or the plain
        version copy by copy."""
        fn = step_kernels.family_update_copies if self.use_kernel \
            else step_kernels.family_update_copies_reference
        return fn(family, views, self.consts, srcs, self.meta)

    def _accumulate_monitors(self, step: int, newE, newH, mon, newE1=None,
                             newH1=None, dft: dict = None,
                             slices: list = None):
        """Running-DFT / time-sample accumulation on the fresh fields, in
        place on the accumulators of ``mon``. In a complex run ``newE1`` and
        ``newH1`` are copy 1: the DFT adds it rotated into both quadratures,
        ``(v0 + i v1) e^{i w t}`` (``tidy3d_tpu/solver/fdtd.py:1217-1223``),
        and time monitors record copy 0 only. A shard passes its own DFT
        tables (``dft``) and per monitor the slices it owns (``slices``)."""
        dft = self.consts["dft"] if dft is None else dft
        for mi, (mp, acc) in enumerate(zip(self.plan.monitors, mon)):
            key = str(mi)
            sls = mp.slices if slices is None else slices[mi]
            if mp.kind == "field" and key in dft:
                cos_e, sin_e, cos_h, sin_h = dft[key]
                ph = {"E": (cos_e[step], sin_e[step]),
                      "H": (cos_h[step], sin_h[step])}
                for comp, sl in _owned(mp, sls):
                    is_e = comp in E_COMPS
                    fields = newE if is_e else newH
                    vals = fields[comp][sl].unsqueeze(-1)
                    cos_t, sin_t = ph[comp[0]]
                    acc_re, acc_im = acc[comp]
                    acc_re.addcmul_(vals, cos_t)
                    acc_im.addcmul_(vals, sin_t)
                    if newE1 is not None:
                        vals1 = (newE1 if is_e else newH1)[comp][
                            sl].unsqueeze(-1)
                        acc_re.addcmul_(vals1, sin_t, value=-1.0)
                        acc_im.addcmul_(vals1, cos_t)
            elif mp.kind == "field_time":
                if not (mp.t_start <= step < mp.t_stop
                        and (step - mp.t_start) % mp.t_interval == 0):
                    continue
                idx = (step - mp.t_start) // mp.t_interval
                for comp, sl in _owned(mp, sls):
                    fields = newE if comp in E_COMPS else newH
                    acc[comp][idx].copy_(fields[comp][sl])
        return mon

    def step(self, step: int, state: dict) -> dict:
        """One leapfrog step from ``state`` on a one-step tier; the monitors
        accumulate in place. On ``pallas2`` the pole currents update in
        place; on ``fused`` the kernel writes them to the second set
        (``state["alt"]["Q"]``), which the returned state swaps in."""
        if self.tier == "kstep":
            raise ValueError("the kstep tier steps in groups of k "
                             "(run_steps, step_group)")
        if self.tier == "fused":
            sources = self.step_sources("E", step)
            if self.use_kernel:
                # Q' into the second pole-current set, which then swaps
                # with the first
                nE, nH, psi, Q = fused_kernels.fused_step(
                    state, self.consts, self.meta, sources,
                    q_out=state["alt"]["Q"] if "alt" in state else None)
            else:
                nE, nH, psi, Q = fused_kernels.fused_step_reference(
                    state, self.consts, self.meta, sources)
            self._inject("H", nH, step)
        else:
            return self._step_two_phase(step, state)
        with record_function("fdtd.monitors"):
            mon = self._accumulate_monitors(step, nE, nH, state["mon"])
        new = {"E": nE, "H": nH, "psi": psi, "Q": Q, "mon": mon}
        if "alt" in state:
            new["alt"] = {"Q": state["Q"]}
        return new

    def _views(self, state: dict) -> list:
        """Per copy, ``{"E", "H", "psi", "Q"}`` of ``state``: one for a real
        run, two (re, im) for a complex one (``FDTDRunner._views``)."""
        return [{"E": state[e], "H": state[h], "psi": state[p],
                 "Q": state[q]} for (e, h, p), q in
                zip(kstep_kernels.COPIES[:1 + self.is_complex], Q_KEYS)]

    def _step_two_phase(self, step: int, state: dict) -> dict:
        """One step on ``pallas2``, in the order of the reference's XLA
        ``_step`` (``tidy3d_tpu/solver/fdtd.py:1614-1723``): the E family of
        every copy (one call; a complex run's two copies in one launch),
        then per copy its J sources, the modulation and nonlinear passes
        (``fdtd.post_e``) and the pole update (Q1 for copy 1), then the H
        family of every copy from the new E, its M sources and the
        monitors (copy 1 rotated into the DFT)."""
        views = self._views(state)
        newE, newQ = [], []
        outs = self._family_update("E", views, [v["H"] for v in views])
        for p, (view, (nE, _)) in enumerate(zip(views, outs)):
            self._inject("E", nE, step, p)
            nE = self._post_e(nE, view["E"], step)
            newE.append(nE)
            newQ.append(self._update_poles(nE, view))
        psis = [dict(v["psi"], **pE) for v, (_, pE) in zip(views, outs)]
        outs = self._family_update("H", views, newE)
        newH = []
        for p, (nH, pH) in enumerate(outs):
            self._inject("H", nH, step, p)
            newH.append(nH)
            psis[p].update(pH)
        with record_function("fdtd.monitors"):
            mon = self._accumulate_monitors(
                step, newE[0], newH[0], state["mon"],
                *(newE[1:] + newH[1:]))
        new = {"mon": mon}
        for (e, h, p), q, nE, nH, psi, Q in zip(
                kstep_kernels.COPIES, Q_KEYS, newE, newH, psis, newQ):
            new.update({e: nE, h: nH, p: psi, q: Q})
        return new

    def _post_e(self, new_e: dict, old_e: dict, step: int) -> dict:
        """The modulation and nonlinear passes on one copy's E (``new_e``
        in place on a card's kernel, a new dict from the plain version)."""
        if not has_post_e(self.consts):
            return new_e
        with record_function("fdtd.post_e"):
            if self.use_kernel:
                return post_e_kernels.post_e(new_e, old_e, self.consts, step)
            return post_e_reference(new_e, old_e, self.consts, step)

    def _update_poles(self, new_e, view):
        if not view["Q"]:
            return view["Q"]
        with record_function("fdtd.poles"):
            return update_poles(new_e, view["E"], view["Q"], self.consts)

    def step_group(self, gi: int, state: dict, accumulate: bool = True
                   ) -> dict:
        """Group ``gi`` of the kstep tier: steps ``gi k`` to ``gi k + k -
        1`` in one launch of the k-step kernel (J and M sources, the pole
        update and the CPML of every substep inside), written to the
        ping-pong set, which becomes the state; the set read becomes the
        next ping-pong set. The monitors accumulate on the group-end fields
        at step ``gi k + k - 1`` when ``accumulate`` (the DFT tables are
        strided, so no sample lands elsewhere). A sharded run first
        exchanges the halos of the set it reads, then launches once per
        shard, then accumulates each shard's monitor parts."""
        k = self.k
        fn = kstep_kernels.kstep_group if self.use_kernel \
            else kstep_kernels.kstep_group_reference
        if self.shards is not None:
            states = state["shards"]
            with record_function("fdtd.halo_exchange"):
                self.exchange_halos(states)
            news = [fn(st, sh.consts, sh.meta, sh.tables, gi * k, k,
                       out=st["alt"]) for sh, st in zip(self.shards, states)]
            out = []
            for sh, st, new in zip(self.shards, states, news):
                if accumulate:
                    with record_function("fdtd.monitors"):
                        self._accumulate_monitors(
                            gi * k + k - 1, new["E"], new["H"], st["mon"],
                            dft=sh.consts["dft"], slices=sh.mon_slices)
                out.append(dict(new, mon=st["mon"], alt={
                    key: st[key] for key in self._group_keys}))
            return {"shards": out}
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
        are multiples of k and the steps run in groups. On the one-step
        tiers ``state`` is updated in place and returned."""
        if self.tier != "kstep":
            # in place, so that the set a step replaces is freed at once
            # and no more than two sets are ever held
            for n in range(num):
                state.update(self.step(start + n, state))
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
        ``pallas2``; a sharded run adds its decomposition, ``kstep (k=2,
        4 x-shards)``."""
        if self.tier != "kstep":
            return self.tier
        if self.shards is None:
            return f"kstep (k={self.k})"
        return f"kstep (k={self.k}, {len(self.shards)} x-shards)"

    @property
    def num_sources(self) -> Dict[str, int]:
        """The source terms per family (``"E"``, ``"H"``), as the tiers'
        source-table caps count them (a Bloch run's (re, im) pair is
        one)."""
        return {fam: len(terms) for fam, terms in self._sources.items()}

    @property
    def storage(self) -> Tuple[torch.dtype, ...]:
        """``(field, psi, q)``: the storage types of the run's state."""
        return self.dtype, self.psi_dtype, self.q_dtype

    def kernel_storages(self) -> list:
        """The storage types ``(field, psi, q)`` of the kernel libraries
        this run launches, as the wrappers read them from the state (a kind
        of which a state holds nothing takes the fields' type): one, or one
        per distinct shard."""
        state = self.init_state(device="meta")
        states = state["shards"] if self.shards is not None else [state]
        copies = kstep_kernels.COPIES[:1 + self.is_complex]
        return sorted({step_kernels.storage_of(st, copies) for st in states},
                      key=str)

    @property
    def storage_name(self) -> str:
        """The storage types as the run log names them: ``fields float32,
        psi bfloat16, Q float32``."""
        return ", ".join(f"{what} {type_name(dt)}" for what, dt in zip(
            ("fields", "psi", "Q"), self.storage))

    def _max_field(self, state) -> torch.Tensor:
        """The largest |E| over both copies of a complex run
        (``tidy3d_tpu/solver/fdtd.py:1765-1776``), over the owned planes of
        every shard of a sharded run (the ``lax.pmax`` at :1858)."""
        if self.shards is not None:
            dev = self.shards[0].device
            return torch.stack([
                self.layout.owned(st["E"][c]).abs().amax().float().to(dev)
                for st in state["shards"] for c in E_COMPS]).amax()
        return torch.stack([state[e][c].abs().amax().float() for c in E_COMPS
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
        pad_mod_tables(self.host_consts, extra)
        if self.consts is not None:
            pad_mod_tables(self.consts, extra)
        self.host_consts["dft"] = {
            k: tuple(np.pad(t, ((0, extra), (0, 0))) for t in tables)
            for k, tables in self.host_consts["dft"].items()}
        for consts, tables, dev in (
                [(self.consts, self.tables, self.device)]
                if self.shards is None else
                [(sh.consts, sh.tables, sh.device) for sh in self.shards]):
            consts["dft"] = {
                key: tuple(_dev(t, dev) for t in tabs)
                for key, tabs in self.host_consts["dft"].items()}
            if tables is not None:
                tables.set_waveforms(self._waveforms)

    def _raw_monitors(self, mon_parts: list) -> dict:
        """The raw monitor data (numpy) keyed by monitor-plan index from the
        accumulators of the run or, in x order, of its shards: a shard's
        DFT part covers its planes of axis 0, a time part those of axis
        1."""
        out = {}
        for idx, mp in enumerate(self.plan.monitors):
            parts = [mon[idx] for mon in mon_parts]
            mon = {}
            for comp in mp.comps:
                arrs = [p[comp] for p in parts if comp in p]
                if not arrs:
                    continue
                if mp.kind == "field":
                    re_ = np.concatenate([a[0].cpu().numpy() for a in arrs])
                    im_ = np.concatenate([a[1].cpu().numpy() for a in arrs])
                    mon[comp] = re_ + 1j * im_
                else:
                    mon[comp] = np.concatenate(
                        [a.cpu().numpy() for a in arrs], axis=1)
            out[idx] = mon
        if self._plan_rot:
            out = unrotate_raw(out, self.plan, self._plan_rot)
        return out

    def chunking(self) -> Tuple[int, int]:
        """``(chunk_size, num_chunks)`` of the time loop (chunks of whole
        kstep loop iterations on the kstep tier), with the waveform and DFT
        tables padded to the last chunk's end."""
        chunk_size = self.align_chunk(max(self.num_steps // NUM_CHUNKS, 1))
        num_chunks = (self.num_steps + chunk_size - 1) // chunk_size
        self._pad_time_tables(num_chunks * chunk_size)
        return chunk_size, num_chunks

    def run(self, verbose: bool = False) -> dict:
        """Execute the time loop; returns the raw monitor data (numpy) keyed
        by monitor-plan index, as ``tidy3d_tpu``'s runner does (in the
        original axes for a rotated decomposition)."""
        return self._run(None, 0, verbose)

    def run_checkpointed(self, checkpoint_path: str,
                         checkpoint_every: int = 5,
                         verbose: bool = False) -> dict:
        """Like ``run``, but saves the state every ``checkpoint_every``
        chunks (``save_checkpoint``) and resumes from ``checkpoint_path``
        when it exists; the file is deleted when the run ends, so that a
        finished run does not hijack the next one with a stale resume
        (``tidy3d_tpu/solver/fdtd.py:2003-2069``)."""
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every={checkpoint_every}: save "
                             "every 1 or more chunks")
        return self._run(checkpoint_path, checkpoint_every, verbose)

    def _run(self, checkpoint_path, checkpoint_every: int,
             verbose: bool) -> dict:
        plan = self.plan
        chunk_size, num_chunks = self.chunking()
        shutoff = float(plan.simulation.shutoff or 0.0)

        t0 = _time.perf_counter()
        if self.use_kernel:
            for dev in self.devices:
                for storage in self.kernel_storages():
                    {"kstep": kstep_kernels, "fused": fused_kernels,
                     "pallas2": step_kernels}[self.tier].prepare(dev, storage)
                    if has_post_e(self.host_consts):
                        post_e_kernels.prepare(dev, storage[0])
        self.compile_time = _time.perf_counter() - t0

        cuda_devices = [dev for dev in self.devices if dev.type == "cuda"]
        for dev in cuda_devices:
            torch.cuda.reset_peak_memory_stats(dev)
        self.checkpoint_save_s = self.checkpoint_load_s = 0.0
        start_time = _time.perf_counter()
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            state, ci, max_ever, cur = self.load_checkpoint(checkpoint_path)
            if verbose:
                log.info(f"resuming from {checkpoint_path} at chunk {ci}.")
        else:
            state, ci, max_ever, cur = self.init_state(), 0, 0.0, 0.0
        while ci < num_chunks:
            if shutoff > 0 and ci >= SHUTOFF_MIN_CHUNKS \
                    and cur < shutoff * max_ever:
                break
            state = self.run_steps(ci * chunk_size, chunk_size, state)
            cur = float(self._max_field(state).item())
            max_ever = float(np.maximum(max_ever, cur))
            ci += 1
            if checkpoint_path is not None and ci % checkpoint_every == 0 \
                    and ci < num_chunks:
                self.save_checkpoint(checkpoint_path, state, ci, max_ever,
                                     cur)
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            os.remove(checkpoint_path)
        for dev in cuda_devices:
            torch.cuda.synchronize(dev)
        self.wall_time = _time.perf_counter() - start_time
        # the peak of the allocated device memory since the loop began
        # (every tensor of the process that was live meanwhile counts)
        self.hbm_peak_bytes = max(
            (torch.cuda.max_memory_allocated(dev) for dev in cuda_devices),
            default=0)
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
        parts = [st["mon"] for st in state["shards"]] \
            if self.shards is not None else [state["mon"]]
        out = self._raw_monitors(parts)
        self.transfer_time = _time.perf_counter() - t1
        return out

    # ------------------------------------------------------------------ #
    # the differentiable run
    # ------------------------------------------------------------------ #

    def make_differentiable_run(self, num_steps: int = None,
                                checkpoint_chunks: int = None):
        """A reverse-mode differentiable run: ``fn(consts) -> (mon_out,
        final_state)`` (the port of ``fdtd.py:1908-1955``). ``consts`` is
        the runner's constant tree (``self.consts``, which this call gives
        the keys ``waveforms`` and ``src_profiles``, the reference's
        leaves of the source terms); any of its tensors may require grad.
        The loop runs ``num_steps`` (default: the plan's) in chunks of
        ``ceil(num_steps / checkpoint_chunks)`` steps (default
        ``NUM_CHUNKS`` chunks), each under ``torch.utils.checkpoint``, so
        that the backward pass holds one chunk's graph at a time and the
        states between chunks; the time tables are padded to the chunk
        grid. A step is ``_diff_step``, the plain out-of-place step of the
        ``pallas2`` tier: autograd, no kernel (``AUTODIFF_TIER``). There is
        no shutoff. ``mon_out`` holds, per monitor, each DFT accumulator
        pair stacked as one ``(2, ...)`` tensor (re, im) and each time
        monitor's samples. The DFT tables are the runner's own (every step
        on the one-step tiers, Nyquist-strided on the kstep tier)."""
        if self.shards is not None:
            raise NotImplementedError(
                "a differentiable sharded run is not ported (the JAX "
                "package differentiates unsharded runs only)")
        if self.is_complex:
            raise NotImplementedError(
                "a differentiable Bloch (complex) run is not ported yet "
                "(ROADMAP.md: autodiff on Bloch runs)")
        if self.storage != (torch.float32,) * 3:
            raise NotImplementedError(
                f"a differentiable run with storage {self.storage_name}: "
                "the autodiff route is float32 only (ROADMAP.md: autodiff "
                "in bfloat16)")
        num_steps = num_steps or self.num_steps
        chunk_size = -(-num_steps // (checkpoint_chunks or NUM_CHUNKS))
        num_chunks = -(-num_steps // chunk_size)
        self._pad_time_tables(num_chunks * chunk_size)
        self.consts["waveforms"] = torch.from_numpy(
            self._waveforms).to(self.device)
        self.consts["src_profiles"] = [
            _dev(np.asarray(np.real(p), np.float32), self.device)
            for p in self.host_consts["src_profiles"]]
        self.checkpoint_chunks = (chunk_size, num_chunks)

        def chunk(start, state, consts):
            for n in range(chunk_size):
                state = self._diff_step(start + n, state, consts)
            return state

        def run_fn(consts):
            init = self.init_state()
            state = {key: init[key] for key in ("E", "H", "psi", "Q", "mon")}
            for ci in range(num_chunks):
                # a step draws no random numbers: no RNG state to keep
                state = torch.utils.checkpoint.checkpoint(
                    chunk, ci * chunk_size, state, consts,
                    use_reentrant=False, preserve_rng_state=False)
            mon_out = [{comp: torch.stack(arr) if isinstance(arr, tuple)
                        else arr for comp, arr in acc.items()}
                       for acc in state["mon"]]
            return mon_out, state

        return run_fn

    def _diff_step(self, step: int, state: dict, consts: dict) -> dict:
        """One step out of place, in the order of the reference's XLA
        ``_step`` (``fdtd.py:1614-1723``): the plain E family, the J
        sources, the modulation and nonlinear passes, the pole update, the
        plain H family, the M sources and the monitors; a new state,
        ``state`` left as it is. The families are
        ``family_update_reference`` in float32, which builds new tensors."""
        def family(name, src_fields):
            return step_kernels.family_update_reference(
                name, state, consts, src_fields, self.meta, store=False)

        nE, psi_E = family("E", state["H"])
        nE = self._add_sources("E", nE, step, consts)
        if has_post_e(consts):
            nE = post_e_reference(nE, state["E"], consts, step)
        Q = pole_update(nE, state["E"], state["Q"], consts)
        nH, psi_H = family("H", nE)
        nH = self._add_sources("H", nH, step, consts)
        psi = dict(state["psi"], **psi_E, **psi_H)
        mon = self._accumulate(step, nE, nH, state["mon"], consts)
        return {"E": nE, "H": nH, "psi": psi, "Q": Q, "mon": mon}

    def _add_sources(self, family: str, fields: dict, step: int,
                     consts: dict) -> dict:
        """The fields with the current sources of ``family`` at ``step``
        added out of place, each ``-c_b profile w(t)`` from ``consts`` (the
        reference's ``_source_deltas``, ``fdtd.py:1127-1143``)."""
        comps = E_COMPS if family == "E" else H_COMPS
        coeffs = consts["coeffs_E" if family == "E" else "coeffs_H"]
        out = dict(fields)
        for si, sp in enumerate(self.plan.sources):
            if sp.comp not in comps or sp.waveform_key is None:
                continue
            _, cb = coeffs[sp.comp]
            cb_sl = cb[sp.slices] if torch.is_tensor(cb) and cb.ndim else cb
            delta = -cb_sl * consts["src_profiles"][si] \
                * consts["waveforms"][sp.waveform_key, step]
            new = out[sp.comp].clone()
            new[sp.slices] = new[sp.slices] + delta
            out[sp.comp] = new
        return out

    def _accumulate(self, step: int, nE: dict, nH: dict, mon: list,
                    consts: dict) -> list:
        """``_accumulate_monitors`` out of place: new DFT accumulators
        ``acc + vals * cos`` (and ``sin``), time samples by
        ``index_copy``."""
        dft = consts["dft"]
        out = []
        for mi, (mp, acc) in enumerate(zip(self.plan.monitors, mon)):
            if mp.kind == "field" and str(mi) in dft:
                cos_e, sin_e, cos_h, sin_h = dft[str(mi)]
                ph = {"E": (cos_e[step], sin_e[step]),
                      "H": (cos_h[step], sin_h[step])}
                new = {}
                for comp, sl in _owned(mp, mp.slices):
                    vals = (nE if comp in E_COMPS else nH)[comp][
                        sl].unsqueeze(-1)
                    cos_t, sin_t = ph[comp[0]]
                    re, im = acc[comp]
                    new[comp] = (re + vals * cos_t, im + vals * sin_t)
                out.append(new)
            elif mp.kind == "field_time" and mp.t_start <= step < mp.t_stop \
                    and (step - mp.t_start) % mp.t_interval == 0:
                idx = torch.tensor([(step - mp.t_start) // mp.t_interval],
                                   device=self.device)
                out.append({comp: acc[comp].index_copy(
                    0, idx, (nE if comp in E_COMPS else nH)[comp][
                        sl].unsqueeze(0))
                    for comp, sl in _owned(mp, mp.slices)})
            else:
                out.append(acc)
        return out

    # ------------------------------------------------------------------ #
    # checkpoint / resume
    # ------------------------------------------------------------------ #

    def _checkpoint_meta(self) -> dict:
        """The run's identity in a checkpoint: a file of another grid,
        tier, k, decomposition or storage types is refused."""
        return {"__version__": np.asarray(CHECKPOINT_VERSION),
                "__grid_shape__": np.asarray(self.shape),
                "__tier__": np.asarray(self.tier),
                "__k__": np.asarray(self.k),
                "__decomp__": np.asarray(self.decomp),
                "__storage__": np.asarray([type_name(dt)
                                           for dt in self.storage])}

    def save_checkpoint(self, path: str, state: dict, chunk_idx: int,
                        max_ever: float, cur: float) -> int:
        """Writes the state (fields, psi, pole currents and monitor
        accumulators of the run or of every shard; not the kstep tier's
        ping-pong set) and the loop position to ``path`` atomically (a
        ``.tmp`` file, then ``os.replace``). Arrays are named by their
        place in the state (``E.Ex``, ``Q.0.Ex.re``, ``mon.3.Hy.im``,
        ``shards.1.psi.Ex|1|lo``), beside the run's identity
        (``_checkpoint_meta``), ``__chunk_idx__``, ``__max_ever__`` and
        ``__cur__`` (the last chunk's field maximum, which the shutoff test
        reads). A bfloat16 tensor is saved as its bits (``int16``). Returns
        the file's bytes."""
        t0 = _time.perf_counter()
        arrays = {name: _to_numpy_bits(t) for name, t in _named(state)}
        arrays.update(self._checkpoint_meta())
        arrays["__chunk_idx__"] = np.asarray(chunk_idx)
        arrays["__max_ever__"] = np.asarray(max_ever)
        arrays["__cur__"] = np.asarray(cur)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
        self.checkpoint_save_s = getattr(self, "checkpoint_save_s", 0.0) \
            + _time.perf_counter() - t0
        return os.path.getsize(path)

    def load_checkpoint(self, path: str):
        """``(state, chunk_idx, max_ever, cur)`` from a file that
        ``save_checkpoint`` wrote for a run of this grid, tier, k and
        decomposition (``SetupError`` otherwise); the state is this
        runner's ``init_state()`` with every saved array copied in."""
        t0 = _time.perf_counter()
        with np.load(path) as data:
            for key, want in self._checkpoint_meta().items():
                got = data[key] if key in data.files else None
                if got is None or got.shape != want.shape \
                        or np.any(got != want):
                    raise SetupError(
                        f"Checkpoint at '{path}' was written for "
                        f"{key.strip('_')} "
                        f"{None if got is None else got.tolist()}, but "
                        f"this run has {want.tolist()}: refusing to "
                        "resume.")
            state = self.init_state()
            names = set()
            for name, t in _named(state):
                if name not in data.files:
                    raise SetupError(f"Checkpoint at '{path}' holds no "
                                     f"array '{name}': refusing to resume.")
                arr = data[name]
                if tuple(arr.shape) != tuple(t.shape):
                    raise SetupError(
                        f"Checkpoint at '{path}': '{name}' has shape "
                        f"{arr.shape}, this run {tuple(t.shape)}: refusing "
                        "to resume.")
                t.copy_(_from_numpy_bits(arr, t.dtype))
                names.add(name)
            extra = [n for n in data.files
                     if not n.startswith("__") and n not in names]
            if extra:
                raise SetupError(f"Checkpoint at '{path}' holds arrays this "
                                 f"run does not have ({extra[:3]}): "
                                 "refusing to resume.")
            out = (state, int(data["__chunk_idx__"]),
                   float(data["__max_ever__"]), float(data["__cur__"]))
        self.checkpoint_load_s = getattr(self, "checkpoint_load_s", 0.0) \
            + _time.perf_counter() - t0
        return out

    # ------------------------------------------------------------------ #
    # device memory
    # ------------------------------------------------------------------ #

    def _resident(self) -> list:
        """``(device, tensors)`` of what the runner holds on each device
        for the whole run: the constants, the source terms and tables."""
        def tables(t):
            return [] if t is None else [t.boxes, t.terms, t.wf]

        out = [(self.device, [self._sources])]
        if self.shards is None:
            return out + [(self.device, [self.consts, tables(self.tables)])]
        return out + [(sh.device, [sh.consts, tables(sh.tables)])
                      for sh in self.shards]

    def _pole_work(self, cells: int) -> int:
        """Bytes of the ``pallas2`` tier's pole-update temporaries
        (``update_poles``): the sum E' + E of each component with a
        residue (at the fields' type), each (mask, component) product
        (float32) and the rotation temporaries: one float32 field in
        place, and in bfloat16 (``_update_poles_stored``) the new re and
        im currents, float32 at most, with two bfloat16 products."""
        comps, masks = set(), set()
        for metas in self.host_consts["pole_B_meta"]:
            for ci, m in enumerate(metas):
                if m["kind"] != "zero":
                    comps.add(ci)
                if m["kind"] == "mask":
                    masks.add((m["mask_id"], ci))
        if not self.plan.poles:
            return 0
        e = torch.empty((), dtype=self.dtype).element_size()
        rot = 4 if self.q_dtype == torch.float32 else 2 * 4 + 2 * 2
        return cells * (e * len(comps) + 4 * len(masks) + rot)

    def estimate_device_memory(self) -> dict:
        """Bytes this run holds on each device (the port of
        ``FDTDRunner.estimate_device_memory``, counted per device: the
        shards of a mesh that names one device several times all count on
        it). Components, for the most loaded device:

        * ``consts``: the constants, source terms and tables, as held;
        * ``state``: fields, psi, pole currents, monitor accumulators and
          the second buffer set (the kstep tier's ping-pong set; on the
          one-step tiers the E, H and psi that each step allocates while
          the old ones are live, and on the fused tier the second
          pole-current set), halo planes excepted;
        * ``halo``: the k halo planes on each side of a shard's arrays;
        * ``work``: a step's temporaries: on the ``pallas2`` tier the plain
          pole update's (``_pole_work``), else one field for the field
          maximum;
        * ``margin``: half of state and halo plus 256 MiB, as the
          reference keeps;

        and ``total``, their sum; ``devices`` holds the same dict for every
        device. The state is sized on the ``meta`` device: nothing is
        allocated. The time tables are first padded to the last chunk, as
        the run holds them (``chunking``)."""
        self.chunking()
        keys = ("consts", "state", "halo", "work", "margin")
        per: Dict[str, dict] = {}

        def add(dev, key, n):
            per.setdefault(str(torch.device(dev)), dict.fromkeys(keys, 0))[
                key] += int(n)

        for dev, objs in self._resident():
            add(dev, "consts", _nbytes(objs))
        state = self.init_state(device="meta")
        shards = state["shards"] if self.shards is not None else [state]
        devices = [sh.device for sh in self.shards] \
            if self.shards is not None else [self.device]
        padded = self.layout.padded if self.shards is not None else None
        for dev, st in zip(devices, shards):
            if self.tier != "kstep":
                # a one-step tier: the E, H and psi of the next step, beside
                # the fused tier's second pole-current set
                st = dict(st, alt=dict(st.get("alt", {}), **{
                    key: st[key] for key in ("E", "H", "psi", "E1", "H1",
                                             "psi1") if key in st}))
            for _, t in _named(st, skip=()):
                n = t.numel() * t.element_size()
                halo = n * 2 * self.k // padded \
                    if padded and t.ndim == 3 and t.shape[0] == padded else 0
                add(dev, "state", n - halo)
                add(dev, "halo", halo)
            cells = int(np.prod(st["E"]["Ex"].shape))
            add(dev, "work", self._pole_work(cells) if self.tier == "pallas2"
                and self.plan.poles else st["E"]["Ex"].element_size() * cells)
        for d in per.values():
            d["margin"] = (d["state"] + d["halo"]) // 2 + MARGIN_BYTES
            d["total"] = sum(d[key] for key in keys)
        worst = max(per, key=lambda name: per[name]["total"])
        return dict(per[worst], device=worst, devices=per)

    def check_memory_budget(self) -> dict:
        """Raises ``SetupError`` before anything is launched when a
        device's estimate exceeds its limit (the port of
        ``FDTDRunner.check_memory_budget``): ``TIDY3D_TPU_HBM_BYTES`` when
        set, else the CUDA device's total memory; a CPU device is not
        checked, as the JAX package checks no platform but the TPU.
        ``TIDY3D_TPU_MEM_CHECK=0`` turns the check off. Returns the
        estimate (None when off)."""
        if os.environ.get("TIDY3D_TPU_MEM_CHECK", "1") == "0":
            return None
        env_limit = os.environ.get("TIDY3D_TPU_HBM_BYTES")
        est = self.estimate_device_memory()
        for name, d in est["devices"].items():
            dev = torch.device(name)
            if env_limit:
                limit = int(float(env_limit))
            elif dev.type == "cuda":
                limit = torch.cuda.get_device_properties(dev).total_memory
            else:
                continue
            if d["total"] > limit:
                gib = 1 << 30
                raise SetupError(
                    f"Simulation needs an estimated {d['total'] / gib:.2f} "
                    f"GiB of device memory on {name} (constants "
                    f"{d['consts'] / gib:.2f} + state {d['state'] / gib:.2f}"
                    f" + halo planes {d['halo'] / gib:.2f} + step "
                    f"temporaries {d['work'] / gib:.2f} + working margin "
                    f"{d['margin'] / gib:.2f}) but the device limit is "
                    f"{limit / gib:.2f} GiB. Reduce the grid/monitor "
                    "footprint, or shard the run over more devices "
                    "(TIDY3D_TPU_SHARD=auto).")
        return est


def _named(tree, prefix: str = "", skip=("alt",)):
    """``(name, tensor)`` of every tensor in a state, named by its place:
    dict keys and list indices joined by dots, a ``(re, im)`` pair's parts
    ``re`` and ``im``; keys in ``skip`` are left out."""
    if isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree
        return
    if isinstance(tree, dict):
        items = [(k, v) for k, v in tree.items() if k not in skip]
    elif isinstance(tree, tuple) and len(tree) == 2:
        items = zip(("re", "im"), tree)
    else:
        items = enumerate(tree)
    for key, value in items:
        yield from _named(value, f"{prefix}{key}.", skip)


def _to_numpy_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy: a bfloat16 one as its bits in ``int16``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _from_numpy_bits(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The tensor that ``_to_numpy_bits`` saved as ``arr``, of ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype == torch.bfloat16:
        if t.dtype != torch.int16:
            raise SetupError(f"a bfloat16 array saved as {t.dtype}")
        return t.view(torch.bfloat16)
    if t.dtype != dtype:
        raise SetupError(f"a {dtype} array saved as {t.dtype}")
    return t


def _nbytes(obj) -> int:
    """Bytes of every tensor in nested dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    return 0
