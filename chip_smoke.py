"""Drives the PyTorch/CUDA port once on one GPU and checks it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. the card's name and power limit, the torch and CUDA versions;
2. build the seven kernel sources (``tidy3d_tpu_torch/csrc/step.cu``,
   ``fused.cu``, ``kstep.cu``, ``post_e.cu`` and the labs' ``lab_step.cu``,
   ``lab_kstep.cu``, ``lab_pole.cu``) and phase 28's bf16 variants of the
   first three (six libraries) with nvcc for sm_90a, one nvcc process
   each, started together, and print their register and spill reports; for every instantiation of the k-step kernel (0 to 8 pole slots
   and Bloch, each bulk and shell) its registers, spills and blocks of 512
   threads per SM (the CUDA occupancy calculator); the same for the
   family kernel's E and H and the fused kernel's 0, 1, 2 and 7 pole-slot
   instantiations, each bulk and shell, float32 and bf16, and the SASS
   instruction classes and loads by width of their bulk march loops (the
   bf16 loops must load bf16 pairs as 32-bit words, no 16-bit load); and
   the registers, spills and blocks per SM of the family kernel's two-copy
   (Bloch) E and H and pole-table E instantiations, the fused kernel's
   pole-table ones (each bulk and shell) and post_e's;
3. the family-update kernel against its plain PyTorch version for one E and
   one H half-step, on a 64x48x80 random state (PML on every axis, PEC and
   PMC walls, per-cell coefficients), on the same grid with a Lorentz pole
   (the E update's pole term) and on a random state of the full-size grid,
   to 1e-6 of the largest magnitude; kernel and plain times per launch at
   the full size (CUDA events) and the blocks of its bulk and shell
   launches;
4. 200 steps of the full-size broadband-DFT case (384^3 cells with CPML,
   an 11-frequency field monitor and flux box) on the two-phase tier, with
   the kernel and with the plain versions, timed in turns plain, kernel,
   kernel, plain; the fields must agree to 2e-5;
5. the fused one-step kernel (the pole update inside) against its plain
   version for one step, on the 64x48x80 grid with a Lorentz pole and on
   the full-size dispersive case (384^3, a one-pole Lorentz half-space),
   E', H', psi' and Q' each to 1e-6; kernel and plain times per step at
   384^3 (CUDA events) beside the bound (Q' stored, the residues read), and
   the broadband case's kernel time;
6. 200 steps on the fused tier, kernel against plain versions, in turns
   plain, kernel, kernel, plain, on the 384^3 dispersive case and on the
   280^3 7-pole Au half-space, fields and pole currents to 2e-5 (one step
   of the Au case to 1e-6 first, and its kernel time);
7. the k-step kernel against its plain version for one group of k = 2
   steps, on the 64x48x80 grid with a Lorentz pole, on the 384^3 broadband
   and dispersive cases and on the 280^3 Au case (7 poles), to 1e-6; kernel
   and plain ms per group and per step (CUDA events) beside the fused
   kernel (plus the plain pole update), the ratio to the group's bound, the
   bulk and shell blocks (two device launches a group), registers and
   blocks per SM; 200 steps on the kstep tier, kernel against plain in
   turns, on the broadband, the dispersive and the Au case, to 2e-5;
8. torch.profiler windows of 20 steps: device time of the two-phase tier on
   the broadband case, of the fused tier on the dispersive case split into
   the fused kernel, the pole-update ops and the DFT/source ops (the fused
   window must hold no ``fdtd.poles`` range: the kernel updates the
   poles), and of the kstep tier on the dispersive case; the device's busy
   share (the union of its events' intervals, overlapping kernels once,
   over the unprofiled step time);
9. ``tidy3d_tpu_torch.web.run``, each path with the launch counts set to 0
   just before it and read just after: the broadband case on the two-phase
   tier (2 family launches per step), the dispersive and the broadband case
   forced to the fused tier (one fused launch per step), then both on the
   default tier, the kstep tier (one k-step call per group of k steps, its
   device launches one per non-empty block list, no fused or family
   launch); the flux must be finite and non-zero, and on
   the kstep tier within 2e-2 of the fused tier's (a strided DFT against an
   every-step one); throughput and peak device memory of each;
10. Bloch (complex) runs, two real copies of the fields on the kstep tier:
    the JAX package's ``fdtd_bloch`` bench case (256^3 cells, Bloch x and
    y, a PML z, an eps = 8 slab, an Ez dipole) with the broadband case's
    field plane and flux box: the Bloch instantiation of the k-step kernel
    against its plain version for one group (to 1e-6 over both copies),
    kernel and plain ms per group, the ratio to the bound, registers and
    blocks per SM, 200 steps kernel against plain in turns
    (to 2e-5), a 20-step profiler window; and the angled plane wave (256^3,
    a PML x, Bloch y from a 25-degree plane wave, periodic z), one group
    against plain;
11. ``web.run`` of both Bloch cases, the launch counts set to 0 just before
    each: one k-step launch per group and no other, throughput, peak
    memory, a finite non-zero flux, and for the plane wave the physical
    checks of the JAX package's ``test_angled_plane_wave_bloch`` (forward
    amplitude within 1 % of 1, backward below 1e-2 of it);
12. sharded runs, x-slabs on virtual shards of the one card (a mesh that
    names it four times): the 384^3 dispersive case split (4, 1, 1), 96
    planes per shard, the x-CPML in shards 0 and 3, the Lorentz Q in the
    halo exchange, the dipole's boxes reaching two shards: one group of the
    shard-local k-step kernel against its plain version and against the
    unsharded kernel on the same random state (to 1e-6), the group's
    CUDA-event time split into the exchange and each shard's launch, the
    host's enqueue time, the ratio to the bound, registers and blocks per
    SM, 200 steps sharded against unsharded in turns (to
    2e-5); on several visible cards the same group on distinct devices,
    otherwise a line that says it was not run;
13. the 1-shard ring (``bench.py``'s ``fdtd_sharded``): the broadband case
    on a (1, 1, 1) mesh, the halos exchanged onto itself, against the
    unsharded runner, 200 steps in turns: ms per step and the ratio;
14. the sharded main path, its launch counts set to 0 just before it: a
    full-length run of the broadband case over 4 x-shards through
    ``FDTDRunner`` with an explicit ``ShardingPlan``, then the port's
    ``SimulationData`` builders; raw monitors against the unsharded run (to
    2e-5), kstep calls equal to 4 per group (each shard's bulk and shell
    lists a device launch each) and no other kernel's,
    Gcell*steps/s and peak device memory;
15. a (1, 2, 1) decomposition of the broadband case, rotated onto x,
    against the unsharded run (to 2e-5);
16. ``web.run`` of the waveguide (384^3 at dl = 0.02 um: a Si strip in
    SiO2, a mode source of mode 0, on one 2 x 2 um plane a mode monitor of
    2 modes and 11 frequencies, a mode-solver monitor and a flux monitor,
    a permittivity monitor on z = 0) on the default tier, launch counts
    set to 0 just before and read just after: k-step launches only; every
    mode solve (the source's in ``lower()``, the monitors') under
    ``TIDY3D_TPU_MODE_SOLVER=auto``, so on the card's filter, with no
    fallback to ARPACK, their host seconds beside phase 26's ARPACK and
    filter seconds of the mode monitor's solve; the
    forward mode-0 power within 5 % of the flux through the plane,
    ``|a+|^2 - |a-|^2`` within 1 % of it (the reference's backward
    amplitude is a grid artifact here, ``labs/builder_grid_error.py``),
    the backward amplitude below the forward one, the permittivity
    plane equal to ``plan.eps_yee``; Gcell*steps/s, peak memory and the
    host seconds of the mode solves, then the same case with the flux
    plane only (the cost of the new monitors);
17. ``web.run`` of the broadband case with a 4 um projection box around
    its Ez dipole: |E_theta| isotropic in phi at theta = pi/2 (max/min
    below 1.1) and within 10 % of sin(theta) from 30 to 150 degrees (the
    reference's projection has a first-order grid error,
    ``labs/builder_grid_error.py``); the host seconds of the projection;
    then the case without and with the box once more, Gcell*steps/s in
    turns against phase 9's run;
18. ``web.run`` of the angled plane wave (the two-copy k-step kernel) with
    a diffraction plane ahead of the source: the (0, 0) order holds more
    than 98 % of the diffracted power and the total is within 0.1 of 1
    (the bar of the JAX package's ``test_diffraction_vacuum_zero_order``);
    then without and with the plane once more, in turns against phase 11;
19. checkpoint and resume: the 384^3 dispersive case on the kstep tier and
    on 4 virtual x-shards, and the Bloch dipole: an uninterrupted run, half
    of the chunks in a fresh runner through ``run_steps`` and
    ``save_checkpoint``, the rest in a third runner through
    ``run_checkpointed``; raw monitors to 1e-6 of the largest magnitude;
    the file's bytes and its save and load seconds;
20. a short ``web.run`` of the broadband case under
    ``TIDY3D_TPU_PROFILE`` in a process of its own: the trace file holds
    the k-step kernel's records and ``fdtd.monitors`` ranges;
21. memory: every main-path run's ``estimate_device_memory()`` beside its
    measured peak (``hbm_peak_bytes``, less what was allocated before it;
    the 4-shard run of phase 14 included), each estimate at least the peak;
    then ``TIDY3D_TPU_HBM_BYTES`` one byte below the far-field run's
    estimate: ``web.run`` raises ``SetupError`` with no launch;
22. the labs' main paths (``tidy3d_tpu_torch.labs``), each with its launch
    counts set to 0 just before it and read just after: ``kernel_lab.main``
    (n = 384, bx 4 and 8, ``LAB_BF16=1``), ``kernel_lab2.main`` (k = 1 to
    4, bx = 8, f32 and bf16) and ``pole_lab.main`` (all six variants);
    every kernel and variant must have launched;
23. the step lab's kernel against its plain version on random 384^3
    fields, bx = 8 and 4, curl, noroll and copy in f32 (to 1e-6) and bf16
    (to 1e-2: every operation rounds to bf16, one ulp is 2^-8 of a value),
    and the stencil variants at n = 15 (odd: cell by cell) and 40 (32
    does not divide it) with bx = 1, 5 and 8 where it divides n; kernel ms
    per step at bx = 8 and 4, plain ms, and for copy one
    ``torch._foreach_copy_`` of the 6 fields; the copy bit-identical to
    plain, its 16-byte vectors and, on 15^3 fields, its scalar tail; each
    stencil instantiation's threads, registers, bytes spilled, shared
    bytes and blocks per SM, and the SASS classes of its march loop (the
    bf16 loop must hold bf16x2 arithmetic and no conversion);
24. the k-step lab's kernel against its plain version on random 384^3
    fields, bx = 8 and 4, k = 1 to 4, f32 (to 1e-6) and bf16 storage (to
    1e-2: one rounding at the store), every plane compared, the clamped
    edge windows included; kernel ms per group and per step (bx = 8, and
    bx = 4), plain ms per group, the ratio to the bound, registers, shared
    memory, threads and blocks per SM of each instantiation and the
    march's x chunks;
25. each pole-lab kernel against its plain version at the lab's size (24
    x 64 x 128 cells, R = 600, GRID = 16), all 16 copies of the output
    equal: the kernel contracts ``a * b + c`` into one FMA where the plain
    version rounds twice, up to 1.5 ulp of a carry a step; the tolerance
    (``pole_lab.kernel_tolerance``) is about 4x the error measured on
    these inputs: 3e-4 for ``vpu_peak``'s chains (measured 7.4e-5), 5e-4
    for ``fma_peak``'s (1.3e-4), 1e-5 for the carries damped by 0.999
    (``pole_chan`` 2.8e-7, ``pole_packed`` 1.9e-6), 1e-2 for the bf16
    ``pole_chan``; ``curl_mix`` grows ~1.8x a repeat on a window that
    varies in y or z, so it is compared on the lab's constant window at R
    = 600 and on a random one at R = 40 (to 1.5 x 2^-23 a repeat); kernel
    ms and TFLOP/s under the lab's flop model, plain ms and ptxas's
    registers; for ``pole_chan_bf16`` the ratio to the bound and to twice
    the bound (one bf16 operation a lane and instruction, since nothing
    contracts) and the SASS instruction classes of its repeat loop
    (``cuobjdump -sass``), which must hold bf16x2 arithmetic and no
    conversion; for ``curl_mix`` (the six fields in registers, one block
    a window plane, no cluster) its threads, registers, bytes spilled
    (must be 0), shared bytes and blocks per SM, and the SASS classes of
    its repeat loop, whose shared loads and stores must be the edge rows'
    only (6 of each, 16 bytes);
26. (run before phase 16) the device mode solver
    (``plugins/mode/device_solver.py``: the Chebyshev-filtered subspace
    iteration, float32 matmuls on the card without TF32, each degree
    bucket of the filter one captured CUDA graph) forced by
    ``TIDY3D_TPU_MODE_SOLVER=filter`` on the card against ARPACK on the
    host, on the waveguide's source plane (100 x 100, 2N = 20000) and on
    a 200 x 200 plane of the same strip at dl = 0.01 um (2N = 80000), 2
    modes at 1.55 um: n_eff within 2e-5 and each mode's Ex and Ey overlap
    with ARPACK's above 0.999 (the bars of the JAX package's
    ``tests/test_plugins/test_mode_tpu.py``), no fallback; each route's
    host seconds, the filter's outer iterations, final degree, passes and
    the split of its seconds (device loop, basis fetch, host float64
    polish, refinement); one filter pass on the solve's own operator,
    eager and as a graph, at degrees 50 and 200 (CUDA events), the ATen
    operations a pass dispatches and the kernels the profiler records;
    then the mode monitor's 11-frequency solve by both routes (the
    filter's 11 solves may leave at most 64 MiB allocated);
27. ``web.Job(...).run()`` of the 64x48x80 mixed case with the broadband
    DFT monitors, launch counts set to 0 just before and read just after:
    the launches and the flux of ``web.run`` of the same case;
28. (run after phase 9) bf16 storage: each bf16 library's build seconds
    and registers and spills, the blocks per SM of the family and fused
    kernels (float32 and bf16) and of every k-step instantiation in the
    four bf16 combinations (psi; Q; psi and Q; all
    three); each bf16 kernel against its bf16 plain version, to 1e-2 of the
    largest magnitude (both round once where they store; a product the
    kernel contracts into an FMA may move a stored value by one bf16 step),
    with the share of bit-equal values: one family half-step (E and H) at
    64x48x80 and 384^3, one fused step on the 384^3 dispersive case (Q'
    included), one
    k-step group on the 384^3 broadband and dispersive cases, on the 280^3
    7-pole Au case with the pole state alone in bf16, on the 256^3 Bloch
    dipole and on 4 virtual x-shards of the dispersive case; kernel and
    plain ms and the bound at the bf16 bytes; 200 k-step steps of the
    dispersive case in bf16, kernel against plain in turns (to 1e-2);
    ``TIDY3D_TPU_HBM_BYTES`` between the bf16 and the float32 estimate of
    the dispersive case: the float32 ``web.run`` raises ``SetupError`` with
    no launch, the bf16 one (``TIDY3D_TPU_PRECISION=bfloat16``, the default
    tier) runs with k-step launches only, its flux within 5e-2 of phase 9's
    float32 flux, its Gcell*steps/s and peak memory beside float32's; then
    short bf16 ``web.run``s (launch counts set to 0 just before each, read
    just after) of the 64x48x80 mixed case on the two-phase and the fused
    tier, of the Bloch dipole, and of the mixed case with the pole state
    alone in bf16 on the kstep tier, and 20 steps of the 4-shard bf16
    runner;
29. (run after phase 21) inverse design on the card
    (``plugins/invdes``, ``plugins/adjoint``, ``web/autograd.py``), the
    launch counts set to 0 just before and read just after: (a) the
    production route on a waveguide-offset problem of the waveguide's
    materials (``invdes_case``: 274 x 204 x 104 cells at dl = 0.02 um, a
    100 x 100 x 12 design region, eps in [2.085, 12.1], a mode source and
    a one-frequency mode monitor, the default shutoff): the adjoint
    gradient at density 0.5, then 3 ``AdamOptimizer`` steps, each two
    ``web.run`` solves that must take the k-step tier and the region's
    conic filter, tanh projection and erosion-dilation penalty (with their
    gradients) on the card; the region's transformation and penalty, with
    their gradients, on the card against the CPU within 1e-3 of max, and
    timed; per iteration the
    host seconds of the forward run, the adjoint run, the mode solves, the
    objective's VJP and the gradient assembly, each run's ``kernel tier:``
    line, source terms, Gcell*steps/s and peak memory; the objective must
    rise; the gradient against central differences of two more
    ``web.run``s along the uniform direction (within 20 %) and of two on
    an 8 x 8 cell block over the whole depth at the largest |g| (within
    10 %); only k-step launches; (b) the 2D coupling case of
    ``tests/test_plugins/test_adjoint_invdes.py`` (108 x 85 x 1 cells):
    the adjoint gradient on the card against the CPU, both forced to the
    k-step tier, and ``TopologyObjective.value_and_grad`` (autograd, no
    kernel: no launch) on the card against the CPU, each within 1e-3 of
    max |g|; the autodiff gradient against central differences at the
    largest pixel (within 2 %); the autodiff route's ms per forward and
    backward step, its peak memory and the garbage collections in the
    timed window at 20 and 5 checkpoint chunks (``run_autodiff_timing``
    times the same alone, in a process of its own);
30. (run after phase 28) ``web.run`` under the default tier of the 384^3
    dispersive case with a point Ez field-time monitor at the dipole
    (interval 1, default start) and a flux-time monitor on its flux box
    (interval 10)
    (``timemonitor_case``), the launch counts set to 0 just before and
    read just after: the log's tier is ``fused`` (the samples miss the
    k-step group ends), one fused call a step and no family or k-step
    launch; both time series finite and non-zero; the DFT flux within
    2e-2 of phase 9's k-step run; Gcell*steps/s, peak memory and the
    estimate, at least the peak;
31. (run after phase 30) ``bloch_metal_case``, an Au grating on a Cr
    layer over SiO2 (13 pole slots) under an oblique plane wave, Bloch x
    and y, 192 x 192 x 512 cells: the default tier is pallas2; the family
    kernel's two-copy instantiation against its plain version for one E
    and H update of both copies and one whole step (1e-6), its ms beside
    its bound; 200 steps in turns on the stack cut to 128 cells of depth
    (2e-5, both copies' fields and Q, Q1); ``web.run``: 2 family calls a
    step, each one two-copy call, no fused or k-step launch, the probe's
    time series finite and non-zero, the estimate at least the peak; the
    step split by CUDA events into the family calls, the pole update and
    the sources and monitors;
32-33. the broadband case with a 4 um Kerr + two-photon-absorption block
    (and a point Ez probe at the dipole) and with a block whose
    permittivity and conductivity are modulated: pallas2 under ``auto``;
    post_e against its plain version (1e-6) and one whole step, post_e's
    ms beside its bound and the eager plain version's; 200 steps in turns
    (2e-5); the step split by CUDA events (family, post_e, sources and
    monitors); ``web.run``, one post_e call a step; the Kerr term B E^2 at
    the dipole at least 1e-3;
34. ``many_poles_case``, Au on a Cr layer (13 slots, real) at 280^3:
    forced fused and forced pallas2, one step against the plain versions
    (1e-6), the pole-table fused step's and family launch's ms beside
    their bounds, 200 steps of each in turns on the stack cut to 96 cells
    of depth (2e-5); ``web.run`` under ``auto`` (a default-start time
    probe): the fused tier, one pole-table call a step; a short forced
    pallas2 ``web.run``: a pole-table family call a step;
35. the JAX package's Kerr phase shift, two-photon absorption, chi3 =
    Kerr and modulation sideband tests (2D, through ``web.run`` on the
    card) with their own asserts (``physics_checks``);
36. the JSON summary lines; the last line is the contract line. Each
    kernel's ``bound_ms`` is the least time the card could take for the
    call timed in ``ms``: the larger of the bytes of its inputs and outputs
    (each once) over 3.35 TB/s and the operations its function needs over
    the peak for their type, 67 TFLOP/s float32 and 133.8 TFLOP/s bf16
    (the H100 SXM's published peaks at 700 W; the pole lab's operations
    are ``pole_lab.ops``, fewer than its flop model counts); the
    sharded group's bytes are the unsharded group's plus the halo planes
    each exchange reads and writes. No single PyTorch call computes an FDTD
    step or a lab kernel's function, so ``library_ms`` is null, but for the
    step lab's copy variant (``torch._foreach_copy_``). The k-step entries
    also carry the registers and blocks per SM of their bulk and shell
    instantiations, the family and fused entries those of theirs and the
    SASS of their bulk march loops, the k-step lab's entries their registers, shared
    bytes, threads, blocks per SM and x chunks, the step lab's stencil
    entries and ``curl_mix``'s their resources and SASS classes, and
    ``pole_chan_bf16``'s its SASS classes. The bf16 entries (phase 28)
    carry the share of their values bit-equal to the plain version's.

It needs a CUDA device and exits non-zero without one. The profiler tables
go to the ``OUT_DIR`` directory.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

import numpy as np
import torch

# the card's peaks, the roofline bound, CUDA-event timing and nvidia-smi
from tidy3d_tpu_torch.labs._common import (PEAK_BF16, PEAK_F32, bound,
                                           cuda_ms, nvidia_smi)

N_FULL = 360            # cells per side inside the PML (384^3 with it)
N_METAL = 256           # the Au case: 280^3 with the PML
N_BLOCH = 256           # the Bloch cases: 256^3 cells, the PML included
STEPS_COMPARE = 200
NPROF = 20
TOL_UPDATE = 1e-6
TOL_STEPS = 2e-5
TOL_FLUX = 2e-2         # a strided DFT against an every-step one
# a bf16 kernel against its bf16 plain version, relative to the largest
# magnitude: both round once at the same stores, and where one contracts a
# product into an FMA the other rounds twice, which may move a stored value
# by one bf16 step (2^-8 of it at most)
TOL_BF16 = 1e-2
TOL_BF16_FLUX = 5e-2    # a bf16 run's flux against the float32 run's
TOL_BF16 = 1e-2         # bf16 storage: one bf16 ulp is 2^-8 of a value
TOL_RESUME = 1e-6       # a resumed run against an uninterrupted one
TOL_MODE_FLUX = 5e-2    # forward mode-0 power against the plane's flux
# |a+|^2 - |a-|^2 against the plane's flux: the backward amplitude of the
# reference's overlap is a grid artifact of ~0.12 of the forward one here
# (labs/builder_grid_error.py), which this identity holds to
TOL_BALANCE = 1e-2
# |E_theta| / sin(theta): the reference's projection reads E and H half a
# cell apart across each surface, an error of order k dl = 0.2 at dl =
# 0.05 um that halves with dl (labs/builder_grid_error.py)
TOL_PATTERN = 0.1
# the device mode solver against ARPACK on the host: n_eff and the field
# overlap of each mode (tests/test_plugins/test_mode_tpu.py:57,62)
TOL_NEFF = 2e-5
MIN_OVERLAP = 0.999
N_LAB = 384             # the step labs' default n
OUT_DIR = "chiprun_out"
CKPT_DIR = os.path.join("build", "chip_smoke_ckpt")   # git-ignored
# (what, estimate, peak, allocated before the run) of every main-path run
MEMORY = []
# float32 operations per cell update, as the kernels write them: per
# component two differences times inverse steps, their difference and
# ca * F + cb * rhs (8); per psi cell b * psi + c * d and its add (4); per
# pole and E component the term Re(Gc Q) (4) and the update A Q + B (E' +
# E) (12)
OPS_FAMILY = 24
OPS_PSI = 4
OPS_POLE = 16


LOG_FILE = []   # the open log file under OUT_DIR, once main has one


def log(msg: str) -> None:
    """Prints ``msg`` and appends it to ``chip_smoke_log.txt`` under
    ``OUT_DIR`` (the whole log, where the output keeps only its end)."""
    print(msg, flush=True)
    for fh in LOG_FILE:
        fh.write(msg + "\n")
        fh.flush()


STAMPS = {}     # phase -> seconds since the start of main, where it began
T0 = time.perf_counter()


def stamp(phase: str) -> None:
    STAMPS[phase] = round(time.perf_counter() - T0, 1)


def sync() -> None:
    torch.cuda.synchronize()


# --------------------------------------------------------------------------- #
# cases
# --------------------------------------------------------------------------- #


def mixed_dft_case(td, dispersive: bool = False):
    """``mixed_case`` with the broadband case's field plane and flux box at
    11 frequencies around 1.55 um."""
    freqs = np.linspace(td.C_0 / 1.55 * 0.95, td.C_0 / 1.55 * 1.05,
                        11).tolist()
    sim = mixed_case(td, dispersive)
    return sim.copy(update=dict(monitors=_dft_monitors(td, sim.size, freqs)))


def _dft_monitors(td, size, freqs):
    return [
        td.FieldMonitor(center=(0, 0, 0),
                        size=(size[0] * 0.6, size[1] * 0.6, 0),
                        freqs=freqs, name="field"),
        td.FluxMonitor(center=(0, 0, 0), size=(size[0] * 0.4,) * 3,
                       freqs=freqs, name="flux"),
    ]


def full_case(td):
    """The broadband running-DFT case: 360^3 cells inside a 12-layer CPML,
    an Ez dipole, an 11-frequency field plane and flux box, no shutoff."""
    freq0 = td.C_0 / 1.55
    dl = 0.05
    size = (N_FULL * dl,) * 3
    freqs = np.linspace(freq0 * 0.95, freq0 * 1.05, 11).tolist()
    return td.Simulation(
        center=(0, 0, 0), size=size, run_time=1.8e-13,
        sources=[td.PointDipole(
            center=(0, 0, 0), polarization="Ez",
            source_time=td.GaussianPulse(freq0=freq0, fwidth=freq0 / 8))],
        monitors=_dft_monitors(td, size, freqs),
        boundary_spec=td.BoundarySpec.all_sides(td.PML()),
        grid_spec=td.GridSpec.uniform(dl=dl), shutoff=0.0)


def lorentz(td):
    freq0 = td.C_0 / 1.55
    return td.Lorentz(eps_inf=2.0, coeffs=[(8.0, freq0 * 1.8, freq0 / 10)])


def dispersive_case(td):
    """The broadband case with a one-pole Lorentz medium filling the upper
    half of the domain and the dipole below it (the ``fdtd_combined``
    shape of the JAX package's benchmark)."""
    sim = full_case(td)
    size = sim.size
    return sim.copy(update=dict(
        sources=[sim.sources[0].copy(update=dict(
            center=(0, 0, -size[2] / 4)))],
        structures=[td.Structure(
            geometry=td.Box(center=(0, 0, size[2] / 4),
                            size=(size[0], size[1], size[2] / 2)),
            medium=lorentz(td))]))


def timemonitor_case(td):
    """Phase 30's case: the dispersive case with a point field-time monitor
    (Ez at the dipole, every step from the default start) and a flux-time
    monitor on its flux box (every 10th step from the default start: the
    host builder took 93 s over every step's 3.9 GB), the time probes of a
    resonance search and a time-domain flux; their samples miss the k-step
    tier's group ends."""
    sim = dispersive_case(td)
    flux = next(m for m in sim.monitors if m.name == "flux")
    return sim.copy(update=dict(monitors=list(sim.monitors) + [
        td.FieldTimeMonitor(center=sim.sources[0].center, size=(0, 0, 0),
                            fields=["Ez"], interval=1, name="probe"),
        td.FluxTimeMonitor(center=flux.center, size=flux.size,
                           interval=10, name="flux_time")]))


def metal_case(td):
    """The 7-pole Au (Rakic/Brendel-Bormann fit) half-space through the
    PML, 256^3 cells inside a 12-layer CPML, an Ez dipole below it."""
    freq0 = td.C_0 / 1.55
    dl = 0.05
    size = (N_METAL * dl,) * 3
    return td.Simulation(
        center=(0, 0, 0), size=size, run_time=1e-11,
        sources=[td.PointDipole(
            center=(0, 0, -size[2] / 4), polarization="Ez",
            source_time=td.GaussianPulse(freq0=freq0, fwidth=freq0 / 8))],
        structures=[td.Structure(
            geometry=td.Box(center=(0, 0, size[2] / 2),
                            size=(td.inf, td.inf, size[2])),
            medium=td.material_library["Au"]["RakicBrendelBormann1998"])],
        boundary_spec=td.BoundarySpec.all_sides(td.PML()),
        grid_spec=td.GridSpec.uniform(dl=dl), shutoff=0.0)


def bloch_case(td):
    """The JAX package's ``fdtd_bloch`` bench case (``bench.py:192-224``):
    256 x 256 x (232 + 24 PML) cells at dl = 0.0625, Bloch x (0.27) and y
    (-0.13), an eps = 8 slab, an Ez dipole; with the broadband case's
    11-frequency field plane and flux box added, and ``run_time`` cut from
    1e-11 to 1.8e-13 (1,500 steps)."""
    freq0 = td.C_0 / 1.55
    dl = 0.0625
    size = (N_BLOCH * dl, N_BLOCH * dl, (N_BLOCH - 24) * dl)
    freqs = np.linspace(freq0 * 0.95, freq0 * 1.05, 11).tolist()
    return td.Simulation(
        center=(0, 0, 0), size=size, run_time=1.8e-13,
        sources=[td.PointDipole(
            center=(0.12, -0.08, -size[2] / 5), polarization="Ez",
            source_time=td.GaussianPulse(freq0=freq0, fwidth=freq0 / 8))],
        structures=[td.Structure(
            geometry=td.Box(center=(0, 0, 0),
                            size=(td.inf, td.inf, size[2] / 4)),
            medium=td.Medium(permittivity=8.0))],
        monitors=_dft_monitors(td, size, freqs),
        boundary_spec=td.BoundarySpec(
            x=td.Boundary.bloch(bloch_vec=0.27),
            y=td.Boundary.bloch(bloch_vec=-0.13),
            z=td.Boundary.pml()),
        grid_spec=td.GridSpec.uniform(dl=dl), shutoff=0.0)


def planewave_case(td):
    """(232 + 24 PML) x 256 x 256 cells at dl = 0.05: an Ez plane wave
    along +x at 25 degrees in y, Bloch y from the source
    (``BlochBoundary.from_source``), periodic z; 11-frequency flux planes
    behind and ahead of the source and point field monitors at f0, 2 um
    ahead and 1 um behind it (the set-up of the JAX package's
    ``test_angled_plane_wave_bloch``)."""
    freq0 = td.C_0 / 1.55
    dl = 0.05
    # rounded, so that the mesher counts 232 cells and not 233
    size = (round((N_BLOCH - 24) * dl, 9), N_BLOCH * dl, N_BLOCH * dl)
    x_src = -size[0] / 2 + 2.0
    pw = td.PlaneWave(
        center=(x_src, 0, 0), size=(0, td.inf, td.inf), direction="+",
        source_time=td.GaussianPulse(freq0=freq0, fwidth=freq0 / 5),
        pol_angle=np.pi / 2, angle_theta=np.deg2rad(25.0))
    bloch = td.BlochBoundary.from_source(source=pw, domain_size=size[1],
                                         axis=1)
    freqs = np.linspace(freq0 * 0.95, freq0 * 1.05, 11).tolist()

    def plane(x, name):
        return td.FluxMonitor(center=(x, 0, 0), size=(0, td.inf, td.inf),
                              freqs=freqs, name=name)

    def point(x, name):
        return td.FieldMonitor(center=(x, 0.3, 0), size=(0, 0, 0),
                               freqs=[freq0], name=name)

    return td.Simulation(
        center=(0, 0, 0), size=size, run_time=1.5e-13, sources=[pw],
        monitors=[plane(x_src + 2.5, "flux"), plane(x_src - 1.5, "flux_back"),
                  point(x_src + 2.0, "fwd"), point(x_src - 1.0, "bwd")],
        boundary_spec=td.BoundarySpec(
            x=td.Boundary.pml(), y=td.Boundary(minus=bloch, plus=bloch),
            z=td.Boundary.periodic()),
        grid_spec=td.GridSpec.uniform(dl=dl), shutoff=0.0)


def mixed_case(td, dispersive: bool = False):
    """64x48x80 cells: PML on every axis, PEC and PMC walls, a dielectric
    box (per-cell ca/cb), and with ``dispersive`` a Lorentz box."""
    freq0 = td.C_0 / 1.55
    dl = 0.05
    structures = [td.Structure(
        geometry=td.Box(center=(0.1, 0, 0), size=(1.0, 0.8, 1.2)),
        medium=td.Medium(permittivity=3.0, conductivity=0.01))]
    if dispersive:
        structures.append(td.Structure(
            geometry=td.Box(center=(-0.6, 0.3, 0.5), size=(1.2, 1.0, 1.0)),
            medium=lorentz(td)))
    return td.Simulation(
        center=(0, 0, 0), size=(52 * dl, 36 * dl, 56 * dl), run_time=1e-14,
        sources=[td.PointDipole(
            center=(0, 0, 0), polarization="Ez",
            source_time=td.GaussianPulse(freq0=freq0, fwidth=freq0 / 8))],
        structures=structures,
        boundary_spec=td.BoundarySpec(
            x=td.Boundary(minus=td.PML(), plus=td.PECBoundary()),
            y=td.Boundary(minus=td.PMCBoundary(), plus=td.PML()),
            z=td.Boundary.pml()),
        grid_spec=td.GridSpec.uniform(dl=dl), shutoff=0.0)


def waveguide_case(td, monitors: bool = True):
    """360^3 cells inside a 12-layer CPML (384^3) at dl = 0.02 um: a Si
    strip (eps 12.1, 0.5 x 0.22 um) along x in SiO2 (eps 2.085), a mode
    source of mode 0 at x = -3 um; on the 2 x 2 um plane at x = +3 um a
    mode monitor (2 modes, 11 frequencies around 1.55 um), a mode-solver
    monitor (2 modes at 1.55 um) and a flux monitor, and a permittivity
    monitor on the z = 0 plane. Without ``monitors``: the flux plane only.
    The default shutoff (1e-5) ends the run once the pulse has left."""
    freq0 = td.C_0 / 1.55
    dl = 0.02
    size = (N_FULL * dl,) * 3
    freqs = np.linspace(freq0 * 0.95, freq0 * 1.05, 11).tolist()
    plane = dict(center=(3.0, 0, 0), size=(0, 2.0, 2.0))
    mons = [td.FluxMonitor(**plane, freqs=freqs, name="flux")]
    if monitors:
        spec = td.ModeSpec(num_modes=2)
        mons += [
            td.ModeMonitor(**plane, freqs=freqs, mode_spec=spec, name="mode"),
            td.ModeSolverMonitor(**plane, freqs=[freq0], mode_spec=spec,
                                 name="modes"),
            td.PermittivityMonitor(center=(0, 0, 0),
                                   size=(size[0], size[1], 0),
                                   freqs=[freq0], name="eps")]
    return td.Simulation(
        center=(0, 0, 0), size=size, run_time=4e-13,
        medium=td.Medium(permittivity=2.085),
        structures=[td.Structure(
            geometry=td.Box(center=(0, 0, 0), size=(td.inf, 0.5, 0.22)),
            medium=td.Medium(permittivity=12.1))],
        sources=[td.ModeSource(
            center=(-3.0, 0, 0), size=(0, 2.0, 2.0), direction="+",
            source_time=td.GaussianPulse(freq0=freq0, fwidth=freq0 / 10),
            mode_spec=td.ModeSpec(num_modes=1), mode_index=0)],
        monitors=mons, boundary_spec=td.BoundarySpec.all_sides(td.PML()),
        grid_spec=td.GridSpec.uniform(dl=dl))


def fine_plane_case(td):
    """The waveguide's strip at dl = 0.01 um for a 200 x 200 mode plane of
    2 x 2 um (2N = 80000): a simulation built for its grid, not run."""
    sim = waveguide_case(td, monitors=False)
    return sim.copy(update=dict(
        size=(1.0, 2.4, 2.4), sources=[], monitors=[],
        grid_spec=td.GridSpec.uniform(dl=0.01)))


FAR_THETA = np.deg2rad(np.arange(30, 151, 10))
FAR_PHI = np.linspace(0, 2 * np.pi, 8, endpoint=False)


def farfield_case(td):
    """The broadband case with a field-projection box of 4 um around the
    dipole: |E_theta| at 13 polar angles (30 to 150 degrees) and 8
    azimuths, at 1.55 um."""
    sim = full_case(td)
    far = td.FieldProjectionAngleMonitor(
        center=(0, 0, 0), size=(4.0, 4.0, 4.0), freqs=[td.C_0 / 1.55],
        name="far", theta=FAR_THETA, phi=FAR_PHI)
    return sim.copy(update=dict(monitors=list(sim.monitors) + [far]))


def diffraction_case(td):
    """The angled plane wave with a diffraction plane on its forward flux
    plane, at 1.55 um."""
    sim = planewave_case(td)
    x = sim.monitors[0].center[0]
    diff = td.DiffractionMonitor(
        center=(x, 0, 0), size=(0, td.inf, td.inf), freqs=[td.C_0 / 1.55],
        name="diff", normal_dir="+")
    return sim.copy(update=dict(monitors=list(sim.monitors) + [diff]))


INVDES_STEPS = 3         # Adam steps of phase 29
INVDES_LR = 0.05
TOL_FD_UNIFORM = 0.2     # tests/test_plugins/test_adjoint_invdes.py:86-87
TOL_FD_BLOCK = 0.1
TOL_FD_PIXEL = 0.02      # the autodiff route's bar in the JAX package's test
TOL_CARD_CPU = 1e-3      # of max |g|: one tier on the card and on the CPU
FD_BLOCK = (8, 8)        # x, y cells of the block FD, the whole depth in z
INVDES_SHAPE = (100, 100, 12)   # the design region's cells
INVDES_RADIUS = 0.1      # um: the conic filter's radius, 11 cells an axis
INVDES_BETA = 2.0        # the tanh projection's strength
INVDES_PENALTY = 0.01    # the erosion-dilation penalty's weight
CHUNKS = (20, 5)         # checkpoint chunk counts of the autodiff timing


def invdes_case(td):
    """The waveguide's materials as a waveguide-offset problem (5.0 x 3.6 x
    1.6 um at dl = 0.02 um in a 12-layer PML: 274 x 204 x 104 = 5.8 M
    cells): the Si input strip (eps 12.1, 0.5 x 0.22 um) along x at y = 0
    up to x = -1 um, the output strip from x = +1 um at y = +0.5 um, in
    SiO2 (eps 2.085); a mode source of mode 0 on the input at x = -2 um, a
    one-frequency mode monitor (1.55 um) on the output at x = +2 um; the
    default shutoff. The design region is ``invdes_region``."""
    freq0 = td.C_0 / 1.55
    plane = dict(size=(0, 2.0, 1.4))
    strip = dict(size=(4.0, 0.5, 0.22))
    si = td.Medium(permittivity=12.1)
    return td.Simulation(
        center=(0, 0, 0), size=(5.0, 3.6, 1.6), run_time=3e-13,
        medium=td.Medium(permittivity=2.085),
        structures=[
            td.Structure(geometry=td.Box(center=(-3.0, 0, 0), **strip),
                         medium=si),
            td.Structure(geometry=td.Box(center=(3.0, 0.5, 0), **strip),
                         medium=si)],
        sources=[td.ModeSource(
            center=(-2.0, 0, 0), **plane, direction="+",
            source_time=td.GaussianPulse(freq0=freq0, fwidth=freq0 / 10),
            mode_spec=td.ModeSpec(num_modes=1), mode_index=0)],
        monitors=[td.ModeMonitor(
            center=(2.0, 0.5, 0), **plane, freqs=[freq0],
            mode_spec=td.ModeSpec(num_modes=1), name="out")],
        boundary_spec=td.BoundarySpec.all_sides(td.PML()),
        grid_spec=td.GridSpec.uniform(dl=0.02))


def invdes_region(td_invdes):
    """The 2.0 x 2.0 x 0.22 um design region between the strips (100 x 100
    x 12 cells: the strips' z faces lie inside the edge cells), eps in
    [2.085, 12.1]; its parameters go through a conic filter of radius
    ``INVDES_RADIUS`` and a tanh projection of strength ``INVDES_BETA``,
    with the erosion-dilation penalty at weight ``INVDES_PENALTY``."""
    return td_invdes.TopologyDesignRegion(
        center=(0, 0.24, 0), size=(2.0, 2.0, 0.22), eps_bounds=(2.085, 12.1),
        radius=INVDES_RADIUS, beta=INVDES_BETA, penalty_weight=INVDES_PENALTY)


def coupling_case(td):
    """The 2D coupling case of ``tests/test_plugins/test_adjoint_invdes.py``
    (108 x 85 x 1 cells, 724 steps): an Ez dipole, an eps 4 strip and a
    one-mode monitor at 1.5 um; its design region is ``coupling_region``,
    eps in [1, 6]."""
    f0 = td.C_0 / 1.5
    return td.Simulation(
        center=(0, 0, 0), size=(5, 3.6, 0), run_time=1e-13,
        sources=[td.PointDipole(
            center=(-1.4, 0, 0),
            source_time=td.GaussianPulse(freq0=f0, fwidth=f0 / 6),
            polarization="Ez")],
        monitors=[td.ModeMonitor(
            center=(1.8, 0, 0), size=(0, 2.6, td.inf), freqs=[f0],
            name="out", mode_spec=td.ModeSpec(num_modes=1,
                                              target_neff=2.0))],
        structures=[td.Structure(
            geometry=td.Box(center=(1.55, 0, 0), size=(1.7, 0.4, td.inf)),
            medium=td.Medium(permittivity=4.0))],
        shutoff=0.0,
        boundary_spec=td.BoundarySpec(x=td.Boundary.pml(),
                                      y=td.Boundary.pml(),
                                      z=td.Boundary.periodic()),
        grid_spec=td.GridSpec.uniform(dl=0.06))


def coupling_region(td) -> dict:
    """The center and size of the coupling case's design region (21 x 31 x
    1 cells)."""
    return dict(center=(-0.1, 0, 0), size=(1.2, 1.8, td.inf))


def fd_block(g: np.ndarray, size=FD_BLOCK) -> tuple:
    """The slices of the ``size`` x-y block, over the whole z depth, centred
    on the largest |g| of the x-y map of |g| summed over z, moved inside
    the array where it would cross an edge."""
    col = np.abs(g).sum(axis=2)
    ix, iy = np.unravel_index(np.argmax(col), col.shape)
    out = []
    for i, n, w in ((ix, col.shape[0], size[0]), (iy, col.shape[1], size[1])):
        lo = min(max(i - w // 2, 0), n - w)
        out.append(slice(lo, lo + w))
    return tuple(out) + (slice(None),)


def log_rate(lines: list) -> float:
    """Gcell*steps/s of a ``web.run`` log."""
    return float(log_field(lines, "throughput: ").split()[0])


def random_state(runner, seed: int) -> dict:
    """Random fields, psi and pole currents; each pole's currents scaled by
    1/|Gc| so that its term is of the order of the curl."""
    gen = torch.Generator(device=runner.device).manual_seed(seed)
    state = runner.init_state()

    def rnd(t):
        return torch.randn(t.shape, generator=gen, device=t.device,
                           dtype=t.dtype)

    for fam in ("E", "H", "E1", "H1"):
        if fam in state:
            state[fam] = {c: rnd(v) for c, v in state[fam].items()}
    for fam in ("psi", "psi1"):
        if fam in state:
            state[fam] = {k: 0.1 * rnd(v) for k, v in state[fam].items()}
    for key in ("Q", "Q1"):
        if key in state:
            state[key] = [{c: (rnd(qr) / abs(Gc), rnd(qi) / abs(Gc))
                           for c, (qr, qi) in Qp.items()}
                          for (_, Gc), Qp in zip(
                              runner.consts["pole_scalars"], state[key])]
    return state


def nbytes(*objs) -> int:
    """Bytes of every tensor in nested dicts, lists and tuples."""
    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, dict):
            total += nbytes(*o.values())
        elif isinstance(o, (list, tuple)):
            total += nbytes(*o)
    return total


def numel(d: dict) -> int:
    return sum(v.numel() for v in d.values())


def stepping_consts(runner) -> list:
    """The constants a step reads: coefficients, inverse steps, CPML
    vectors and pole residues."""
    c = runner.consts
    return [c["coeffs_E"], c["coeffs_H"], c["inv_dual"], c["inv_primal"],
            c["pml"], c["pole_masks"], c["pole_B_dense"]]


def group_work(runner, state, k: int):
    """``(bytes, operations)`` of one k-step group: every array of the
    state (both copies of a complex run) and the constants read once, the
    new state written once; k steps of both families, their psi and pole
    updates."""
    fields = [state[key] for key in ("E", "H", "psi", "Q", "E1", "H1",
                                     "psi1") if key in state]
    ncell = int(np.prod(runner.shape))
    copies = 2 if "E1" in state else 1
    psi = sum(numel(state[key]) for key in ("psi", "psi1") if key in state)
    ops = k * (copies * 2 * OPS_FAMILY * ncell + OPS_PSI * psi
               + OPS_POLE * 3 * len(state["Q"]) * ncell)
    return 2 * nbytes(fields) + nbytes(stepping_consts(runner)), ops


def sharded_bound(runner, state, states, k: int) -> tuple:
    """``(bound, unsharded bound, halo bytes)`` of one group on x-shards:
    the bytes of the unsharded group (``runner`` and ``state``, of the
    whole grid) plus the halo planes each exchange reads and writes, at
    the shard states' (``states``) storage sizes, and its operations."""
    from tidy3d_tpu_torch.solver.fdtd import halo_arrays

    u_bytes, u_ops = group_work(runner, state, k)
    halo = sum(2 * 2 * k * a[0].numel() * a.element_size()
               for st in states for a in halo_arrays(st))
    return bound(u_bytes + halo, u_ops), bound(u_bytes, u_ops), halo


def group_bound(runner, state, k: int):
    """The bound of one k-step group (``group_work``)."""
    return bound(*group_work(runner, state, k))


def kstep_registers(label: str = "kstep") -> dict:
    """``{(pole slots, bloch, bulk): (registers, spill stores, spill
    loads)}`` of each instantiation of ``csrc/kstep.cu`` in the library
    ``label`` (ptxas's report)."""
    from tidy3d_tpu_torch.labs import _common

    out = {}
    for mangled, regs in _common.registers(label).items():
        m = re.search(r"kstep_kernelILi(\d+)ELb([01])ELb([01])E", mangled)
        if m:
            out[(int(m.group(1)), m.group(2) == "1",
                 m.group(3) == "1")] = regs
    return out


def kstep_resources(num_poles: int, bloch: bool,
                    storage=(torch.float32,) * 3) -> dict:
    """Registers and blocks per SM of the bulk and the shell instantiation
    the k-step kernel runs for ``num_poles`` pole slots (or Bloch), in the
    library of the storage types ``storage``."""
    from tidy3d_tpu_torch import _build
    from tidy3d_tpu_torch.solver.kernels import kstep, step

    regs = kstep_registers(_build.label("kstep",
                                        step.storage_defines(*storage)))
    parts = {"bulk": True, "shell": False}
    return {"registers": {name: regs[(num_poles, bloch, bulk)][0]
                          for name, bulk in parts.items()},
            "blocks_per_sm": {name: kstep.occupancy(num_poles, bloch, bulk,
                                                    storage)
                              for name, bulk in parts.items()}}


ONESTEP_POLES = (0, 1, 2, 7)   # the fused kernel's instantiations reported


def onestep_resources(storage) -> dict:
    """Registers and bytes spilled (ptxas) and blocks per SM (the occupancy
    calculator) of the family kernel's E and H instantiations and of the
    fused kernel's at 0, 1, 2 and 7 pole slots, each bulk and shell (the
    shell of pair-aligned arrays), in the libraries of the storage types
    ``storage``."""
    from tidy3d_tpu_torch import _build
    from tidy3d_tpu_torch.labs import _common
    from tidy3d_tpu_torch.solver.kernels import fused, step

    defines = step.storage_defines(*storage)
    tables = {name: _common.registers(_build.label(name, defines))
              for name in ("step", "fused")}

    def row(name, symbol, blocks):
        rows = [v for k, v in tables[name].items() if symbol in k]
        assert len(rows) == 1, f"{name}: {len(rows)} kernels match {symbol}"
        regs, st, ld = rows[0]
        return {"registers": regs, "spill_bytes": st + ld,
                "blocks_per_sm": blocks}

    out = {"family": {}, "fused": {}}
    for part, bulk in (("bulk", True), ("shell", False)):
        for f in "EH":
            out["family"][f"{f} {part}"] = row(
                "step", f"family_update_kernelILb{int(f == 'E')}ELb"
                f"{int(bulk)}ELb1ELb0E", step.occupancy(f, storage, bulk))
        for np_ in ONESTEP_POLES:
            out["fused"][f"NP={np_} {part}"] = row(
                "fused", f"fused_step_kernelILi{np_}ELb{int(bulk)}ELb1E",
                fused.occupancy(storage, np_, bulk))
    return out


def log_new_instantiations() -> None:
    """Phase 2's report of this slice's instantiations: registers, spills
    (ptxas) and blocks per SM of the family kernel's two-copy (Bloch) E and
    H and pole-table E instantiations, bulk and shell, the fused kernel's
    pole-table ones, and post_e's."""
    from tidy3d_tpu_torch.labs import _common
    from tidy3d_tpu_torch.solver.kernels import fused, post_e, step

    regs = {name: _common.registers(name) for name in ("step", "fused",
                                                       "post_e")}

    def ptxas(name, symbol):
        rows = [v for k, v in regs[name].items() if symbol in k]
        assert len(rows) == 1, f"{name}: {len(rows)} kernels match {symbol}"
        return rows[0]

    for part, bulk in (("bulk", True), ("shell", False)):
        for f in "EH":
            r, st, ld = ptxas("step", f"family_update_bloch_kernelILb"
                              f"{int(f == 'E')}ELb{int(bulk)}ELb1E")
            log(f"[build] family Bloch {f} {part}: {r} registers, spill "
                f"{st + ld} B, {step.occupancy(f, bulk=bulk)} blocks of "
                f"256 threads per SM (real), "
                f"{step.resources(f, bulk, mode='bloch')['blocks_per_sm']} "
                f"(Bloch)")
        r, st, ld = ptxas("step", f"family_update_kernelILb1ELb{int(bulk)}"
                          "ELb1ELb1E")
        log(f"[build] family pole-table E {part}: {r} registers, spill "
            f"{st + ld} B, "
            f"{step.resources('E', bulk, mode='many')['blocks_per_sm']} "
            f"blocks per SM")
        r, st, ld = ptxas("fused", f"fused_step_kernelILin2ELb{int(bulk)}"
                          "ELb1E")
        log(f"[build] fused pole-table {part}: {r} registers, spill "
            f"{st + ld} B, {fused.occupancy(num_poles=13, bulk=bulk)} "
            "blocks per SM")
    for vec in (True, False):
        r, st, ld = ptxas("post_e", f"post_e_kernelILb{int(vec)}E")
        log(f"[build] post_e {'pairs' if vec else 'cells'}: {r} registers, "
            f"spill {st + ld} B, "
            f"{post_e.resources(vec=vec)['blocks_per_sm']} blocks of 256 "
            "threads per SM")


def load_widths(ops: list) -> dict:
    """Loads of a SASS loop by space and width: ``{"LDG.32": n, ...}`` (a
    ``.U16`` or ``.S16`` load is 16 bits, ``.64`` and ``.128`` as named,
    the rest 32; ``LDGSTS`` is an asynchronous copy into shared memory)."""
    out: dict = {}
    for op in ops:
        base = op.split(".")[0]
        if base not in ("LDG", "LDS", "LDGSTS"):
            continue
        mods = op.split(".")[1:]
        width = 16 if {"U16", "S16"} & set(mods) else \
            64 if "64" in mods else 128 if "128" in mods else 32
        key = f"{base}.{width}"
        out[key] = out.get(key, 0) + 1
    return out


def onestep_sass(storage) -> dict:
    """The SASS instruction classes (``_common.sass_classes``) and the
    loads by width (``load_widths``) of the bulk march loops of the family
    kernel (E and H) and the fused kernel (0 and 1 pole slots) in the
    libraries of the storage types ``storage``."""
    from tidy3d_tpu_torch import _build
    from tidy3d_tpu_torch.labs import _common
    from tidy3d_tpu_torch.solver.kernels import step

    defines = step.storage_defines(*storage)
    out = {}
    for what, name, symbol in (
            ("family E", "step", "family_update_kernelILb1ELb1ELb1ELb0E"),
            ("family H", "step", "family_update_kernelILb0ELb1ELb1ELb0E"),
            ("fused NP=0", "fused", "fused_step_kernelILi0ELb1ELb1E"),
            ("fused NP=1", "fused", "fused_step_kernelILi1ELb1ELb1E")):
        label = _build.label(name, defines)
        out[what] = dict(_common.sass_classes(label, symbol),
                         loads=load_widths(_common.sass_loop(label, symbol)))
    return out


def lists_per_group(runner) -> int:
    """Device launches of one k-step group of ``runner``: one per block
    list (bulk, shell) that is not empty, on each shard."""
    from tidy3d_tpu_torch.solver.kernels import kstep

    metas = [sh.meta for sh in runner.shards] if runner.shards \
        else [runner.meta]
    ncopy = 2 if runner.is_complex else 1
    return sum(len(ids) > 0 for meta in metas
               for ids in kstep.classify_blocks(meta, runner.k, ncopy))


def max_abs(d: dict) -> float:
    return max(float(v.float().abs().max()) for v in d.values())


def max_diff(a: dict, b: dict) -> float:
    """The largest difference, taken in float32 (bf16 widened exactly)."""
    assert set(a) == set(b), (sorted(a), sorted(b))
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def rel_err(got: dict, ref: dict) -> float:
    assert all(bool(torch.isfinite(v.float()).all()) for v in got.values())
    return max_diff(got, ref) / max(max_abs(ref), 1e-30)


def equal_share(got: dict, ref: dict) -> float:
    """The share of values of ``got`` bit-equal to ``ref``'s."""
    same = sum(int((got[k] == ref[k]).sum()) for k in ref)
    return same / sum(v.numel() for v in ref.values())


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #


def compare_update(step, runner, state, what: str) -> float:
    """Family kernel against plain version for one E and one H update;
    returns the largest absolute difference (fields and psi)."""
    worst_rel, worst_abs = 0.0, 0.0
    nE = None
    for fam in ("E", "H"):
        src = state["H"] if fam == "E" else nE
        before = step.LAUNCHES
        kf, kp = step.family_update(fam, state, runner.consts, src,
                                    runner.meta)
        sync()
        assert step.LAUNCHES == before + 1, "kernel did not launch"
        rf, rp = step.family_update_reference(fam, state, runner.consts, src,
                                              runner.meta)
        for got, ref in ((kf, rf), (kp, rp)):
            if not ref:
                continue
            worst_abs = max(worst_abs, max_diff(got, ref))
            worst_rel = max(worst_rel, rel_err(got, ref))
        if fam == "E":
            nE = rf
    log(f"[update] {what}: family kernel vs plain max rel err "
        f"{worst_rel:.3e} (max abs {worst_abs:.3e}, tol {TOL_UPDATE:g})")
    assert worst_rel <= TOL_UPDATE, f"{what}: rel err {worst_rel:.3e}"
    return worst_abs


def step_sources(runner) -> list:
    """The E-side source terms of a step inside the source pulse."""
    return runner.step_sources("E", min(40, runner.num_steps - 1))


def group_errors(fg: dict, fr: dict) -> tuple:
    """``(largest relative, largest absolute difference)`` of two flat
    states, each of fields, psi and pole currents relative to its own
    largest magnitude (over both copies of a complex run)."""
    worst_rel, worst_abs = 0.0, 0.0
    for group in ("E", "H", "psi", "Q"):
        keys = [key for key in fr if key.split(":")[0].rstrip(
            "0123456789") == group]
        if not keys:
            continue
        g = {key: fg[key] for key in keys}
        r = {key: fr[key] for key in keys}
        worst_abs = max(worst_abs, max_diff(g, r))
        worst_rel = max(worst_rel, rel_err(g, r))
    return worst_rel, worst_abs


def fused_flat(out) -> dict:
    """The flat state of a fused step's ``(E', H', psi', Q')``."""
    return flat_state(dict(zip(("E", "H", "psi", "Q"), out)))


def compare_fused(fused, runner, state, what: str) -> float:
    """Fused kernel against plain version for one step (E', H', psi' and
    Q'); returns the largest absolute difference."""
    src = step_sources(runner)
    before = fused.LAUNCHES
    got = fused.fused_step(state, runner.consts, runner.meta, src)
    sync()
    assert fused.LAUNCHES == before + 1, "fused kernel did not launch"
    assert len(got[3]) == len(state["Q"])
    ref = fused.fused_step_reference(state, runner.consts, runner.meta, src)
    worst_rel, worst_abs = group_errors(fused_flat(got), fused_flat(ref))
    log(f"[fused] {what}: fused kernel vs plain max rel err {worst_rel:.3e} "
        f"(max abs {worst_abs:.3e}, tol {TOL_UPDATE:g}; E', H', psi' and "
        f"{len(got[3])} poles' Q'); blocks of the bulk and shell launches "
        f"and device launches {fused.LAST_BLOCKS}")
    assert worst_rel <= TOL_UPDATE, f"{what}: rel err {worst_rel:.3e}"
    return worst_abs


def fused_work(runner, state):
    """``(bytes, operations)`` of one fused step: E, H, psi, Q and the
    constants (the pole residues included) read once, E', H', psi' and Q'
    written once; both families, their psi and the pole terms and
    updates."""
    ncell = int(np.prod(runner.shape))
    return (2 * nbytes(state["E"], state["H"], state["psi"], state["Q"])
            + nbytes(stepping_consts(runner)),
            2 * OPS_FAMILY * ncell + OPS_PSI * numel(state["psi"])
            + OPS_POLE * 3 * len(state["Q"]) * ncell)


def q_buffers(state: dict) -> list:
    """A second set of pole currents shaped as ``state``'s (the fused
    kernel's output set)."""
    return [{c: (torch.empty_like(qr), torch.empty_like(qi))
             for c, (qr, qi) in Qp.items()} for Qp in state["Q"]]


def flat_state(state: dict) -> dict:
    """Fields, psi and pole currents of a state, one entry per array."""
    out = {f"{fam}:{key}": v for fam in ("E", "H", "psi", "E1", "H1", "psi1")
           if fam in state for key, v in state[fam].items()}
    for copy, key in enumerate(("Q", "Q1")):
        for pi, Qp in enumerate(state.get(key, [])):
            for c, (qr, qi) in Qp.items():
                tag = f"Q{pi}:{c}" + (":1" if copy else "")
                out[f"{tag}:re"], out[f"{tag}:im"] = qr, qi
    return out


def compare_kstep(kstep, runner, state, what: str) -> float:
    """k-step kernel against its plain version for one group from step 36
    (inside the source pulse), relative to the largest magnitude of each
    of fields, psi and pole currents (over both copies of a complex run);
    returns the largest absolute difference."""
    k, t0 = runner.k, 36
    before = kstep.LAUNCHES
    got = kstep.kstep_group(state, runner.consts, runner.meta, runner.tables,
                            t0, k, out=state["alt"])
    sync()
    assert kstep.LAUNCHES == before + 1, "k-step kernel did not launch"
    ref = kstep.kstep_group_reference(state, runner.consts, runner.meta,
                                      runner.tables, t0, k)
    worst_rel, worst_abs = group_errors(flat_state(got), flat_state(ref))
    log(f"[kstep] {what}, k={k}: k-step kernel vs plain max rel err "
        f"{worst_rel:.3e} (max abs {worst_abs:.3e}, tol {TOL_UPDATE:g})")
    assert worst_rel <= TOL_UPDATE, f"{what}: rel err {worst_rel:.3e}"
    return worst_abs


def run_steps_timed(runner, steps: int):
    runner._pad_time_tables(steps)
    state = runner.init_state()
    sync()
    t0 = time.perf_counter()
    state = runner.run_steps(0, steps, state)
    sync()
    return state, time.perf_counter() - t0


def compare_runners(plan, dev, ncell, what: str, smi: str, runners=None,
                    **kw):
    """200 steps with the kernel and with the plain versions, in turns
    plain, kernel, kernel, plain (the fields of both copies of a complex
    run compared); returns the Gcell*steps/s of each. ``runners``: the
    ``{"plain", "kernel"}`` runners of ``plan`` where already built."""
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner

    runners = runners or {
        "plain": FDTDRunner(plan, device=dev, use_kernel=False, **kw),
        "kernel": FDTDRunner(plan, device=dev, **kw)}
    rates = {"plain": [], "kernel": []}
    finals, currents = {}, {}
    for name in ("plain", "kernel", "kernel", "plain"):
        st, secs = run_steps_timed(runners[name], STEPS_COMPARE)
        rates[name].append(ncell * STEPS_COMPARE / secs / 1e9)
        finals[name] = {f"{fam}:{c}": v for fam in ("E", "H", "E1", "H1")
                        if fam in st for c, v in st[fam].items()}
        currents[name] = {k: v for k, v in flat_state(st).items()
                          if k.startswith("Q")}
        del st
    err = rel_err(finals["kernel"], finals["plain"])
    err_q = rel_err(currents["kernel"], currents["plain"]) \
        if currents["plain"] else 0.0
    log(f"[steps] {what}, tier {runners['kernel'].tier}: {STEPS_COMPARE} "
        f"steps kernel vs plain max rel err {err:.3e}, pole currents "
        f"{err_q:.3e} (tol {TOL_STEPS:g})")
    assert max_abs(finals["plain"]) > 0
    assert err <= TOL_STEPS, f"{what}: 200-step rel err {err:.3e}"
    assert err_q <= TOL_STEPS, f"{what}: 200-step Q rel err {err_q:.3e}"
    log(f"[steps] {what} Gcell*steps/s: plain {rates['plain']} kernel "
        f"{rates['kernel']} | {smi}")
    return rates


def _range_device_us(prof, name: str) -> float:
    """Device time of the kernels launched inside profiler range ``name``
    (the host-side ranges; each kernel counted once, however many of the
    ops around it list it)."""
    seen = {}

    def walk(evt):
        for k in evt.kernels:
            seen[id(k)] = k.duration
        for c in evt.cpu_children:
            walk(c)

    for e in prof.events():
        if e.name == name and e.device_type.name == "CPU":
            walk(e)
    return sum(seen.values())


def _device_busy_us(prof) -> float:
    """Time in which the device ran at least one kernel or copy: the union
    of the device events' intervals, so that kernels that overlap (the two
    launches of a k-step group) count once."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type.name == "CUDA" and not e.name.startswith("fdtd.")
        and e.name != "Command Buffer Full"
        and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def profile_window(runner, out_path: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from tidy3d_tpu_torch.solver.kernels import fused, kstep, post_e, step

    def device_launches():
        return step.DEVICE_LAUNCHES + fused.DEVICE_LAUNCHES \
            + kstep.DEVICE_LAUNCHES + post_e.DEVICE_LAUNCHES

    state = runner.init_state()
    runner._pad_time_tables(NPROF + 4)
    state = runner.run_steps(0, 4, state)
    sync()
    before = device_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        state = runner.run_steps(4, NPROF, state)
        sync()
    made = device_launches() - before
    by_name = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        # the device-side copies of the runner's ranges span other kernels,
        # and a full launch queue is host time: neither is device work
        if evt.key.startswith("fdtd.") or evt.key == "Command Buffer Full" \
                or getattr(evt, "is_user_annotation", False):
            continue
        if dev_us and evt.device_type.name == "CUDA":
            by_name[evt.key] = (dev_us / 1e3, evt.count)
    with open(out_path, "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_device_time_total",
                                           row_limit=40))
    total = sum(ms for ms, _ in by_name.values())
    return dict(
        device_ms=total,
        family_ms=sum(ms for k, (ms, _) in by_name.items()
                      if "family_update_kernel" in k
                      or "family_update_bloch_kernel" in k),
        post_e_ms=sum(ms for k, (ms, _) in by_name.items()
                      if "post_e_kernel" in k),
        fused_ms=sum(ms for k, (ms, _) in by_name.items()
                     if "fused_step_kernel" in k),
        kstep_ms=sum(ms for k, (ms, _) in by_name.items()
                     if "kstep_kernel" in k),
        # kernel launches of the tier recorded, against those made
        recorded=sum(n for k, (_, n) in by_name.items()
                     if k.split("<")[0].split("(")[0].split()[-1] in (
                         "family_update_kernel", "family_update_bloch_kernel",
                         "fused_step_kernel", "kstep_kernel",
                         "post_e_kernel")),
        expected=made,
        poles_ms=_range_device_us(prof, "fdtd.poles") / 1e3,
        poles_ranges=sum(e.name == "fdtd.poles"
                         and e.device_type.name == "CPU"
                         for e in prof.events()),
        monitors_ms=_range_device_us(prof, "fdtd.monitors") / 1e3,
        busy_ms=_device_busy_us(prof) / 1e3,
        launches=sum(c for _, c in by_name.values()))


def report_profile(prof: dict, what: str, step_ms: float, smi: str):
    """Logs a profile window's split per step and returns it (None where
    the profiler's record is incomplete: not measured)."""
    if prof["device_ms"] <= 0:
        log(f"[profile] {what}: torch.profiler recorded no device time: not "
            "measured")
        return None
    if prof["recorded"] != prof["expected"]:
        log(f"[profile] {what}: torch.profiler recorded {prof['recorded']} of "
            f"the {prof['expected']} kernel launches made: not measured")
        return None
    per = {k: v / NPROF for k, v in prof.items()
           if k not in ("recorded", "expected", "poles_ranges")}
    kernel = per["family_ms"] + per["fused_ms"] + per["kstep_ms"] \
        + per["post_e_ms"]
    other = per["device_ms"] - kernel - per["poles_ms"]
    # the profiler slows the host loop, so the busy share compares the
    # time the device was busy per step with the unprofiled step time
    log(f"[profile] {what} per step: device {per['device_ms']:.3f} ms = "
        f"kernels {kernel:.3f} ms (family {per['family_ms']:.3f}, fused "
        f"{per['fused_ms']:.3f}, k-step {per['kstep_ms']:.3f}, post_e "
        f"{per['post_e_ms']:.3f}) + "
        f"pole-update ops {per['poles_ms']:.3f} ms "
        f"({prof['poles_ranges']} fdtd.poles ranges) "
        f"+ DFT/source ops {other:.3f} ms (of which the monitor range "
        f"{per['monitors_ms']:.3f} ms), {per['launches']:.0f} device "
        f"launches; busy {per['busy_ms']:.3f} ms (overlapping kernels "
        f"once); unprofiled step {step_ms:.3f} ms, device busy "
        f"{per['busy_ms'] / step_ms:.1%} | {smi}")
    return per


def web_run(td, sim, what: str, smi: str, tier: str = None,
            field: str = "field"):
    """``web.run`` with the launch counts set to 0 just before it and read
    just after; checks that the flux (and the ``field`` monitor's Ez, where
    named) is finite and non-zero. Returns the data, flux, steps run,
    ``{kernel: launches}``, Gcell*steps/s, the tier logged and the peak
    device memory."""
    from types import SimpleNamespace

    from tidy3d_tpu_torch.solver.kernels import fused, kstep, post_e, step

    old = os.environ.get("TIDY3D_TPU_KERNEL")
    if tier is not None:
        os.environ["TIDY3D_TPU_KERNEL"] = tier
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step.LAUNCHES = fused.LAUNCHES = kstep.LAUNCHES = 0
        kstep.DEVICE_LAUNCHES = 0
        step.BLOCH_LAUNCHES = step.MANY_POLES_LAUNCHES = 0
        fused.MANY_POLES_LAUNCHES = post_e.LAUNCHES = 0
        t0 = time.perf_counter()
        data = td.web.run(sim, task_name="chip_smoke", verbose=False)
        total_s = time.perf_counter() - t0
        launches = {"family": step.LAUNCHES, "fused": fused.LAUNCHES,
                    "kstep": kstep.LAUNCHES}
        # the instantiations of this PR: the family kernel's two-copy and
        # pole-table calls, the fused kernel's pole-table calls, post_e
        extra = {"family_bloch": step.BLOCH_LAUNCHES,
                 "family_many_poles": step.MANY_POLES_LAUNCHES,
                 "fused_many_poles": fused.MANY_POLES_LAUNCHES,
                 "post_e": post_e.LAUNCHES}
        device_launches = kstep.DEVICE_LAUNCHES
    finally:
        if old is None:
            os.environ.pop("TIDY3D_TPU_KERNEL", None)
        else:
            os.environ["TIDY3D_TPU_KERNEL"] = old
    peak = torch.cuda.max_memory_allocated()
    lines = data.log.splitlines()
    steps_run = int(lines[1].split("steps run: ")[1].split(" ")[0])
    rate = float(lines[2].split("throughput: ")[1].split(" ")[0])
    mem = log_memory(lines)
    host = {name: float(secs) for name, secs in (
        part.rsplit(" ", 1) for part in log_field(
            lines, "monitor data host seconds: ").split(", ") if part)}
    MEMORY.append((what, mem["estimate"], mem["peak"], base))
    flux = np.asarray(data["flux"].flux.values)
    log(f"[web.run] {what}: {steps_run} steps, launches {launches} (k-step "
        f"device launches {device_launches}; {extra}), log: "
        f"{' | '.join(lines[2:])}")
    log(f"[web.run] {what}: total {total_s:.1f} s (lowering included), peak "
        f"device memory {peak / 2**30:.2f} GiB (the runner's "
        f"{mem['peak'] / 2**30:.3f}, estimate {mem['estimate'] / 2**30:.3f},"
        f" {base / 2**30:.3f} allocated before) | {smi}")
    log(f"[web.run] {what}: flux {flux.tolist()}")
    assert flux.shape == (11,) and np.all(np.isfinite(flux))
    assert np.all(flux != 0)
    if field:
        values = data[field].Ez.values
        assert values.shape[-1] == 11 and np.all(np.isfinite(values))
        assert np.any(values != 0)
    tier, storage = lines[-1].split("kernel tier: ")[1].split(" [storage: ")
    return SimpleNamespace(
        data=data, flux=flux, steps=steps_run, launches=launches, rate=rate,
        tier=tier, storage=storage.rstrip("]"), peak=peak,
        device_launches=device_launches, host=host, total_s=total_s,
        extra=extra, memory=mem, base=base)


def log_field(lines: list, prefix: str) -> str:
    """The rest of the log line that starts with ``prefix``."""
    return next(line for line in lines
                if line.startswith(prefix))[len(prefix):]


def log_memory(lines: list) -> dict:
    """``{"peak", "estimate"}`` bytes from a SimulationData log's ``device
    memory: peak P B, estimate E B on <device>`` line."""
    m = re.match(r"peak (\d+) B, estimate (\d+) B on ",
                 log_field(lines, "device memory: "))
    return {"peak": int(m.group(1)), "estimate": int(m.group(2))}


def run_bloch(td, dev, smi: str) -> dict:
    """Phases 10 and 11: the two-copy k-step kernel on the Bloch dipole and
    the angled plane wave, then ``web.run`` of both. Returns the Bloch
    instantiation's entry of the kernels line."""
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
    from tidy3d_tpu_torch.solver.kernels import kstep
    from tidy3d_tpu_torch.solver.lowering import lower

    none = {"family": 0, "fused": 0, "kstep": 0}
    # 10. Bloch (complex) runs: the two-copy k-step kernel
    t0 = time.perf_counter()
    plan_b = lower(bloch_case(td))
    ncell_b = int(np.prod(plan_b.shape))
    log(f"[bloch] dipole: grid {plan_b.shape} = {ncell_b} cells, "
        f"{plan_b.num_steps} steps, lowered in "
        f"{time.perf_counter() - t0:.1f} s, phases {plan_b.bloch_phases}")
    br = FDTDRunner(plan_b, device=dev)
    assert br.tier == "kstep" and br.is_complex and not plan_b.poles
    st = random_state(br, 12)
    err_bloch = [compare_kstep(kstep, br, st, f"{plan_b.shape} Bloch dipole")]

    def bloch_group(fn):
        return lambda: fn(st, br.consts, br.meta, br.tables, 36, br.k,
                          out=st["alt"])

    b_ms = cuda_ms(bloch_group(kstep.kstep_group), 10)
    bp_ms = cuda_ms(bloch_group(kstep.kstep_group_reference), 3)
    b_bound = group_bound(br, st, br.k)
    res = kstep_resources(0, True)
    dl_b = lists_per_group(br)
    log(f"[bloch] {plan_b.shape} dipole, k={br.k}, two copies: k-step kernel "
        f"{b_ms:.3f} ms/group = {b_ms / br.k:.3f} ms/step "
        f"({ncell_b * br.k / b_ms / 1e6:.2f} Gcell*steps/s, cells counted "
        f"once), plain {bp_ms:.3f} ms/group; bound {b_bound[0]:.3f} ms/group "
        f"by {b_bound[1]}, ratio {b_ms / b_bound[0]:.2f}; {dl_b} device "
        f"launches a group, registers {res['registers']}, blocks per SM "
        f"{res['blocks_per_sm']} | {smi}")
    del st
    rates_b = compare_runners(plan_b, dev, ncell_b, "Bloch dipole 256^3",
                              smi)
    pb = profile_window(br, os.path.join(OUT_DIR, "chip_smoke_prof_bloch.txt"))
    report_profile(pb, "Bloch dipole, kstep tier",
                   ncell_b / (float(np.mean(rates_b["kernel"])) * 1e9) * 1e3,
                   smi)
    del br
    plan_pw = lower(planewave_case(td))
    pr = FDTDRunner(plan_pw, device=dev)
    assert pr.tier == "kstep" and pr.is_complex
    pairs = sum(s.term_im is not None for fam in "EH"
                for s in pr.tables.sources[fam])
    log(f"[bloch] angled plane wave: grid {plan_pw.shape}, "
        f"{plan_pw.num_steps} steps, {len(plan_pw.sources)} source plans in "
        f"{pairs} complex (re, im) pairs, phases {plan_pw.bloch_phases}")
    assert pairs > 0
    err_bloch.append(compare_kstep(kstep, pr, random_state(pr, 13),
                                   f"{plan_pw.shape} angled plane wave"))
    del pr, plan_pw

    # 11. web.run of both Bloch cases: one k-step launch per group
    wb = web_run(td, bloch_case(td), "Bloch dipole, default tier", smi)
    assert wb.tier == "kstep (k=2)", wb.tier
    assert wb.launches == dict(none, kstep=wb.steps // 2), wb.launches
    assert wb.device_launches == dl_b * wb.steps // 2, wb.device_launches
    wp = web_run(td, planewave_case(td), "angled plane wave, default tier",
                 smi, field=None)
    assert wp.launches == dict(none, kstep=wp.steps // 2), wp.launches
    assert wp.device_launches >= wp.steps // 2, wp.device_launches
    back = np.asarray(wp.data["flux_back"].flux.values)
    fwd = float(np.abs(wp.data["fwd"].Ez.values).max())
    bwd = float(np.abs(wp.data["bwd"].Ez.values).max())
    log(f"[web.run] angled plane wave: forward |Ez| {fwd:.6f} (1 within "
        f"1e-2), backward / forward {bwd / fwd:.3e} (below 1e-2); flux "
        f"ahead {wp.flux.tolist()}, behind {back.tolist()}")
    assert abs(fwd - 1.0) < 1e-2 and bwd / fwd < 1e-2
    assert np.all(np.isfinite(back))
    n_bloch = wb.launches["kstep"] + wp.launches["kstep"]
    log(f"[web.run] Bloch Gcell*steps/s (cells counted once): dipole "
        f"{wb.rate}, angled plane wave {wp.rate}; peak device memory "
        f"{wb.peak / 2**30:.2f} / {wp.peak / 2**30:.2f} GiB | {smi}")

    return dict(launches=n_bloch, err=max(err_bloch), ms=b_ms,
                plain_ms=bp_ms, bound=b_bound, rate_planewave=wp.rate, **res)


def sharded_runner(plan, devices, **kw):
    """A runner sharded over ``devices`` (a device listed several times is
    one virtual shard each), x-only unless ``decomp`` says otherwise."""
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
    from tidy3d_tpu_torch.solver.sharding import ShardingPlan, make_mesh

    mesh, _ = make_mesh(devices=devices, decomp=kw.pop("decomp", None))
    return FDTDRunner(plan, device=devices[0],
                      sharding_plan=ShardingPlan(mesh, plan.shape), **kw)


def shard_group(fn, runner, states, t0):
    """One sharded group as ``step_group`` makes it: the halo exchange of
    the set read, then one call of ``fn`` per shard."""
    runner.exchange_halos(states)
    return [fn(st, sh.consts, sh.meta, sh.tables, t0, runner.k, out=st["alt"])
            for sh, st in zip(runner.shards, states)]


def compare_sharded_group(kstep, ur, sr, seed: int, what: str):
    """One group of the sharded k-step kernel from a random state split
    into shards, against its plain version and against the unsharded
    kernel on the same state; returns ``(largest absolute difference to
    plain, the states of the shards)``."""
    from tidy3d_tpu_torch import convert

    k, t0 = sr.k, 36
    glob = random_state(ur, seed)
    uns = flat_state(kstep.kstep_group(glob, ur.consts, ur.meta, ur.tables,
                                       t0, k, out=glob["alt"]))
    states = convert.shard_states_from_reference(glob, sr)
    del glob
    before = kstep.SHARDED_LAUNCHES
    news = shard_group(kstep.kstep_group, sr, states, t0)
    sync()
    assert kstep.SHARDED_LAUNCHES == before + len(sr.shards), \
        "sharded kernel did not launch"
    got = flat_state(convert.shard_states_to_reference(news, sr,
                                                       tensors=True))
    plain = flat_state(convert.shard_states_to_reference(
        shard_group(kstep.kstep_group_reference, sr, states, t0), sr,
        tensors=True))
    worst = {"plain": (0.0, 0.0), "unsharded": (0.0, 0.0)}
    for name, ref in (("plain", plain), ("unsharded", uns)):
        for group in ("E", "H", "psi", "Q"):
            keys = [key for key in ref if key.split(":")[0].rstrip(
                "0123456789") == group]
            if not keys:
                continue
            g = {key: got[key] for key in keys}
            r = {key: ref[key] for key in keys}
            worst[name] = (max(worst[name][0], rel_err(g, r)),
                           max(worst[name][1], max_diff(g, r)))
    for name, (rel, ab) in worst.items():
        log(f"[sharded] {what}: one group, sharded kernel vs {name} max rel "
            f"err {rel:.3e} (max abs {ab:.3e}, tol {TOL_UPDATE:g})")
        assert rel <= TOL_UPDATE, f"{what} vs {name}: rel err {rel:.3e}"
    return worst["plain"][1], states


def run_sharded(td, dev, smi: str, sim, plan, plan_d) -> dict:
    """Phases 12 to 15: sharded runs on virtual shards of the one card, on
    ``plan_d`` (the dispersive case) and ``plan`` (the broadband case,
    lowered from ``sim``). Returns the ``kstep_group_sharded`` entry of the
    kernels line."""
    from tidy3d_tpu_torch.solver import distributed
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner, halo_arrays
    from tidy3d_tpu_torch.solver.kernels import fused, kstep, step
    from tidy3d_tpu_torch.web.run import assemble_sim_data

    ncell = int(np.prod(plan.shape))
    # 12. the 4-shard dispersive case: one group against plain and against
    # the unsharded kernel, times, 200 steps
    ur = FDTDRunner(plan_d, device=dev, kernel="kstep")
    sr = sharded_runner(plan_d, [dev] * 4)
    lay = sr.layout
    assert sr.tier == "kstep" and 4 * lay.nx_loc == plan_d.shape[0]
    held = [int(sh.tables.boxes["E"].shape[0]) for sh in sr.shards]
    pml_x = [sh.index for sh in sr.shards
             if any(sh.meta.pml_meta[("dual", 0)])]
    log(f"[sharded] dispersive {plan_d.shape}, 4 virtual x-shards of "
        f"{lay.nx_loc} planes: x-PML slabs on shards {pml_x}, J source "
        f"boxes per shard {held}")
    assert pml_x == [0, 3] and sum(held) > 1, (pml_x, held)
    err_sh, states = compare_sharded_group(kstep, ur, sr, 14,
                                           f"{plan_d.shape} dispersive")
    k = sr.k

    def launch(s):
        sh, st = sr.shards[s], states[s]
        return lambda: kstep.kstep_group(st, sh.consts, sh.meta, sh.tables,
                                         36, k, out=st["alt"])

    g_ms = cuda_ms(lambda: shard_group(kstep.kstep_group, sr, states, 36), 10)
    ex_ms = cuda_ms(lambda: sr.exchange_halos(states), 10)
    l_ms = [cuda_ms(launch(s), 10) for s in range(4)]
    gp_ms = cuda_ms(lambda: shard_group(kstep.kstep_group_reference, sr,
                                        states, 36), 2)
    sync()
    t0 = time.perf_counter()
    for _ in range(10):
        shard_group(kstep.kstep_group, sr, states, 36)
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    sync()
    glob = ur.init_state()
    copies = 2 * sum(len(halo_arrays(st)) for st in states)
    sh_bound, u_bound, halo_bytes = sharded_bound(ur, glob, states, k)
    u_ms = cuda_ms(lambda: kstep.kstep_group(glob, ur.consts, ur.meta,
                                             ur.tables, 36, k,
                                             out=glob["alt"]), 10)
    del glob
    res = kstep_resources(len(plan_d.poles), False)
    log(f"[sharded] {plan_d.shape} dispersive, 4 shards, k={k}: "
        f"{lists_per_group(sr)} device launches a group, registers "
        f"{res['registers']}, blocks per SM {res['blocks_per_sm']}, ratio "
        f"to the bound {g_ms / sh_bound[0]:.2f}")
    log(f"[sharded] {plan_d.shape} dispersive, 4 shards, k={k}: group "
        f"{g_ms:.3f} ms (CUDA events) = launches "
        f"{', '.join(f'{m:.3f}' for m in l_ms)} ms (sum {sum(l_ms):.3f}) "
        f"+ exchange {g_ms - sum(l_ms):.3f} ms (the rest; {copies} halo "
        f"blocks, {halo_bytes / 1e6:.1f} MB moved; {ex_ms:.3f} ms timed "
        f"alone); "
        f"unsharded group {u_ms:.3f} ms, ratio {g_ms / u_ms:.3f}; host "
        f"{host_ms:.3f} ms per group enqueued; plain {gp_ms:.3f} ms; bound "
        f"{sh_bound[0]:.3f} ms by {sh_bound[1]} (unsharded "
        f"{u_bound[0]:.3f}) | {smi}")
    del states
    # 200 steps, sharded against unsharded, in turns
    finals, rates = {}, {"unsharded": [], "sharded": []}
    for name in ("unsharded", "sharded", "sharded", "unsharded"):
        st, secs = run_steps_timed(ur if name == "unsharded" else sr,
                                   STEPS_COMPARE)
        rates[name].append(ncell * STEPS_COMPARE / secs / 1e9)
        if name == "sharded":
            from tidy3d_tpu_torch import convert
            st = convert.shard_states_to_reference(st["shards"], sr,
                                                   tensors=True)
        finals[name] = {f"{fam}:{c}": v for fam in ("E", "H")
                        for c, v in st[fam].items()}
        del st
    err = rel_err(finals["sharded"], finals["unsharded"])
    log(f"[sharded] dispersive: {STEPS_COMPARE} steps, 4 shards vs unsharded "
        f"max rel err {err:.3e} (tol {TOL_STEPS:g}); Gcell*steps/s "
        f"unsharded {rates['unsharded']} sharded {rates['sharded']} | {smi}")
    assert err <= TOL_STEPS, f"sharded 200 steps: rel err {err:.3e}"
    del finals, ur, sr

    # distinct devices, where there are several
    cards = distributed.ring_device_order()
    if len(cards) > 1:
        n = min(4, len(cards))
        devs = [cards[s % n] for s in range(4)]
        compare_sharded_group(kstep, FDTDRunner(plan_d, device=dev,
                                                kernel="kstep"),
                              sharded_runner(plan_d, devs), 15,
                              f"dispersive on {n} distinct devices")
    else:
        log("[sharded] distinct devices: not run (one CUDA device visible)")

    # 13. the 1-shard ring (bench.py fdtd_sharded): 200 steps in turns
    ring = {"unsharded": FDTDRunner(plan, device=dev, kernel="kstep"),
            "ring": sharded_runner(plan, [dev])}
    ms = {"unsharded": [], "ring": []}
    for name in ("unsharded", "ring", "ring", "unsharded"):
        ms[name].append(run_steps_timed(ring[name], STEPS_COMPARE)[1]
                        / STEPS_COMPARE * 1e3)
    ratio = float(np.mean(ms["ring"]) / np.mean(ms["unsharded"]))
    log(f"[sharded] broadband, 1-shard ring onto itself: ms/step ring "
        f"{ms['ring']} unsharded {ms['unsharded']}, ratio {ratio:.4f} | {smi}")
    del ring

    # 14. the main path: a full-length broadband run over 4 x-shards,
    # then the port's SimulationData builders
    none = {"family": 0, "fused": 0, "kstep": 0}
    ref_raw = FDTDRunner(plan, device=dev, kernel="kstep").run()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step.LAUNCHES = fused.LAUNCHES = kstep.LAUNCHES = 0
    kstep.SHARDED_LAUNCHES = kstep.DEVICE_LAUNCHES = 0
    base = torch.cuda.memory_allocated()
    run4 = sharded_runner(plan, [dev] * 4)
    raw = run4.run()
    MEMORY.append(("broadband, 4 virtual x-shards",
                   run4.estimate_device_memory()["total"],
                   run4.hbm_peak_bytes, base))
    launches = {"family": step.LAUNCHES, "fused": fused.LAUNCHES,
                "kstep": kstep.LAUNCHES}
    n_sharded = kstep.SHARDED_LAUNCHES
    n_device = kstep.DEVICE_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    groups = run4.steps_run // run4.k
    assert launches == dict(none, kstep=4 * groups), launches
    assert n_sharded == 4 * groups, n_sharded
    assert n_device == lists_per_group(run4) * groups, n_device
    data = assemble_sim_data(sim, plan, raw, run4, "chip_smoke")
    flux = np.asarray(data["flux"].flux.values)
    assert flux.shape == (11,) and np.all(np.isfinite(flux)) \
        and np.all(flux != 0)
    err = raw_err(ref_raw, raw)
    rate = ncell * run4.steps_run / run4.wall_time / 1e9
    log(f"[sharded] broadband web path, 4 x-shards: {run4.steps_run} steps, "
        f"{groups} groups, launches {launches} ({n_sharded} shard-local, "
        f"{n_device} device launches), "
        f"{rate:.3f} Gcell*steps/s, peak device memory "
        f"{peak / 2**30:.2f} GiB; raw monitors vs unsharded max rel err "
        f"{err:.3e} (tol {TOL_STEPS:g}); tier {data.log.splitlines()[-1]} "
        f"| {smi}")
    assert err <= TOL_STEPS, f"4-shard broadband: rel err {err:.3e}"
    # the broadband group split, on the runner's own state
    st4 = run4.init_state()["shards"]
    gb_ms = cuda_ms(lambda: shard_group(kstep.kstep_group, run4, st4, 36),
                    10)
    lb_ms = sum(cuda_ms(lambda sh=sh, st=st: kstep.kstep_group(
        st, sh.consts, sh.meta, sh.tables, 36, k, out=st["alt"]), 10)
        for sh, st in zip(run4.shards, st4))
    sync()
    t0 = time.perf_counter()
    for _ in range(10):
        shard_group(kstep.kstep_group, run4, st4, 36)
    hb_ms = (time.perf_counter() - t0) / 10 * 1e3
    sync()
    log(f"[sharded] broadband, 4 shards: group {gb_ms:.3f} ms = launches "
        f"{lb_ms:.3f} ms + exchange {gb_ms - lb_ms:.3f} ms; host "
        f"{hb_ms:.3f} ms per group enqueued | {smi}")
    del run4, data, st4

    # 15. a y decomposition through the rotation
    ry = sharded_runner(plan, [dev] * 2, decomp=(1, 2, 1))
    assert ry._plan_rot == 1
    raw_y = ry.run()
    err_y = raw_err(ref_raw, raw_y)
    log(f"[sharded] broadband, (1, 2, 1) rotated onto x: {ry.steps_run} "
        f"steps, {ncell * ry.steps_run / ry.wall_time / 1e9:.3f} "
        f"Gcell*steps/s, raw monitors vs unsharded max rel err {err_y:.3e} "
        f"(tol {TOL_STEPS:g}) | {smi}")
    assert err_y <= TOL_STEPS, f"y decomposition: rel err {err_y:.3e}"
    return dict(launches=n_sharded, err=err_sh, ms=g_ms, plain_ms=gp_ms,
                bound=sh_bound, **res)


def run_waveguide(td, smi: str, modes: dict) -> int:
    """Phase 16: the 384^3 waveguide through ``web.run`` on the default
    tier (k-step launches only), every mode solve under ``auto`` (the
    device filter on the card, no fallback), mode 0 forward against the
    flux, the power balance of both directions, the permittivity plane
    against the plan; then the same case with the flux plane only, for the
    cost of the new monitors. ``modes`` holds phase 26's ARPACK and filter
    seconds of the mode monitor's solve. Returns the k-step launches."""
    from tidy3d_tpu_torch.plugins.mode import device_solver
    from tidy3d_tpu_torch.solver.lowering import lower

    none = {"family": 0, "fused": 0, "kstep": 0}
    os.environ.pop("TIDY3D_TPU_MODE_SOLVER", None)     # auto
    n_rec, fallbacks = len(device_solver.RECORDS), device_solver.FALLBACKS
    w = web_run(td, waveguide_case(td), "waveguide, default tier", smi,
                field=None)
    recs = device_solver.RECORDS[n_rec:]
    # the source's solve in lower(), the mode monitor's 11, the mode-solver
    # monitor's one: all on the card's filter
    assert [r["num_modes"] for r in recs] == [1] + [2] * 12, recs
    assert all(r["device"] == "cuda" for r in recs), recs
    assert device_solver.FALLBACKS == fallbacks
    log(f"[waveguide] mode solves on the card's filter (auto): source "
        f"{recs[0]['total_s']:.3f} s, mode monitor {w.host['mode']:.3f} s "
        f"(11 frequencies; ARPACK on the host {modes['arpack_s']:.3f} s, "
        f"the filter alone {modes['filter_s']:.3f} s in phase 26), "
        f"mode-solver monitor {w.host['modes']:.3f} s; 0 fallbacks | {smi}")
    assert w.tier == "kstep (k=2)", w.tier
    assert w.launches == dict(none, kstep=w.steps // 2), w.launches
    amps = w.data["mode"].amps
    fwd = np.abs(amps.sel(direction="+", mode_index=0).values)
    bwd = np.abs(amps.sel(direction="-", mode_index=0).values)
    ratio = fwd ** 2 / w.flux
    balance = (fwd ** 2 - bwd ** 2) / w.flux
    n_eff = np.real(np.asarray(w.data["mode"].n_complex.values))
    log(f"[waveguide] mode 0: |a+|^2 / flux {ratio.tolist()} (1 within "
        f"{TOL_MODE_FLUX:g}); |a-| / |a+| {(bwd / fwd).tolist()}; "
        f"(|a+|^2 - |a-|^2) / flux {balance.tolist()} (1 within "
        f"{TOL_BALANCE:g}); n_eff at 1.55 um {n_eff[5].tolist()}")
    assert np.all(np.abs(ratio - 1) <= TOL_MODE_FLUX), ratio
    assert np.all(np.abs(balance - 1) <= TOL_BALANCE), balance
    assert np.all(bwd < fwd), bwd / fwd
    modes = w.data["modes"]
    assert np.all(np.isfinite(modes.Ey.values)) and np.any(modes.Ey.values)
    plan = lower(waveguide_case(td))
    mp = next(m for m in plan.monitors if m.kind == "permittivity")
    for comp in ("Ex", "Ey", "Ez"):
        eps = np.broadcast_to(plan.eps_yee[comp], plan.shape)[mp.slices[comp]]
        got = getattr(w.data["eps"], f"eps_{comp[1]}{comp[1]}").values[..., 0]
        assert np.array_equal(got, eps.astype(np.complex64)), comp
    assert len(np.unique(np.real(got))) > 1
    del plan
    log(f"[waveguide] permittivity plane {got.shape} equal to plan.eps_yee; "
        f"host seconds of the mode solves: mode monitor {w.host['mode']:.3f}"
        f" (11 frequencies), mode-solver monitor {w.host['modes']:.3f}, "
        f"permittivity {w.host['eps']:.3f}, flux {w.host['flux']:.3f}")
    base = web_run(td, waveguide_case(td, monitors=False),
                   "waveguide without the new monitors, default tier", smi,
                   field=None)
    assert base.launches == dict(none, kstep=base.steps // 2)
    assert device_solver.FALLBACKS == fallbacks
    log(f"[waveguide] Gcell*steps/s {w.rate} with the mode, mode-solver and "
        f"permittivity monitors, {base.rate} without; steps {w.steps} / "
        f"{base.steps}; peak device memory {w.peak / 2**30:.3f} / "
        f"{base.peak / 2**30:.3f} GiB | {smi}")
    return w.launches["kstep"] + base.launches["kstep"]


def _overlap(a, b) -> float:
    return float(np.abs(np.vdot(a.ravel(), b.ravel()))
                 / (np.linalg.norm(a) * np.linalg.norm(b)))


def mode_solve(td, sim, plane, spec, freqs, route: str, device: str):
    """A ``ModeSolver`` of ``plane`` under ``TIDY3D_TPU_MODE_SOLVER=route``
    on ``device``: the data, the host seconds and the device solver's
    records of the solve."""
    from tidy3d_tpu_torch.plugins.mode import device_solver
    from tidy3d_tpu_torch.plugins.mode.mode_solver import ModeSolver

    old = os.environ.get("TIDY3D_TPU_MODE_SOLVER")
    os.environ["TIDY3D_TPU_MODE_SOLVER"] = route
    n_rec = len(device_solver.RECORDS)
    try:
        t0 = time.perf_counter()
        data = ModeSolver(simulation=sim, plane=plane, mode_spec=spec,
                          freqs=list(freqs), colocate=False).solve(device)
        secs = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("TIDY3D_TPU_MODE_SOLVER", None)
        else:
            os.environ["TIDY3D_TPU_MODE_SOLVER"] = old
    return data, secs, device_solver.RECORDS[n_rec:]


def filter_pass_costs(apply_m, rec: dict, smi: str) -> dict:
    """One filter pass on the solve's own operator at its block width:
    eager and captured-graph ms per pass (CUDA events) at degrees 50 and
    200, the ATen operations one eager pass of degree 50 dispatches (views
    included) and the kernel records the profiler sees in it."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from tidy3d_tpu_torch.plugins.mode import device_solver

    nx, ny = apply_m.shape2d
    n2 = 2 * nx * ny
    x = torch.randn((n2, rec["k_sub"]), device="cuda")

    def block(q):
        return apply_m(q.reshape(2, nx, ny, -1)).reshape(n2, -1)

    args = (rec["lo"], 0.0, rec["lam_hi"])

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            Count.ops += 1
            return func(*a, **(kw or {}))

    out = {}
    with device_solver.full_f32_matmul():
        graph = device_solver._GraphFilter(block, (n2, rec["k_sub"]),
                                           x.device)
        for deg in (50, 200):
            eager = cuda_ms(lambda: device_solver._chebyshev_filter(
                block, x, *args, deg), 3)
            graphed = cuda_ms(lambda: graph(x, *args, deg), 5)
            out[deg] = (eager, graphed)
        with Count():
            device_solver._chebyshev_filter(block, x, *args, 50)
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            device_solver._chebyshev_filter(block, x, *args, 50)
            sync()
    records = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    log(f"[mode] filter pass on {nx}x{ny}, block {rec['k_sub']} columns: "
        f"degree 50 eager {out[50][0]:.3f} ms, graph {out[50][1]:.3f} ms; "
        f"degree 200 eager {out[200][0]:.3f} ms, graph {out[200][1]:.3f} "
        f"ms; a pass of degree 50 dispatches {Count.ops} ATen operations "
        f"(views included, {Count.ops / 50:.1f} a step) and launches "
        f"{records} kernels ({records / 50:.1f} a step, profiler records) "
        f"| {smi}")
    return dict(ms=out, ops=Count.ops, records=records)


def run_mode_solver(td, smi: str) -> dict:
    """Phase 26: the device mode solver on the card against ARPACK on the
    host, on the waveguide's source plane (100 x 100) and on a 200 x 200
    plane of the same strip at dl = 0.01, 2 modes at 1.55 um: n_eff within
    ``TOL_NEFF``, each mode's Ex and Ey overlap above ``MIN_OVERLAP``, no
    fallback; each route's host seconds, the filter's outer iterations,
    final degree and split; one filter pass's cost; then the mode
    monitor's 11-frequency solve by both routes. Returns the ARPACK and
    filter seconds of that solve."""
    from tidy3d_tpu_torch.plugins.mode import device_solver

    sim = waveguide_case(td)
    freq0 = td.C_0 / 1.55
    spec = td.ModeSpec(num_modes=2)
    fallbacks = device_solver.FALLBACKS
    made = []
    make = device_solver.make_apply_real

    def keep(*args, **kw):
        made.append(make(*args, **kw))
        return made[-1]

    for what, case, plane in (
            ("100x100 source plane", sim, sim.sources[0].geometry),
            ("200x200 plane at dl 0.01", fine_plane_case(td),
             td.Box(center=(0, 0, 0), size=(0, 2.0, 2.0)))):
        ref, t_arpack, recs = mode_solve(td, case, plane, spec, [freq0],
                                         "arpack", "cpu")
        assert not recs, recs
        device_solver.make_apply_real = keep
        try:
            got, t_filter, recs = mode_solve(td, case, plane, spec, [freq0],
                                             "filter", "cuda")
        finally:
            device_solver.make_apply_real = make
        assert len(recs) == 1 and recs[0]["device"] == "cuda", recs
        rec = recs[0]
        assert not rec["fallback"] and device_solver.FALLBACKS == fallbacks
        n_ref = np.asarray(ref.n_complex.values)[0]
        n_got = np.asarray(got.n_complex.values)[0]
        d_neff = float(np.max(np.abs(n_got.real - n_ref.real)))
        overlaps = [_overlap(getattr(ref, c).values[..., 0, m],
                             getattr(got, c).values[..., 0, m])
                    for m in range(2) for c in ("Ex", "Ey")]
        nx, ny = rec["shape"]
        log(f"[mode] {what} ({nx}x{ny}, 2N = {2 * nx * ny}): ARPACK (host) "
            f"{t_arpack:.3f} s, filter (card) {t_filter:.3f} s; n_eff "
            f"{n_got.real.tolist()} against {n_ref.real.tolist()}, max "
            f"|dn_eff| {d_neff:.2e} (tol {TOL_NEFF:g}); overlaps "
            f"{[round(o, 8) for o in overlaps]}; {rec['outer']} outer "
            f"iterations, final degree {rec['degree']}, {rec['passes']} "
            f"passes of {rec['steps']} steps, block {rec['k_sub']}; device "
            f"loop {rec['device_s']:.3f} s, basis fetch "
            f"{rec['fetch_s']:.4f} s, host polish {rec['polish_s']:.3f} s, "
            f"refinement {rec['refine_s']:.3f} s | {smi}")
        assert d_neff <= TOL_NEFF, (n_got, n_ref)
        assert min(overlaps) > MIN_OVERLAP, overlaps
        if what.startswith("100x100"):
            filter_pass_costs(made[-1], rec, smi)
    mon = next(m for m in sim.monitors if m.name == "mode")
    _, t_arpack, _ = mode_solve(td, sim, mon.geometry, mon.mode_spec,
                                mon.freqs, "arpack", "cpu")
    held = torch.cuda.memory_allocated()
    _, t_filter, recs = mode_solve(td, sim, mon.geometry, mon.mode_spec,
                                   mon.freqs, "filter", "cuda")
    held = torch.cuda.memory_allocated() - held
    assert len(recs) == 11 and device_solver.FALLBACKS == fallbacks
    # the solves' graphs and blocks are freed: 11 solves hold no more than
    # a GEMM workspace
    assert held <= 64 * 2**20, held
    split = {k: sum(r[k] for r in recs)
             for k in ("device_s", "fetch_s", "polish_s", "refine_s")}
    log(f"[mode] mode monitor (11 frequencies, 2 modes, 100x100): ARPACK "
        f"(host) {t_arpack:.3f} s, filter (card) {t_filter:.3f} s; device "
        f"loop {split['device_s']:.3f} s, basis fetch {split['fetch_s']:.4f}"
        f" s, host polish {split['polish_s']:.3f} s, refinement "
        f"{split['refine_s']:.3f} s; outer iterations "
        f"{[r['outer'] for r in recs]}; device memory held after the "
        f"solves {held / 2**20:.1f} MiB | {smi}")
    return {"arpack_s": t_arpack, "filter_s": t_filter}


def run_job(td, smi: str) -> int:
    """Phase 27: ``web.Job(...).run()`` of the 64x48x80 mixed case with the
    broadband DFT monitors, its launch counts set to 0 just before and read
    just after: the launches and the flux of ``web.run`` of the same case.
    Returns the k-step launches."""
    from tidy3d_tpu_torch.solver.kernels import fused, kstep, step

    sim = mixed_dft_case(td)
    runs = {}
    for how in ("web.run", "web.Job"):
        step.LAUNCHES = fused.LAUNCHES = kstep.LAUNCHES = 0
        if how == "web.run":
            data = td.web.run(sim, task_name="chip_smoke", verbose=False)
        else:
            data = td.web.Job(simulation=sim, task_name="chip_smoke_job",
                              verbose=False).run()
        runs[how] = (data, {"family": step.LAUNCHES, "fused": fused.LAUNCHES,
                            "kstep": kstep.LAUNCHES})
    (want, n_want), (got, n_got) = runs["web.run"], runs["web.Job"]
    flux = np.asarray(got["flux"].flux.values)
    log(f"[job] web.Job of the 64x48x80 mixed case: launches {n_got} "
        f"(web.run {n_want}), log: "
        f"{' | '.join(got.log.splitlines()[2:])}; flux {flux.tolist()}")
    assert n_got == n_want and n_got["kstep"] > 0, (n_got, n_want)
    assert np.all(np.isfinite(flux)) and np.all(flux != 0)
    assert np.array_equal(flux, want["flux"].flux.values)
    return n_got["kstep"]


def run_farfield(td, smi: str, rate_without: float) -> int:
    """Phase 17: the broadband case with a projection box around its Ez
    dipole through ``web.run``: |E_theta| isotropic in phi at theta = pi/2
    and within ``TOL_PATTERN`` of sin(theta) from 30 to 150 degrees.
    Returns the k-step launches."""
    none = {"family": 0, "fused": 0, "kstep": 0}
    w = web_run(td, farfield_case(td), "far field, default tier", smi)
    assert w.launches == dict(none, kstep=w.steps // 2), w.launches
    e = np.abs(np.asarray(w.data["far"].Etheta.values))[0, :, :, 0]
    assert e.shape == (len(FAR_THETA), len(FAR_PHI)) and np.all(e > 0)
    i90 = int(np.argmin(np.abs(FAR_THETA - np.pi / 2)))
    iso = float(e[i90].max() / e[i90].min())
    pattern = e / e[i90][None, :]
    dev_theta = np.max(np.abs(pattern / np.sin(FAR_THETA)[:, None] - 1),
                       axis=1)
    dev = float(dev_theta.max())
    log(f"[far field] |E_theta| at theta = 90 deg over phi: max/min {iso:.4f}"
        f" (below 1.1); |E_theta(theta)| / |E_theta(90)| / sin(theta) - 1: "
        f"max {dev:.4f} (within {TOL_PATTERN:g}) over theta 30..150 deg, by "
        f"theta {np.round(dev_theta, 4).tolist()}; "
        f"host seconds of the projection {w.host['far']:.3f}; Gcell*steps/s "
        f"{w.rate} (without the projection box {rate_without}) | {smi}")
    assert iso < 1.1 and dev <= TOL_PATTERN, (iso, dev)
    return w.launches["kstep"] + rates_in_turns(
        td, farfield_case(td), full_case(td), "far field", smi, w.rate,
        rate_without)


def run_diffraction(td, smi: str, rate_without: float) -> int:
    """Phase 18: the angled plane wave (two-copy k-step kernel) with a
    diffraction plane through ``web.run``: the (0, 0) order holds more than
    98 % of the diffracted power and the total is within 0.1 of 1. Returns
    the k-step launches."""
    none = {"family": 0, "fused": 0, "kstep": 0}
    w = web_run(td, diffraction_case(td), "diffraction, default tier", smi,
                field=None)
    assert w.launches == dict(none, kstep=w.steps // 2), w.launches
    dd = w.data["diff"]
    power = np.abs(np.asarray(dd.amps.values)) ** 2
    total = float(power.sum())
    o_x = list(np.atleast_1d(dd.orders_x))
    o_y = list(np.atleast_1d(dd.orders_y))
    p0 = float(power[o_x.index(0), o_y.index(0)].sum())
    log(f"[diffraction] orders {o_x} x {o_y}: (0, 0) holds {p0 / total:.6f} "
        f"of the power (above 0.98), total {total:.6f} (within 0.1 of 1; "
        f"cos 25 deg = {np.cos(np.deg2rad(25.0)):.6f}); host seconds of the "
        f"diffraction sums {w.host['diff']:.3f}; Gcell*steps/s {w.rate} "
        f"(without the plane {rate_without}) | {smi}")
    assert p0 / total > 0.98 and abs(total - 1.0) < 0.1, (p0, total)
    return w.launches["kstep"] + rates_in_turns(
        td, diffraction_case(td), planewave_case(td), "diffraction", smi,
        w.rate, rate_without)


def rates_in_turns(td, with_sim, without_sim, what: str, smi: str,
                   rate_with: float, rate_without: float) -> int:
    """A second run of a case without and then with its new monitors,
    after the first pair (the case without them ran in an earlier phase):
    Gcell*steps/s of each, in turns. Returns the k-step launches."""
    none = {"family": 0, "fused": 0, "kstep": 0}
    runs = [web_run(td, sim, f"{what} {name} the new monitors, default "
                    "tier", smi, field=None)
            for name, sim in (("without", without_sim), ("with", with_sim))]
    for r in runs:
        assert r.launches == dict(none, kstep=r.steps // 2), r.launches
    log(f"[{what}] Gcell*steps/s in turns: without the new monitors "
        f"{[rate_without, runs[0].rate]}, with {[rate_with, runs[1].rate]} "
        f"| {smi}")
    return sum(r.launches["kstep"] for r in runs)


def resume_case(make_runner, plan, what: str, smi: str) -> None:
    """Phase 19 for one case: the uninterrupted run, half of the chunks in a
    fresh runner through ``run_steps`` then ``save_checkpoint``, the rest in
    a third runner through ``run_checkpointed``; the raw monitors agree to
    ``TOL_RESUME`` of their largest magnitude."""
    from tidy3d_tpu_torch.solver.kernels import fused, kstep, step

    os.makedirs(CKPT_DIR, exist_ok=True)
    path = os.path.join(CKPT_DIR, "resume.npz")
    step.LAUNCHES = fused.LAUNCHES = kstep.LAUNCHES = 0
    r0 = make_runner(plan)
    ref = r0.run()
    steps, k = r0.steps_run, r0.k
    del r0
    r1 = make_runner(plan)
    chunk, num_chunks = r1.chunking()
    half = num_chunks // 2
    state, max_ever = r1.init_state(), 0.0
    for ci in range(half):
        state = r1.run_steps(ci * chunk, chunk, state)
        cur = float(r1._max_field(state))
        max_ever = max(max_ever, cur)
    sync()
    nbytes_file = r1.save_checkpoint(path, state, half, max_ever, cur)
    save_s = r1.checkpoint_save_s
    del state, r1
    r2 = make_runner(plan)
    got = r2.run_checkpointed(path, checkpoint_every=num_chunks)
    launches = {"family": step.LAUNCHES, "fused": fused.LAUNCHES,
                "kstep": kstep.LAUNCHES}
    assert not os.path.exists(path)
    assert r2.steps_run == steps, (r2.steps_run, steps)
    groups = steps // k
    shards = len(r2.shards) if r2.shards else 1
    # the uninterrupted run, then its two halves
    want = 2 * shards * groups
    assert launches == {"family": 0, "fused": 0, "kstep": want}, launches
    err = raw_err(ref, got)
    log(f"[resume] {what}: {num_chunks} chunks of {chunk} steps, saved after "
        f"{half}: file {nbytes_file} B ({nbytes_file / 2**30:.3f} GiB), save "
        f"{save_s:.2f} s, load {r2.checkpoint_load_s:.2f} s; resumed vs "
        f"uninterrupted max rel err {err:.3e} (tol {TOL_RESUME:g}); "
        f"launches {launches} | {smi}")
    assert err <= TOL_RESUME, f"{what}: resumed rel err {err:.3e}"
    del r2


def run_resume(td, dev, plan_d, smi: str) -> None:
    """Phase 19: resume on the kstep tier at 384^3 (dispersive), on 4
    virtual x-shards (dispersive) and on the Bloch dipole (256^3)."""
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
    from tidy3d_tpu_torch.solver.lowering import lower

    resume_case(lambda p: FDTDRunner(p, device=dev), plan_d,
                "dispersive 384^3, kstep tier", smi)
    torch.cuda.empty_cache()
    resume_case(lambda p: sharded_runner(p, [dev] * 4), plan_d,
                "dispersive 384^3, 4 virtual x-shards", smi)
    torch.cuda.empty_cache()
    resume_case(lambda p: FDTDRunner(p, device=dev), lower(bloch_case(td)),
                "Bloch dipole 256^3, two copies", smi)
    torch.cuda.empty_cache()


PROFILE_SCRIPT = """
import json, os, sys
import tidy3d_tpu_torch as td
from tidy3d_tpu_torch.solver.kernels import fused, kstep, step
import chip_smoke
sim = chip_smoke.full_case(td).copy(update=dict(run_time=2e-14))
step.LAUNCHES = fused.LAUNCHES = kstep.LAUNCHES = 0
data = td.web.run(sim, task_name="chip_smoke", verbose=False)
print(json.dumps({"launches": {"family": step.LAUNCHES,
                               "fused": fused.LAUNCHES,
                               "kstep": kstep.LAUNCHES},
                  "log": data.log}))
"""


def trace_counts(path: str) -> dict:
    """Of a Chrome trace: the k-step kernel's records on the device and the
    runner's ``fdtd.monitors`` ranges."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return {
        "kstep_kernel": sum(1 for e in events if e.get("cat") == "kernel"
                            and "kstep_kernel" in e.get("name", "")),
        "fdtd.monitors": sum(1 for e in events
                             if e.get("name") == "fdtd.monitors"),
        "events": len(events)}


def run_profiled(smi: str) -> int:
    """Phase 20: a short ``web.run`` of the broadband case (212 steps) under
    ``TIDY3D_TPU_PROFILE`` in a process of its own (torch.profiler loses
    kernel records late in a long process, ``PERF.md`` section 7): the
    trace must hold the k-step kernel's records and ``fdtd.monitors``
    ranges. Returns the k-step launches."""
    import glob
    import shutil
    import subprocess

    trace_dir = os.path.join(OUT_DIR, "chip_smoke_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    env = dict(os.environ, TIDY3D_TPU_PROFILE=trace_dir)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__))]
        + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", PROFILE_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=600,
                          check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    assert len(traces) == 1, traces
    counts = trace_counts(traces[0])
    lines = out["log"].splitlines()
    steps = int(lines[1].split("steps run: ")[1].split(" ")[0])
    log(f"[profiler] web.run under TIDY3D_TPU_PROFILE: {steps} steps, "
        f"launches {out['launches']}, trace {traces[0]} "
        f"({os.path.getsize(traces[0])} B): {counts}; the process took "
        f"{time.perf_counter() - t0:.1f} s; log: {' | '.join(lines[2:4])}")
    assert out["launches"] == {"family": 0, "fused": 0, "kstep": steps // 2}
    assert counts["kstep_kernel"] > 0 and counts["fdtd.monitors"] > 0, counts
    shutil.rmtree(trace_dir, ignore_errors=True)
    return out["launches"]["kstep"]


def run_memory(td, smi: str) -> None:
    """Phase 21: every main-path run's estimate against its measured peak
    (the peak less what was allocated before it), then the gate: a limit
    one byte below the broadband case's estimate makes ``web.run`` raise
    ``SetupError`` before any launch."""
    from tidy3d_tpu_torch.exceptions import SetupError
    from tidy3d_tpu_torch.solver.kernels import fused, kstep, step

    for what, est, peak, base in MEMORY:
        log(f"[memory] {what}: estimate {est / 2**30:.3f} GiB, peak "
            f"{peak / 2**30:.3f} GiB ({base / 2**30:.3f} allocated before), "
            f"estimate / run's peak {est / max(peak - base, 1):.3f}")
    low = [m for m in MEMORY if m[1] < m[2] - m[3]]
    assert not low, f"estimates below the peak: {low}"
    est = next(m[1] for m in MEMORY if m[0] == "far field, default tier")
    os.environ["TIDY3D_TPU_HBM_BYTES"] = str(est - 1)
    step.LAUNCHES = fused.LAUNCHES = kstep.LAUNCHES = 0
    kstep.DEVICE_LAUNCHES = 0
    try:
        td.web.run(farfield_case(td), task_name="chip_smoke", verbose=False)
        raise AssertionError("web.run ran past a limit below its estimate")
    except SetupError as err:
        refused = str(err)
    finally:
        del os.environ["TIDY3D_TPU_HBM_BYTES"]
    launches = {"family": step.LAUNCHES, "fused": fused.LAUNCHES,
                "kstep": kstep.LAUNCHES, "device": kstep.DEVICE_LAUNCHES}
    log(f"[memory] TIDY3D_TPU_HBM_BYTES={est - 1}: web.run raised "
        f"SetupError ({refused[:160]}...), launches {launches} | {smi}")
    assert not any(launches.values()), launches
    torch.cuda.empty_cache()


class ModeSolveClock:
    """Times every mode solve (``plugins/mode/mode_solver.compute_modes``)
    while it is entered: ``solves`` holds ``(end perf_counter, host
    seconds)`` of each."""

    def __enter__(self):
        from tidy3d_tpu_torch.plugins.mode import mode_solver

        self.module, self.inner = mode_solver, mode_solver.compute_modes
        self.solves = []

        def timed_solve(*args, **kwargs):
            t0 = time.perf_counter()
            out = self.inner(*args, **kwargs)
            t1 = time.perf_counter()
            self.solves.append((t1, t1 - t0))
            return out

        mode_solver.compute_modes = timed_solve
        return self

    def __exit__(self, *exc):
        self.module.compute_modes = self.inner

    def seconds(self, start: float, end: float) -> float:
        """Host seconds of the solves that ended in ``[start, end]``."""
        return sum(s for t, s in self.solves if start <= t <= end)


class RegionClock:
    """Records every ``TopologyDesignRegion.transform`` and ``penalty`` call
    while it is entered: ``calls`` holds ``(name, device of the
    parameters, host seconds)``, the card synchronised around each."""

    def __enter__(self):
        from tidy3d_tpu_torch.plugins.invdes.region import \
            TopologyDesignRegion

        self.cls, self.calls = TopologyDesignRegion, []
        self.inner = {name: getattr(TopologyDesignRegion, name)
                      for name in ("transform", "penalty")}

        def timed(name, fn):
            def call(region, params, *args, **kwargs):
                if torch.cuda.is_available():
                    sync()
                t0 = time.perf_counter()
                out = fn(region, params, *args, **kwargs)
                if torch.cuda.is_available():
                    sync()
                self.calls.append((name, str(getattr(params, "device",
                                                     "numpy")),
                                   time.perf_counter() - t0))
                return out
            return call

        for name, fn in self.inner.items():
            setattr(TopologyDesignRegion, name, timed(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.inner.items():
            setattr(self.cls, name, fn)


def region_ops(region, params, cotangent, dl: float, device) -> list:
    """The region's transformation at ``params`` and its VJP of
    ``cotangent``, its penalty and the penalty's gradient, on ``device``
    (four tensors), as ``InverseDesign.objective_fn`` takes them."""
    from tidy3d_tpu_torch.plugins.autograd.functions import full_f32_conv

    with full_f32_conv():
        p = torch.as_tensor(params, device=device).requires_grad_(True)
        density = region.transform(p, dl=dl)
        (vjp,) = torch.autograd.grad(
            density, p, torch.as_tensor(cotangent, device=device))
        q = torch.as_tensor(params, device=device).requires_grad_(True)
        pen = region.penalty(q, dl=dl)
        (g_pen,) = torch.autograd.grad(pen, q)
    return [density.detach(), vjp, pen.detach(), g_pen]


def split_record(rec: dict, clock: ModeSolveClock) -> dict:
    """One ``run_structure_gradients`` call's host seconds: the forward run
    and the adjoint run without their mode solves and kernel builds, the
    mode solves (the source's and the monitor's in the forward run, the
    re-solve on the monitor plane that makes the adjoint currents, the
    adjoint run's), the kernel builds, the objective's VJP with the
    adjoint simulation's set-up and the gradient assembly; and each run's
    tier, source terms, steps, Gcell*steps/s and peak device memory from
    its log."""
    stages = ("forward", "vjp", "adjoint", "assembly")
    t, mode = rec["started"], {}
    for stage in stages:
        end = t + rec[f"{stage}_s"]
        mode[stage] = clock.seconds(t, end)
        t = end
    out = {"mode_s": sum(mode.values()), "build_s": 0.0}
    for run in ("forward", "adjoint"):
        lines = rec[f"{run}_log"].splitlines()
        wall = log_field(lines, "wall time: ")
        build = float(wall.split(" s compile")[0].rsplit("+", 1)[1])
        out["build_s"] += build
        out[run] = {"tier": log_field(lines, "kernel tier: "),
                    "sources": log_field(lines, "source terms: "),
                    "rate": log_rate(lines),
                    "peak": log_memory(lines)["peak"],
                    "steps": log_field(lines, "steps run: ")}
        out[f"{run}_s"] = rec[f"{run}_s"] - mode[run] - build
    out["vjp_s"] = rec["vjp_s"] - mode["vjp"]
    out["assembly_s"] = rec["assembly_s"] - mode["assembly"]
    return out


def objective_of(td, data) -> float:
    """|mode 0 amplitude|^2 forward at the ``out`` monitor: the objective
    of ``InverseDesign(output_monitor_name="out")``."""
    amps = data["out"].amps.sel(direction="+", mode_index=0).values
    return float(np.sum(np.abs(amps) ** 2))


def run_invdes_3d(td, smi: str, clock: ModeSolveClock) -> None:
    """Phase 29a: the production route (two ``web.run`` solves on the k-step
    kernel per iteration) on ``invdes_case``: the adjoint gradient at the
    uniform density 0.5, ``INVDES_STEPS`` Adam steps, then central
    differences of the objective along the uniform direction and on the
    ``fd_block`` block at the largest |g|."""
    from tidy3d_tpu_torch.plugins import invdes
    from tidy3d_tpu_torch.plugins.autograd.functions import full_f32_conv
    from tidy3d_tpu_torch.web import autograd as web_autograd

    sim = invdes_case(td)
    region = invdes_region(invdes)
    design = invdes.InverseDesign(simulation=sim, design_region=region,
                                  output_monitor_name="out")
    assert design.device == "cuda" and design.method == "adjoint"
    shape = region.params_shape(sim)
    log(f"[invdes] grid {sim.grid.num_cells} = "
        f"{int(np.prod(sim.grid.num_cells))} cells, design region {shape}")
    assert shape == INVDES_SHAPE, shape
    rho0 = design.initial_parameters().astype(np.float32)

    def record(what, rec):
        r = split_record(rec, clock)
        for run in ("forward", "adjoint"):
            log(f"[invdes] {what} {run} run: kernel tier: {r[run]['tier']}; "
                f"source terms {r[run]['sources']}; {r[run]['steps']} steps;"
                f" {r[run]['rate']} Gcell*steps/s; peak device memory "
                f"{r[run]['peak']} B")
            assert r[run]["tier"].startswith("kstep (k=2)"), r[run]
        log(f"[invdes] {what} host seconds: forward run {r['forward_s']:.3f}"
            f", adjoint run {r['adjoint_s']:.3f}, mode solves "
            f"{r['mode_s']:.3f}, objective VJP and adjoint set-up "
            f"{r['vjp_s']:.3f}, gradient assembly {r['assembly_s']:.3f}, "
            f"kernel build {r['build_s']:.3f} | {smi}")

    web_autograd.RECORDS.clear()
    v0, g0 = design._density_value_and_grad_adjoint(rho0)
    record("gradient at 0.5", web_autograd.RECORDS[0])
    assert g0.shape == shape and np.all(np.isfinite(g0)) and v0 > 0

    web_autograd.RECORDS.clear()
    t0 = time.perf_counter()
    with RegionClock() as regions:
        result = invdes.AdamOptimizer(design=design, num_steps=INVDES_STEPS,
                                      learning_rate=INVDES_LR).run(rho0)
    adam_s = time.perf_counter() - t0
    recs = list(web_autograd.RECORDS)
    assert len(recs) == INVDES_STEPS, len(recs)
    for i, rec in enumerate(recs):
        record(f"Adam iteration {i + 1}", rec)
    for name in ("transform", "penalty"):
        calls = [c for c in regions.calls if c[0] == name]
        log(f"[invdes] Adam: {len(calls)} {name} calls, parameters on "
            f"{sorted({c[1] for c in calls})}, forward host s "
            f"{[round(c[2], 4) for c in calls]}")
        assert len(calls) == INVDES_STEPS, calls
        assert all(c[1].startswith("cuda") for c in calls), calls
    with full_f32_conv():
        pen0 = float(region.penalty(torch.as_tensor(rho0, device="cuda"),
                                    dl=design._dl))
    hist = list(result.objective_history)
    log(f"[invdes] Adam ({INVDES_STEPS} steps, learning rate {INVDES_LR}): "
        f"objective (|amp|^2 - penalty) {hist} in {adam_s:.1f} s; the "
        f"first plus the penalty {pen0:.6e} at 0.5 is "
        f"{abs(hist[0] + pen0 - v0) / v0:.2e} from the gradient run's {v0}")
    assert hist[-1] > hist[0], hist
    assert abs(hist[0] + pen0 - v0) <= 1e-5 * v0, (hist[0], pen0, v0)
    run_region_ops(region, sim, g0, design._dl, smi)

    def objective(rho) -> float:
        """The objective at density ``rho`` (no transformation)."""
        sim_rho = sim.copy(update=dict(structures=tuple(sim.structures) + (
            region.to_structure(rho, sim),)))
        data = td.web.run(sim_rho, task_name="invdes_fd", verbose=False)
        return objective_of(td, data)

    t0 = time.perf_counter()
    h = 5e-3
    fd_u = (objective(rho0 + h / 2) - objective(rho0 - h / 2)) / h
    err_u = abs(float(np.sum(g0)) / fd_u - 1.0)
    block = fd_block(g0)
    mask = np.zeros(shape, np.float32)
    mask[block] = 1.0
    hb = 0.02
    fd_b = (objective(rho0 + hb * mask) - objective(rho0 - hb * mask)) \
        / (2 * hb)
    g_b = float(np.sum(g0[block]))
    err_b = abs(g_b / fd_b - 1.0)
    log(f"[invdes] adjoint against central differences at 0.5: uniform "
        f"sum(g) {float(np.sum(g0)):.6e} vs FD {fd_u:.6e} (rel {err_u:.3e}, "
        f"tol {TOL_FD_UNIFORM}); block {block[:2]} x all z: sum(g) "
        f"{g_b:.6e} vs FD {fd_b:.6e} (rel {err_b:.3e}, tol "
        f"{TOL_FD_BLOCK}); 4 runs in {time.perf_counter() - t0:.1f} s")
    assert err_u <= TOL_FD_UNIFORM and err_b <= TOL_FD_BLOCK, (err_u, err_b)


def run_region_ops(region, sim, cotangent, dl: float, smi: str) -> None:
    """The design region's transformation with its VJP of ``cotangent`` and
    its penalty with its gradient (``region_ops``), at the region's seeded
    random parameters: the card against the CPU, within ``TOL_CARD_CPU``
    of each output's largest magnitude, and both timed."""
    params = region.random_parameters(sim).astype(np.float32)
    cot = np.asarray(cotangent, np.float32)
    card = region_ops(region, params, cot, dl, "cuda")
    cpu = region_ops(region, params, cot, dl, "cpu")
    errs = []
    for got, want in zip(card, cpu):
        want = want.numpy()
        errs.append(float(np.max(np.abs(got.cpu().numpy() - want))
                          / np.max(np.abs(want))))
    ms = cuda_ms(lambda: region_ops(region, params, cot, dl, "cuda"), 5)
    t0 = time.perf_counter()
    region_ops(region, params, cot, dl, "cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    log(f"[invdes] region on the card (conic filter radius {region.radius}"
        f" um, beta {region.beta}, penalty weight {region.penalty_weight},"
        f" {params.shape}): transformation, VJP, penalty and its gradient "
        f"{ms:.3f} ms (CUDA events), CPU {cpu_ms:.1f} ms (host clock); card"
        f" vs CPU: density {errs[0]:.2e}, VJP {errs[1]:.2e}, penalty "
        f"{errs[2]:.2e}, its gradient {errs[3]:.2e} of max (tol "
        f"{TOL_CARD_CPU:g}) | {smi}")
    assert max(errs) <= TOL_CARD_CPU, errs


def run_invdes_2d(td, smi: str) -> int:
    """Phase 29b: the coupling case on both routes, card against CPU on one
    tier, the autodiff route against central differences, its ms per
    forward + backward step and peak memory at ``CHUNKS``. Returns the
    k-step launches of the adjoint route on the card."""
    from tidy3d_tpu_torch.plugins import invdes
    from tidy3d_tpu_torch.plugins.adjoint import TopologyObjective
    from tidy3d_tpu_torch.solver.kernels import fused, kstep, step

    sim = coupling_case(td)
    region = td.Box(**coupling_region(td))
    rho = 0.5 * np.ones((21, 31, 1), np.float32)

    # the adjoint route on the k-step tier: the kernel on the card, its
    # plain version on the CPU
    old = os.environ.get("TIDY3D_TPU_KERNEL")
    os.environ["TIDY3D_TPU_KERNEL"] = "kstep"
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            design = invdes.InverseDesign(
                simulation=sim, output_monitor_name="out", device=dev,
                design_region=invdes.TopologyDesignRegion(
                    **coupling_region(td), eps_bounds=(1.0, 6.0)))
            t0 = time.perf_counter()
            out[dev] = design._density_value_and_grad_adjoint(rho)
            log(f"[invdes 2D] adjoint route on {dev} (kstep): value "
                f"{out[dev][0]}, {time.perf_counter() - t0:.2f} s")
    finally:
        if old is None:
            os.environ.pop("TIDY3D_TPU_KERNEL", None)
        else:
            os.environ["TIDY3D_TPU_KERNEL"] = old
    n_adjoint = kstep.LAUNCHES
    assert n_adjoint > 0 and step.LAUNCHES == fused.LAUNCHES == 0
    (v_c, g_c), (v_h, g_h) = out["cuda"], out["cpu"]
    err_adj = float(np.max(np.abs(g_c - g_h)) / np.max(np.abs(g_h)))
    log(f"[invdes 2D] adjoint gradient card vs CPU: {err_adj:.3e} of max "
        f"|g| (tol {TOL_CARD_CPU:g}); values {abs(v_c - v_h) / v_h:.3e} "
        "apart")
    assert err_adj <= TOL_CARD_CPU, err_adj

    # the autodiff route: no kernel
    topo = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        topo[dev] = TopologyObjective(sim, region, eps_min=1.0, eps_max=6.0,
                                      mode_monitor_name="out", device=dev)
        step.LAUNCHES = fused.LAUNCHES = kstep.LAUNCHES = 0
        out[dev] = topo[dev].value_and_grad(rho)
        launches = (step.LAUNCHES, fused.LAUNCHES, kstep.LAUNCHES)
        log(f"[invdes 2D] autodiff on {topo[dev].runner.device}: value "
            f"{out[dev][0]}, {time.perf_counter() - t0:.2f} s (set-up "
            f"included), kernel launches {launches}")
        assert launches == (0, 0, 0), launches
    (v_c, g_c), (v_h, g_h) = out["cuda"], out["cpu"]
    err_ad = float(np.max(np.abs(g_c - g_h)) / np.max(np.abs(g_h)))
    log(f"[invdes 2D] autodiff gradient card vs CPU: {err_ad:.3e} of max "
        f"|g| (tol {TOL_CARD_CPU:g}); values {abs(v_c - v_h) / v_h:.3e} "
        "apart")
    assert err_ad <= TOL_CARD_CPU, err_ad
    card = topo["cuda"]
    idx = np.unravel_index(np.argmax(np.abs(g_c)), g_c.shape)
    h = 5e-3
    rp, rm = rho.copy(), rho.copy()
    rp[idx] += h
    rm[idx] -= h
    fd = (card.value(rp) - card.value(rm)) / (2 * h)
    err_fd = abs(fd - g_c[idx]) / abs(fd)
    log(f"[invdes 2D] autodiff on the card vs central differences at pixel "
        f"{idx}: {g_c[idx]:.6e} vs {fd:.6e} (rel {err_fd:.3e}, tol "
        f"{TOL_FD_PIXEL})")
    assert err_fd <= TOL_FD_PIXEL, err_fd

    for chunks in CHUNKS:
        time_autodiff(topo["cuda"], rho, chunks, smi)
    return n_adjoint


class GcClock:
    """Counts Python's garbage collections and their host seconds while it
    is entered (``gc.callbacks``)."""

    def __enter__(self):
        import gc

        self.count, self.seconds, self._t0 = 0, 0.0, None
        gc.callbacks.append(self._call)
        return self

    def _call(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.count += 1
            self.seconds += time.perf_counter() - self._t0

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._call)


def time_autodiff(topo, rho, chunks: int, smi: str) -> float:
    """The autodiff route's host ms per forward + backward step of
    ``topo`` (a ``TopologyObjective`` on the card) at density ``rho`` in
    ``chunks`` checkpoint chunks, the card synchronised at the ends; logs
    the forward and backward ms per step, the peak device memory, and the
    garbage collections in the timed window with their host seconds and
    the objects Python tracks."""
    import gc

    from tidy3d_tpu_torch.solver.fdtd import AUTODIFF_TIER

    topo.run_fn = topo.runner.make_differentiable_run(
        checkpoint_chunks=chunks)
    dens = torch.as_tensor(rho, device="cuda")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sync()
    with GcClock() as gcs:
        t0 = time.perf_counter()
        r = dens.clone().requires_grad_(True)
        val = topo.loss(r)
        sync()
        t1 = time.perf_counter()
        torch.autograd.grad(val, r)
        sync()
        t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() - base
    size, n = topo.runner.checkpoint_chunks
    steps = size * n
    log(f"[invdes 2D] {AUTODIFF_TIER}: {chunks} chunks of {size} steps: "
        f"forward {(t1 - t0) / steps * 1e3:.3f} ms/step, backward "
        f"(recompute included) {(t2 - t1) / steps * 1e3:.3f} ms/step, "
        f"forward + backward {(t2 - t0) / steps * 1e3:.3f} ms/step; peak "
        f"device memory {peak} B above the {base} B held before; "
        f"{gcs.count} garbage collections in the window, "
        f"{gcs.seconds:.3f} host s, {len(gc.get_objects())} objects "
        f"tracked | {smi}")
    return (t2 - t0) / steps * 1e3


def run_autodiff_timing(td, smi: str) -> None:
    """Phase 29b's autodiff timing alone (a ``TopologyObjective`` of the
    coupling case on the card at density 0.5, one value and gradient
    first, as phase 29b takes them before it times, then ``time_autodiff``
    at each of ``CHUNKS``), for a process of its own: the numbers to set
    beside those phase 29 takes after every earlier phase."""
    from tidy3d_tpu_torch.plugins.adjoint import TopologyObjective

    topo = TopologyObjective(coupling_case(td), td.Box(**coupling_region(td)),
                             eps_min=1.0, eps_max=6.0,
                             mode_monitor_name="out", device="cuda")
    rho = 0.5 * np.ones((21, 31, 1), np.float32)
    topo.value_and_grad(rho)
    for chunks in CHUNKS:
        time_autodiff(topo, rho, chunks, smi)


def run_invdes(td, smi: str) -> int:
    """Phase 29: inverse design on the card; the launch counts set to 0
    just before and read just after. Returns the k-step launches."""
    from tidy3d_tpu_torch.solver.kernels import fused, kstep, step

    t_phase = time.perf_counter()
    step.LAUNCHES = fused.LAUNCHES = kstep.LAUNCHES = 0
    with ModeSolveClock() as clock:
        run_invdes_3d(td, smi, clock)
    n = kstep.LAUNCHES
    assert n > 0 and step.LAUNCHES == fused.LAUNCHES == 0, \
        (n, step.LAUNCHES, fused.LAUNCHES)
    log(f"[invdes] 3D: {n} k-step launches, no other kernel; "
        f"{len(clock.solves)} mode solves, "
        f"{sum(sec for _, sec in clock.solves):.3f} host s")
    t_3d = time.perf_counter() - t_phase
    kstep.LAUNCHES = 0
    n2 = run_invdes_2d(td, smi)
    log(f"[invdes] 2D: {n2} k-step launches on the adjoint route")
    n += n2
    log(f"[invdes] phase 29 took {time.perf_counter() - t_phase:.1f} s (3D "
        f"{t_3d:.1f} s)")
    return n


# --------------------------------------------------------------------------- #
# phases 31-35: the plans the JAX package runs and the port refused before
# (Bloch runs with poles, more than 8 pole slots, nonlinear and modulated
# media)
# --------------------------------------------------------------------------- #

N_BM_XY, N_BM_Z = 192, 512   # bloch_metal_case: 18.9 M cells, PML in z
N_BM_Z_TURNS = 128           # its 200-step turns: the stack cut in depth
N_MP_Z_TURNS = 96            # many_poles_case's 200-step turns, likewise
MIN_NL_RATIO = 1e-3          # the Kerr term against E at the dipole
# the reference's own physics bars (tests/test_solver/test_nonlinear.py,
# test_modulation.py), through the port
PHYS_WL, PHYS_N0, PHYS_L = 1.5, 2.0, 2.0


def au_cr(td) -> tuple:
    """The default library Au (6 pole slots) and Cr (7): 13 slots."""
    lib = td.material_library
    fit = "RakicLorentzDrude1998"
    return lib["Au"][fit], lib["Cr"][fit]


def bloch_metal_case(td, nz: int = N_BM_Z):
    """A gold grating (lines along y, half the period wide, 0.2 um thick)
    on a 0.04 um chromium adhesion layer over SiO2 (eps 2.1): 192 x 192 x
    nz cells at dl = 0.02 um (the stack's depth nz includes a 12-layer PML
    on each z side; the grating's top at z = 0.2 um), Bloch x and y from a
    plane wave going down at theta = 20, phi = 30 degrees
    (``BlochBoundary.from_source``); 13 pole slots. Monitors, at fractions
    of the depth h: an 11-frequency flux plane between the source (0.35 h)
    and the grating (``flux``, 0.2 h) and one in the substrate
    (``flux_below``, -0.2 h), and a point Ex field-time monitor above the
    grating from the default start (``probe``, off the k-step tier's group
    ends). ``run_time`` holds ~300 steps: the pulse (fwidth f0 / 2) reaches
    its peak at the source."""
    au, cr = au_cr(td)
    freq0 = td.C_0 / 1.55
    dl = 0.02
    size = (N_BM_XY * dl, N_BM_XY * dl, round((nz - 24) * dl, 9))
    h = size[2]
    pw = td.PlaneWave(
        center=(0, 0, 0.35 * h), size=(td.inf, td.inf, 0), direction="-",
        source_time=td.GaussianPulse(freq0=freq0, fwidth=freq0 / 2),
        pol_angle=0.0, angle_theta=np.deg2rad(20.0),
        angle_phi=np.deg2rad(30.0))
    bx, by = (td.BlochBoundary.from_source(source=pw, domain_size=size[a],
                                           axis=a) for a in (0, 1))
    freqs = np.linspace(freq0 * 0.95, freq0 * 1.05, 11).tolist()
    return td.Simulation(
        center=(0, 0, 0), size=size, run_time=1.15e-14, sources=[pw],
        structures=[
            td.Structure(geometry=td.Box(center=(0, 0, -0.04 - h / 2),
                                         size=(td.inf, td.inf, h)),
                         medium=td.Medium(permittivity=2.1)),
            td.Structure(geometry=td.Box(center=(0, 0, -0.02),
                                         size=(td.inf, td.inf, 0.04)),
                         medium=cr),
            td.Structure(geometry=td.Box(center=(0, 0, 0.1),
                                         size=(size[0] / 2, td.inf, 0.2)),
                         medium=au)],
        monitors=[
            td.FluxMonitor(center=(0, 0, 0.2 * h), size=(td.inf, td.inf, 0),
                           freqs=freqs, name="flux"),
            td.FluxMonitor(center=(0, 0, -0.2 * h),
                           size=(td.inf, td.inf, 0), freqs=freqs,
                           name="flux_below"),
            td.FieldTimeMonitor(center=(0.1, 0.1, 0.1 * h + 0.2),
                                size=(0, 0, 0), fields=["Ex"],
                                name="probe")],
        boundary_spec=td.BoundarySpec(
            x=td.Boundary(minus=bx, plus=bx), y=td.Boundary(minus=by,
                                                            plus=by),
            z=td.Boundary.pml()),
        grid_spec=td.GridSpec.uniform(dl=dl), shutoff=0.0)


def kerr_medium(td):
    """Kerr (chi3 = 1e-3 um^2/V^2 at n0 = sqrt 2: B E^2 ~ 7e-3 at the
    dipole's peak of ~3.8 V/um) and two-photon absorption (its
    conductivity coefficient 2e-4 S um/V^2), ``num_iters`` at its default
    (5)."""
    n0 = float(np.sqrt(2.0))
    eps0 = td.constants.EPSILON_0
    n2 = 1e-3 / ((4.0 / 3.0) * n0 ** 2 * eps0 * td.C_0)
    beta = 2e-4 / (td.C_0 ** 2 * eps0 ** 2 * n0 ** 2)
    return td.Medium(permittivity=2.0, nonlinear_spec=td.NonlinearSpec(
        models=[td.KerrNonlinearity(n2=n2),
                td.TwoPhotonAbsorption(beta=beta)]))


def modulated_medium(td):
    """Permittivity (2 +- 0.2) and conductivity (0.02 +- 0.01 S/um, never
    a gain) both modulated at f0 / 10 (one entry, two maps each)."""
    freq0 = td.C_0 / 1.55

    def stm(amplitude):
        return td.SpaceTimeModulation(
            time_modulation=td.ContinuousWaveTimeModulation(
                freq0=freq0 / 10, amplitude=amplitude, phase=0.3),
            space_modulation=td.SpatialModulationUniform(amplitude=1.0,
                                                         phase=0.1))

    return td.Medium(permittivity=2.0, conductivity=0.02,
                     modulation_spec=td.ModulationSpec(
                         permittivity=stm(0.2), conductivity=stm(0.01)))


def block_case(td, medium, probe: bool = False):
    """The broadband case (384^3) with a 4 um block of ``medium`` around
    its dipole, and with ``probe`` a point Ez field-time monitor at the
    dipole."""
    sim = full_case(td)
    src = sim.sources[0]
    mons = list(sim.monitors)
    if probe:
        mons.append(td.FieldTimeMonitor(center=src.center, size=(0, 0, 0),
                                        fields=["Ez"], name="probe"))
    return sim.copy(update=dict(
        structures=[td.Structure(geometry=td.Box(center=(0, 0, 0),
                                                 size=(4.0, 4.0, 4.0)),
                                 medium=medium)],
        monitors=mons))


def many_poles_case(td, nz: int = N_METAL + 24):
    """The Au case's grid (280^3 with the PML, dl = 0.05) with the default
    Au (6 slots) on a 0.1 um Cr layer (7): 13 slots; the Au case's dipole
    pulse (fwidth f0 / 8, still rising at step 200: after a pulse of f0 /
    2 has passed, the fields at step 200 are far below their peak, and
    against them the rounding of the peak's steps breaks the 200-step bar
    at every slot count, 6 and 7 too) 1.6 um below the Cr
    (1.2 um at the depth of the 200-step turns); the broadband case's
    field plane and flux box, and a point Ez field-time monitor from the
    default start; ~300 steps."""
    au, cr = au_cr(td)
    freq0 = td.C_0 / 1.55
    dl = 0.05
    size = (N_METAL * dl, N_METAL * dl, round((nz - 24) * dl, 9))
    freqs = np.linspace(freq0 * 0.95, freq0 * 1.05, 11).tolist()
    return td.Simulation(
        center=(0, 0, 0), size=size, run_time=2.9e-14,
        sources=[td.PointDipole(
            center=(0, 0, -min(1.6, size[2] / 3)), polarization="Ez",
            source_time=td.GaussianPulse(freq0=freq0, fwidth=freq0 / 8))],
        structures=[
            td.Structure(geometry=td.Box(center=(0, 0, size[2] / 2 + 0.1),
                                         size=(td.inf, td.inf, size[2])),
                         medium=au),
            td.Structure(geometry=td.Box(center=(0, 0, 0.05),
                                         size=(td.inf, td.inf, 0.1)),
                         medium=cr)],
        monitors=_dft_monitors(td, size, freqs) + [td.FieldTimeMonitor(
            center=(0, 0, -0.2), size=(0, 0, 0), fields=["Ez"],
            name="probe")],
        boundary_spec=td.BoundarySpec.all_sides(td.PML()),
        grid_spec=td.GridSpec.uniform(dl=dl), shutoff=0.0)


def regs_blocks(res: dict) -> dict:
    """``{instantiation: (registers, blocks per SM)}`` of resources."""
    return {k: (v["registers"], v["blocks_per_sm"]) for k, v in res.items()}


def check_memory(w) -> None:
    """The run's estimate against its peak (both of the runner)."""
    peak = w.peak - w.base
    log(f"[memory] {MEMORY[-1][0]}: peak {peak} B, estimate "
        f"{w.memory['estimate']} B, ratio "
        f"{w.memory['estimate'] / max(peak, 1):.3f}")
    assert w.memory["estimate"] >= peak, (w.memory, peak)


def family_pair_work(runner, state) -> tuple:
    """``(bytes, operations)`` of one family launch, half of an E and H
    pair over every copy of the state: each reads 6 fields and writes 3,
    its psi slabs read and written, the pole currents read by E."""
    copies = [(e, h, p) for e, h, p in (("E", "H", "psi"),
                                        ("E1", "H1", "psi1")) if e in state]
    ncell = int(np.prod(runner.shape))
    q = [state[key] for key in ("Q", "Q1") if key in state]
    psi = sum(numel(state[p]) for _, _, p in copies)
    return ((3 * nbytes([state[e] for e, _, _ in copies],
                        [state[h] for _, h, _ in copies])
             + 2 * nbytes([state[p] for _, _, p in copies]) + nbytes(q)
             + nbytes(stepping_consts(runner))) / 2,
            len(copies) * OPS_FAMILY * ncell + OPS_PSI * psi / 2
            + 4 * 3 * len(runner.plan.poles) * len(copies) * ncell / 2)


def compare_copies(step, runner, state, what: str) -> float:
    """The family kernel against its plain version for one E and one H
    update of every copy (``family_update_copies``), fields and psi to
    1e-6; returns the largest absolute difference."""
    views = runner._views(state)
    worst_rel, worst_abs, newE = 0.0, 0.0, None
    for fam in ("E", "H"):
        srcs = [v["H"] for v in views] if fam == "E" else newE
        before = step.LAUNCHES
        got = step.family_update_copies(fam, views, runner.consts, srcs,
                                        runner.meta)
        sync()
        assert step.LAUNCHES == before + 1, "kernel did not launch"
        ref = step.family_update_copies_reference(fam, views, runner.consts,
                                                  srcs, runner.meta)
        for (gf, gp), (rf, rp) in zip(got, ref):
            for g, r in ((gf, rf), (gp, rp)):
                if r:
                    worst_abs = max(worst_abs, max_diff(g, r))
                    worst_rel = max(worst_rel, rel_err(g, r))
        newE = [f for f, _ in ref]
    log(f"[update] {what}: family kernel vs plain, {len(views)} copies, max "
        f"rel err {worst_rel:.3e} (max abs {worst_abs:.3e}, tol "
        f"{TOL_UPDATE:g}); blocks and device launches {step.LAST_BLOCKS}")
    assert worst_rel <= TOL_UPDATE, f"{what}: rel err {worst_rel:.3e}"
    return worst_abs


def compare_step(runner, state, what: str, plain=None) -> float:
    """One whole step of the runner's tier, kernels against plain versions
    (``plain``: the runner of the plain versions, where already built), on
    copies of ``state`` (fields, psi and pole currents of every copy to
    1e-6); returns the largest absolute difference."""
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner

    plain = plain or FDTDRunner(runner.plan, device=runner.device,
                                use_kernel=False, kernel=runner.tier)

    def clone(st):
        return {k: (clone(v) if isinstance(v, dict) else
                    [clone(x) for x in v] if isinstance(v, list) else
                    tuple(t.clone() for t in v) if isinstance(v, tuple)
                    else v.clone()) for k, v in st.items()}

    t = min(40, runner.num_steps - 1)
    got = runner.step(t, clone(state))
    sync()
    ref = plain.step(t, clone(state))
    worst_rel, worst_abs = group_errors(flat_state(got), flat_state(ref))
    log(f"[step] {what}, tier {runner.tier}: one step kernel vs plain max "
        f"rel err {worst_rel:.3e} (max abs {worst_abs:.3e}, tol "
        f"{TOL_UPDATE:g}; fields, psi and every copy's pole currents)")
    assert worst_rel <= TOL_UPDATE, f"{what}: rel err {worst_rel:.3e}"
    return worst_abs


def device_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` by CUDA events, its calls queued behind
    a sleep kernel (~30 ms) so that the host's launch gaps fall inside it
    and only the device's own time is counted."""
    fn()
    sync()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    sync()
    return t0.elapsed_time(t1) / reps


def step_split(runner, what: str, rate: float, smi: str) -> dict:
    """Device ms a step of each part of a ``pallas2`` step (``device_ms``,
    one part at a time on a random state of ``runner``): the two family
    calls (every copy), post_e and the plain pole update of every copy,
    the sources and the monitors; against the step time of ``rate``
    Gcell*steps/s (torch.profiler drops some kernel records in this long
    process: a window of it was "not measured" on these cases)."""
    from tidy3d_tpu_torch.solver.fdtd import update_poles

    state = random_state(runner, 36)
    views = runner._views(state)
    new_e = [{c: v.clone() for c, v in view["E"].items()} for view in views]
    t = min(40, runner.num_steps - 1)

    def family():
        runner._family_update("E", views, [v["H"] for v in views])
        runner._family_update("H", views, [v["E"] for v in views])

    def passes():
        for ne, view in zip(new_e, views):
            runner._post_e(ne, view["E"], t)

    def poles():
        for ne, view in zip(new_e, views):
            update_poles(ne, view["E"], view["Q"], runner.consts)

    def sources_monitors():
        for p, ne in enumerate(new_e):
            runner._inject("E", ne, t, p)
            runner._inject("H", views[p]["H"], t, p)
        runner._accumulate_monitors(t, new_e[0], views[0]["H"],
                                    state["mon"], *(new_e[1:] + [
                                        v["H"] for v in views[1:]]))

    out = {"family": device_ms(family, 5),
           "post_e": device_ms(passes, 5) if "nl" in runner.consts
           or runner.consts.get("mod") else 0.0,
           "poles": device_ms(poles, 3) if runner.plan.poles else 0.0,
           "sources_monitors": device_ms(sources_monitors, 5)}
    step_ms = int(np.prod(runner.shape)) / (rate * 1e9) * 1e3
    log(f"[split] {what} per step (device ms by CUDA events, part by part): "
        f"{ {k: round(v, 3) for k, v in out.items()} } ms, sum "
        f"{sum(out.values()):.3f} ms against the step's {step_ms:.3f} ms "
        f"| {smi}")
    return dict(out, step=step_ms)


def run_bloch_metal(td, dev, smi: str) -> dict:
    """Phase 31: ``bloch_metal_case`` (Bloch x and y with 13 pole slots):
    the default tier is pallas2 with both copies; the two-copy family
    kernel against plain for one E and H update and one whole step (1e-6),
    its time beside the bound; 200 steps in turns on the stack cut to
    ``N_BM_Z_TURNS`` cells of depth (2e-5, fields of both copies and Q,
    Q1); ``web.run``, 2 family calls a step, each one
    two-copy call, no fused or k-step launch, its memory estimate at least
    its peak. Returns the entries of the two-copy and pole-table family
    instantiations."""
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
    from tidy3d_tpu_torch.solver.kernels import step
    from tidy3d_tpu_torch.solver.lowering import lower

    t_phase = time.perf_counter()
    plan = lower(bloch_metal_case(td))
    ncell = int(np.prod(plan.shape))
    assert plan.is_complex and len(plan.poles) == 13, len(plan.poles)
    runner = FDTDRunner(plan, device=dev)
    log(f"[bloch-metal] grid {plan.shape} = {ncell} cells, 13 pole slots, "
        f"phases {plan.bloch_phases}, tier {runner.tier_name}, lowered and "
        f"built in {time.perf_counter() - t_phase:.1f} s")
    assert runner.tier == "pallas2" and runner.is_complex
    state = random_state(runner, 31)
    err = compare_copies(step, runner, state, f"{plan.shape} Bloch metal")
    err = max(err, compare_step(runner, state, f"{plan.shape} Bloch metal"))
    views = runner._views(state)

    def pair(fn):
        def once():
            nE = [f for f, _ in fn("E", views, runner.consts,
                                   [v["H"] for v in views], runner.meta)]
            fn("H", views, runner.consts, nE, runner.meta)
        return once

    k_ms = cuda_ms(pair(step.family_update_copies), 5) / 2
    p_ms = cuda_ms(pair(step.family_update_copies_reference), 2) / 2
    bnd = bound(*family_pair_work(runner, state))
    res = {f"{f} {part}": step.resources(f, part == "bulk", mode="bloch")
           for f in "EH" for part in ("bulk", "shell")}
    log(f"[bloch-metal] two-copy family kernel {k_ms:.3f} ms a launch (both "
        f"copies, 13 slots in E), bound {bnd[0]:.3f} ms by {bnd[1]}, ratio "
        f"{k_ms / bnd[0]:.2f}; plain {p_ms:.3f} ms; registers and blocks per "
        f"SM {regs_blocks(res)} | {smi}")
    del state, views
    torch.cuda.empty_cache()
    plan_t = lower(bloch_metal_case(td, nz=N_BM_Z_TURNS))
    rates = compare_runners(plan_t, dev, int(np.prod(plan_t.shape)),
                            f"Bloch metal {plan_t.shape} (depth cut)", smi)
    del plan_t
    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    w = web_run(td, bloch_metal_case(td), "Bloch metal, default tier", smi,
                field=None)
    split = step_split(runner, "Bloch metal, pallas2", w.rate, smi)
    del runner
    none = {"family": 0, "fused": 0, "kstep": 0}
    assert w.tier == "pallas2", w.tier
    assert w.launches == dict(none, family=2 * w.steps), w.launches
    assert w.extra["family_bloch"] == 2 * w.steps, w.extra
    assert w.extra["family_many_poles"] == w.steps, w.extra
    probe = np.asarray(w.data["probe"].Ex.values)
    assert probe.size > 1 and np.all(np.isfinite(probe))
    assert np.any(probe != 0)
    check_memory(w)
    log(f"[bloch-metal] web.run {w.rate} Gcell*steps/s, {w.steps} steps; "
        f"phase 31 took {time.perf_counter() - t_phase:.1f} s | {smi}")
    return dict(err=err, ms=k_ms, plain_ms=p_ms, bound=bnd, rate=w.rate,
                launches=w.extra["family_bloch"], split=split, res=res)


def post_e_work(new_e: dict, consts: dict) -> tuple:
    """``(bytes, operations)`` of one post_e call: per component with a
    pass E_lin and E read and E' written, each coefficient map read once;
    per cell of such a component 14 operations a modulation entry and 14
    a fixed-point sweep (as the kernel writes them)."""
    from tidy3d_tpu_torch.solver.lowering import E_COMPS

    maps, comps, entries = [], set(), 0
    for ce in consts.get("mod", ()):
        entries += 1
        for key in ("Beps", "Bsig"):
            for comp, pair in ce.get(key, {}).items():
                comps.add(comp)
                maps += [v for v in pair if isinstance(v, torch.Tensor)]
    iters = consts.get("nl_num_iters", 0)
    for kind in consts.get("nl", {}).values():
        for comp, v in kind.items():
            comps.add(comp)
            if isinstance(v, torch.Tensor):
                maps.append(v)
    cells = new_e[E_COMPS[0]].numel()
    field = new_e[E_COMPS[0]].element_size()
    return (3 * field * cells * len(comps) + nbytes(maps),
            14 * (entries + iters) * cells * len(comps))


def run_post_e_case(td, dev, smi: str, name: str, medium, what: str):
    """Phases 32 and 33: the block case with ``medium`` (384^3): pallas2
    under ``auto``; one post_e call against its plain version (1e-6) and
    one whole step (1e-6); post_e's time beside its bound and the eager
    plain version's; 200 steps in turns (2e-5);
    ``web.run`` over a third of the broadband run (~660 steps, past the
    pulse's peak at the dipole), one post_e call a step (its dipole's Ez
    at the probe gives the size of the Kerr term). Returns the case's
    numbers."""
    from tidy3d_tpu_torch.solver import nonlinear
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
    from tidy3d_tpu_torch.solver.kernels import post_e
    from tidy3d_tpu_torch.solver.lowering import lower

    t_phase = time.perf_counter()
    kerr = name == "kerr"
    sim = block_case(td, medium, probe=kerr)
    plan = lower(sim)
    ncell = int(np.prod(plan.shape))
    runner = FDTDRunner(plan, device=dev)
    plain = FDTDRunner(plan, device=dev, use_kernel=False)
    assert runner.tier == plain.tier == "pallas2", runner.tier
    state = random_state(runner, 32)
    # E_lin of the order of E (H's curl moves E by about its own size)
    state["H"] = {c: 1e-2 * v for c, v in state["H"].items()}
    new_e = {c: v.clone() for c, v in state["E"].items()}
    for c in new_e:
        new_e[c].mul_(1.0 + 1e-3 * torch.rand_like(new_e[c]))
    before = post_e.LAUNCHES
    got = post_e.post_e({c: v.clone() for c, v in new_e.items()},
                        state["E"], runner.consts, 40)
    sync()
    assert post_e.LAUNCHES == before + 1
    ref = nonlinear.post_e_reference(new_e, state["E"], runner.consts, 40)
    err_rel, err = rel_err(got, ref), max_diff(got, ref)
    effect = rel_err(ref, new_e)
    log(f"[{name}] post_e kernel vs plain max rel err {err_rel:.3e} (max "
        f"abs {err:.3e}, tol {TOL_UPDATE:g}); the passes moved E by "
        f"{effect:.3e} of its largest magnitude")
    assert err_rel <= TOL_UPDATE and effect > 0
    err = max(err, compare_step(runner, state, f"{plan.shape} {what}",
                                plain))
    bufs = {c: v.clone() for c, v in new_e.items()}
    k_ms = cuda_ms(lambda: post_e.post_e(bufs, state["E"], runner.consts,
                                         40), 20)
    p_ms = cuda_ms(lambda: nonlinear.post_e_reference(
        new_e, state["E"], runner.consts, 40), 3)
    bnd = bound(*post_e_work(new_e, runner.consts))
    log(f"[{name}] post_e {k_ms:.3f} ms a call at {plan.shape}, bound "
        f"{bnd[0]:.3f} ms by {bnd[1]}, ratio {k_ms / bnd[0]:.2f}; eager "
        f"plain {p_ms:.3f} ms | {smi}")
    del state, new_e, got, ref, bufs
    rates = compare_runners(plan, dev, ncell, f"{what} 384^3", smi,
                            runners={"plain": plain, "kernel": runner})
    split = step_split(runner, f"{what}, pallas2",
                       float(np.mean(rates["kernel"])), smi)
    del runner, plain
    torch.cuda.empty_cache()
    # a third of the broadband run: past the pulse's peak at the dipole
    w = web_run(td, sim.copy(update=dict(run_time=sim.run_time / 3)),
                f"{what}, default tier", smi)
    none = {"family": 0, "fused": 0, "kstep": 0}
    assert w.tier == "pallas2", w.tier
    assert w.launches == dict(none, family=2 * w.steps), w.launches
    assert w.extra["post_e"] == w.steps, w.extra
    check_memory(w)
    ratio = None
    if kerr:
        # the Kerr term at the dipole against its field there: B E^2 with
        # B = cb eps0 chi3 / dt at the dipole's cell
        from tidy3d_tpu_torch.constants import EPSILON_0

        e_max = float(np.max(np.abs(w.data["probe"].Ez.values)))
        src = plan.sources[0].slices
        cb = plan.coeffs_E["Ez"][1]
        chi3 = plan.nonlinear["chi3"]["Ez"]
        b_src = float(np.max(np.abs(
            (cb[src] if np.ndim(cb) else cb) * EPSILON_0
            * (chi3[src] if np.ndim(chi3) else chi3) / plan.dt)))
        ratio = b_src * e_max ** 2
        log(f"[{name}] |Ez| at the dipole up to {e_max:.4e} V/um: the Kerr "
            f"term B E^2 = {ratio:.3e} of E there (at least "
            f"{MIN_NL_RATIO:g})")
        assert ratio >= MIN_NL_RATIO, ratio
    log(f"[{name}] web.run {w.rate} Gcell*steps/s, {w.steps} steps; phase "
        f"took {time.perf_counter() - t_phase:.1f} s | {smi}")
    return dict(err=err, ms=k_ms, plain_ms=p_ms, bound=bnd, rate=w.rate,
                launches=w.extra["post_e"], split=split, ratio=ratio)


def run_many_poles(td, dev, smi: str) -> dict:
    """Phase 34: ``many_poles_case`` (13 slots, real): forced fused and
    forced pallas2, one step each against its plain version (1e-6), the
    pole-table fused and family kernels' times beside their bounds, 200
    steps of each in turns on the stack cut to ``N_MP_Z_TURNS`` cells of
    depth (2e-5); ``web.run`` under ``auto`` (a default-start time
    monitor): the fused tier, one pole-table fused call a step; a short
    forced pallas2 ``web.run`` for the pole-table family calls."""
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
    from tidy3d_tpu_torch.solver.kernels import fused, step
    from tidy3d_tpu_torch.solver.lowering import lower

    t_phase = time.perf_counter()
    plan = lower(many_poles_case(td))
    ncell = int(np.prod(plan.shape))
    assert len(plan.poles) == 13 and not plan.is_complex
    out = {}
    for tier in ("fused", "pallas2"):
        runner = FDTDRunner(plan, device=dev, kernel=tier)
        state = random_state(runner, 34)
        err = compare_step(runner, state, f"{plan.shape} Au/Cr 13 slots")
        if tier == "fused":
            src = step_sources(runner)
            q_out = q_buffers(state)
            k_ms = cuda_ms(lambda: fused.fused_step(
                state, runner.consts, runner.meta, src, q_out=q_out), 10)
            p_ms = cuda_ms(lambda: fused.fused_step_reference(
                state, runner.consts, runner.meta, src), 2)
            bnd = bound(*fused_work(runner, state))
            res = {part: fused.resources(13, part == "bulk")
                   for part in ("bulk", "shell")}
            del q_out
        else:
            k_ms = cuda_ms(lambda: step.family_update(
                "E", state, runner.consts, state["H"], runner.meta), 10)
            p_ms = cuda_ms(lambda: step.family_update_reference(
                "E", state, runner.consts, state["H"], runner.meta), 2)
            # the E launch: H and E read and E' written, the 13 slots'
            # currents read, the E slabs of psi read and written
            bnd = bound(3 * nbytes(state["E"]) + nbytes(state["Q"])
                        + nbytes(state["psi"])
                        + nbytes(stepping_consts(runner)) / 2,
                        OPS_FAMILY * ncell + OPS_PSI * numel(state["psi"]) / 2
                        + 4 * 3 * 13 * ncell)
            res = {part: step.resources("E", part == "bulk", mode="many")
                   for part in ("bulk", "shell")}
        what = "fused step" if tier == "fused" else "E family launch"
        log(f"[many-poles] {tier}: {what} {k_ms:.3f} ms at {plan.shape} with "
            f"13 slots from the table, bound {bnd[0]:.3f} ms by {bnd[1]}, "
            f"ratio {k_ms / bnd[0]:.2f}; plain {p_ms:.3f} ms; registers and "
            f"blocks per SM {regs_blocks(res)} | {smi}")
        out[tier] = dict(err=err, ms=k_ms, plain_ms=p_ms, bound=bnd,
                         res=res)
        del state, runner
        torch.cuda.empty_cache()
    plan_t = lower(many_poles_case(td, nz=N_MP_Z_TURNS))
    for tier in ("fused", "pallas2"):
        compare_runners(plan_t, dev, int(np.prod(plan_t.shape)),
                        f"Au/Cr 13 slots {plan_t.shape} (depth cut)", smi,
                        kernel=tier)
    del plan_t
    w = web_run(td, many_poles_case(td), "Au/Cr 13 slots, default tier",
                smi)
    none = {"family": 0, "fused": 0, "kstep": 0}
    assert w.tier == "fused", w.tier
    assert w.launches == dict(none, fused=w.steps), w.launches
    assert w.extra["fused_many_poles"] == w.steps, w.extra
    check_memory(w)
    short = many_poles_case(td).copy(update=dict(run_time=1e-14))
    w2 = web_run(td, short, "Au/Cr 13 slots, pallas2", smi, tier="pallas2")
    assert w2.launches == dict(none, family=2 * w2.steps), w2.launches
    assert w2.extra["family_many_poles"] == w2.steps, w2.extra
    check_memory(w2)
    log(f"[many-poles] web.run fused {w.rate}, pallas2 {w2.rate} "
        f"Gcell*steps/s; phase 34 took {time.perf_counter() - t_phase:.1f} "
        f"s | {smi}")
    out["fused"].update(launches=w.extra["fused_many_poles"], rate=w.rate)
    out["pallas2"].update(launches=w2.extra["family_many_poles"],
                          rate=w2.rate)
    return out


def physics_cw(td, spec, amp: float, device) -> complex:
    """The reference's ``_run_cw`` (``tests/test_solver/test_nonlinear.py``)
    through the port: a CW plane wave through an index-matched nonlinear
    slab; the steady-state phasor at the output point over the
    amplitude."""
    freq0 = td.C_0 / PHYS_WL
    cw = td.ContinuousWave(freq0=freq0, fwidth=freq0 / 10, amplitude=amp)
    slab = td.Structure(
        geometry=td.Box(center=(0, 0, 0), size=(PHYS_L, td.inf, td.inf)),
        medium=td.Medium(permittivity=PHYS_N0 ** 2, nonlinear_spec=spec))
    pw = td.PlaneWave(center=(-2, 0, 0), size=(0, td.inf, td.inf),
                      direction="+", source_time=cw, pol_angle=np.pi / 2)
    mon = td.FieldTimeMonitor(center=(2, 0, 0), size=(0, 0, 0), name="out",
                              start=2.2e-13)
    sim = td.Simulation(
        center=(0, 0, 0), size=(5.5, 0.4, 0), run_time=2.7e-13,
        medium=td.Medium(permittivity=PHYS_N0 ** 2),
        sources=[pw], monitors=[mon], structures=[slab], shutoff=0.0,
        boundary_spec=td.BoundarySpec(x=td.Boundary.pml(),
                                      y=td.Boundary.periodic(),
                                      z=td.Boundary.periodic()),
        grid_spec=td.GridSpec.uniform(dl=0.03))
    data = td.web.run(sim, verbose=False, device=device)
    assert "kernel tier: pallas2" in data.log
    ez = np.asarray(data["out"].Ez.values)[0, 0, 0, :]
    ts = np.asarray(data["out"].Ez.coords["t"])
    c = np.sum(ez * np.cos(2 * np.pi * freq0 * ts))
    s = np.sum(ez * np.sin(2 * np.pi * freq0 * ts))
    return (c + 1j * s) / amp


def physics_checks(td, device="cuda") -> dict:
    """The reference's four physics tests through the port on ``device``,
    with their asserts: Kerr self-phase modulation dphi = k0 n2 I L (within
    12 %, |amplitude change| below 5 %), two-photon absorption T = 1 /
    sqrt(1 + beta I L) (5 %, phase below 0.05), chi3 from n2 equals Kerr
    (1e-3) (``tests/test_solver/test_nonlinear.py``) and the sidebands of a
    phase-modulated slab at m / 2 (``test_modulation.py``). Returns the
    measured values."""
    eps0 = td.constants.EPSILON_0
    i0 = 0.5 * td.C_0 * eps0 * PHYS_N0
    out = {}
    n2 = 10.0
    spec = td.NonlinearSpec(models=[td.KerrNonlinearity(n2=n2, n0=PHYS_N0)],
                            num_iters=10)
    lo = physics_cw(td, spec, 0.02, device)
    hi = kerr_hi = physics_cw(td, spec, 1.0, device)
    dphi = np.angle(hi / lo)
    theory = 2 * np.pi / PHYS_WL * n2 * i0 * PHYS_L
    out["kerr_dphi_ratio"] = float(dphi / theory)
    out["kerr_amplitude"] = float(abs(hi / lo))
    assert abs(dphi / theory - 1.0) < 0.12, out
    assert abs(abs(hi / lo) - 1.0) < 0.05, out
    beta = 56.0
    spec = td.NonlinearSpec(models=[td.TwoPhotonAbsorption(beta=beta,
                                                           n0=PHYS_N0)],
                            num_iters=10)
    lo = physics_cw(td, spec, 0.02, device)
    hi = physics_cw(td, spec, 1.0, device)
    t_meas = abs(hi / lo)
    t_theory = 1.0 / np.sqrt(1.0 + beta * i0 * PHYS_L)
    out["tpa_ratio"] = float(t_meas / t_theory)
    out["tpa_phase"] = float(np.angle(hi / lo))
    assert abs(t_meas / t_theory - 1.0) < 0.05, out
    assert abs(np.angle(hi / lo)) < 0.05, out
    chi3 = (4.0 / 3.0) * PHYS_N0 ** 2 * eps0 * td.C_0 * n2
    a = physics_cw(td, td.NonlinearSpec(
        models=[td.NonlinearSusceptibility(chi3=chi3)], num_iters=10), 1.0,
        device)
    b = kerr_hi     # the Kerr run at amplitude 1 of the first check
    out["chi3_vs_kerr"] = float(abs(a / b - 1.0))
    assert abs(a / b - 1.0) < 1e-3, out
    freq0 = td.C_0 / PHYS_WL
    fm = freq0 / 10
    deps = 0.08
    m_idx = (2 * np.pi / PHYS_WL) * PHYS_L * deps / (2 * PHYS_N0)
    mod = td.ModulationSpec(permittivity=td.SpaceTimeModulation(
        time_modulation=td.ContinuousWaveTimeModulation(freq0=fm,
                                                        amplitude=deps)))
    sim = td.Simulation(
        center=(0, 0, 0), size=(5.5, 0.4, 0), run_time=5e-13,
        medium=td.Medium(permittivity=PHYS_N0 ** 2),
        sources=[td.PlaneWave(
            center=(-2, 0, 0), size=(0, td.inf, td.inf), direction="+",
            source_time=td.GaussianPulse(freq0=freq0, fwidth=freq0 / 50),
            pol_angle=np.pi / 2)],
        monitors=[td.FieldMonitor(center=(2, 0, 0), size=(0, 0, 0),
                                  freqs=[freq0 - fm, freq0, freq0 + fm],
                                  name="out")],
        structures=[td.Structure(
            geometry=td.Box(center=(0, 0, 0),
                            size=(PHYS_L, td.inf, td.inf)),
            medium=td.Medium(permittivity=PHYS_N0 ** 2,
                             modulation_spec=mod))],
        shutoff=0.0, normalize_index=None,
        boundary_spec=td.BoundarySpec(x=td.Boundary.pml(),
                                      y=td.Boundary.periodic(),
                                      z=td.Boundary.periodic()),
        grid_spec=td.GridSpec.uniform(dl=0.03))
    data = td.web.run(sim, verbose=False, device=device)
    assert "kernel tier: pallas2" in data.log
    lower_, carrier, upper = np.abs(
        np.asarray(data["out"].Ez.values).reshape(-1, 3)).max(axis=0)
    out["upper_ratio"] = float(upper / carrier / (m_idx / 2))
    out["lower_ratio"] = float(lower_ / carrier / (m_idx / 2))
    assert carrier > 5 * upper, out
    assert abs(upper / carrier - m_idx / 2) / (m_idx / 2) < 0.1, out
    assert abs(lower_ / carrier - m_idx / 2) / (m_idx / 2) < 0.35, out
    return out


def run_physics(td, smi: str) -> dict:
    """Phase 35: ``physics_checks`` on the card, post_e launches counted."""
    from tidy3d_tpu_torch.solver.kernels import post_e

    t_phase = time.perf_counter()
    post_e.LAUNCHES = 0
    out = physics_checks(td, "cuda")
    log(f"[physics] the reference's Kerr, TPA, chi3 and sideband asserts "
        f"hold through the port on the card: {out}; {post_e.LAUNCHES} "
        f"post_e calls; phase 35 took {time.perf_counter() - t_phase:.1f} s "
        f"| {smi}")
    assert post_e.LAUNCHES > 0
    return out


def run_fifteenth(td, dev, smi: str) -> list:
    """Phases 31-35; returns their entries of the kernels line."""
    bm = run_bloch_metal(td, dev, smi)
    torch.cuda.empty_cache()
    kerr = run_post_e_case(td, dev, smi, "kerr", kerr_medium(td),
                           "Kerr + TPA block")
    torch.cuda.empty_cache()
    mod = run_post_e_case(td, dev, smi, "modulated", modulated_medium(td),
                          "modulated block")
    torch.cuda.empty_cache()
    mp = run_many_poles(td, dev, smi)
    torch.cuda.empty_cache()
    run_physics(td, smi)
    step_src = "tidy3d_tpu_torch/csrc/step.cu"
    step_tpu = "tidy3d_tpu/solver/kernels/pallas_step.py:118"
    return [
        entry("family_update_bloch", step_src, step_tpu, bm["launches"],
              bm["err"], bm["ms"], bm["plain_ms"], bm["bound"],
              instantiations=bm["res"]),
        entry("family_update_many_poles", step_src, step_tpu,
              mp["pallas2"]["launches"], mp["pallas2"]["err"],
              mp["pallas2"]["ms"], mp["pallas2"]["plain_ms"],
              mp["pallas2"]["bound"], instantiations=mp["pallas2"]["res"]),
        entry("fused_step_many_poles", "tidy3d_tpu_torch/csrc/fused.cu",
              "tidy3d_tpu/solver/kernels/pallas_fused.py:109",
              mp["fused"]["launches"], mp["fused"]["err"],
              mp["fused"]["ms"], mp["fused"]["plain_ms"],
              mp["fused"]["bound"], instantiations=mp["fused"]["res"]),
        entry("post_e", "tidy3d_tpu_torch/csrc/post_e.cu",
              "tidy3d_tpu/solver/fdtd.py:1632",
              kerr["launches"] + mod["launches"], max(kerr["err"],
                                                      mod["err"]),
              kerr["ms"], kerr["plain_ms"], kerr["bound"],
              modulated_ms=mod["ms"], modulated_plain_ms=mod["plain_ms"],
              modulated_bound_ms=mod["bound"][0]),
    ]


def entry(name, source, replaces, launches, err, ms, plain_ms, bnd,
          library_ms=None, **extra) -> dict:
    """One kernel's entry of the kernels line (``extra``: more keys, as the
    k-step kernel's registers and blocks per SM)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": library_ms, **extra}


def timed(fn):
    """``(fn(), device ms of that one call)`` (CUDA events)."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    sync()
    t0.record()
    out = fn()
    t1.record()
    sync()
    return out, t0.elapsed_time(t1)


def lab_err(got: dict, ref: dict):
    """``(rel_err, max_diff)`` of two field sets, taken in float."""
    got = {c: v.float() for c, v in got.items()}
    ref = {c: v.float() for c, v in ref.items()}
    return rel_err(got, ref), max_diff(got, ref)


def lab_fields(seed: int, dtype, names) -> dict:
    """Seeded random ``N_LAB``^3 fields on the card, rounded to ``dtype``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {c: torch.randn((N_LAB,) * 3, generator=gen,
                           device="cuda").to(dtype) for c in names}


def run_lab_mains(smi: str) -> dict:
    """Phase 22: each lab's entry point at the labs' default sizes, its
    launch counts set to 0 just before it and read just after; every
    kernel and variant must have launched. Returns the counts by lab."""
    from tidy3d_tpu_torch.labs import kernel_lab, kernel_lab2, pole_lab

    bf16 = ("", "_bf16")
    expect = {
        kernel_lab: [v + s for v in kernel_lab.VARIANTS for s in bf16],
        kernel_lab2: [f"k{k}" + s for k in kernel_lab2.KS for s in bf16],
        pole_lab: list(pole_lab.VARIANTS),
    }
    runs = ((kernel_lab, [str(N_LAB), "4,8"], {"LAB_BF16": "1"}),
            (kernel_lab2, [str(N_LAB), "1,2,3,4", "8"], {}),
            (pole_lab, list(pole_lab.VARIANTS), {}))
    counts = {}
    for lab, argv, env in runs:
        name = lab.__name__.rsplit(".", 1)[-1]
        old = {key: os.environ.get(key) for key in env}
        os.environ.update(env)
        log(f"[lab] python3 -m {lab.__name__} {' '.join(argv)} "
            f"{' '.join(f'{k}={v}' for k, v in env.items())}")
        try:
            lab.LAUNCHES.clear()
            t0 = time.perf_counter()
            rc = lab.main(argv)
            counts[name] = dict(lab.LAUNCHES)
        finally:
            for key, value in old.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value
        log(f"[lab] {name} main: exit {rc} in "
            f"{time.perf_counter() - t0:.1f} s, launches {counts[name]}")
        assert rc == 0, f"{name} main exited {rc}"
        missing = [k for k in expect[lab] if not counts[name].get(k)]
        assert not missing, f"{name}: no launch of {missing}"
    return counts


def ptxas_of(lib: str, symbol: str) -> dict:
    """Registers and bytes spilled (stores + loads) of the one kernel of
    ``csrc/<lib>.cu`` whose mangled name holds ``symbol`` (ptxas)."""
    from tidy3d_tpu_torch.labs import _common

    rows = [v for k, v in _common.registers(lib).items() if symbol in k]
    assert len(rows) == 1, f"{lib}: {len(rows)} kernels match {symbol}"
    regs, st, ld = rows[0]
    return {"registers": regs, "spill_bytes": st + ld}


def lab_step_small(kernel_lab, dtype, tol) -> None:
    """The stencil variants against plain at n = 15 (odd: staged and
    stored cell by cell) and n = 40 (32 does not divide it; the tile
    wraps), bx = 1, 5 and 8 where it divides n."""
    names = kernel_lab.E + kernel_lab.H
    for n, seed in ((15, 24), (40, 25)):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        f = {c: torch.randn((n,) * 3, generator=gen, device="cuda").to(dtype)
             for c in names}
        for variant in ("curl", "noroll"):
            for bx in (1, 5, 8):
                if n % bx:
                    continue
                got = kernel_lab.lab_step(f, variant, bx)
                ref = kernel_lab.lab_step_reference(f, variant)
                rel, _ = lab_err(got, ref)
                assert rel <= tol, f"lab_step {variant} n={n} bx={bx} " \
                    f"{dtype}: {rel:.3e}"
    log(f"[lab_step] n = 15 and 40, bx = 1, 5, 8: curl and noroll "
        f"{'bf16' if dtype == torch.bfloat16 else 'f32'} within {tol:g} of "
        f"plain")


def run_lab_step(smi: str, launches: dict) -> list:
    """Phase 23: the step lab's kernel against its plain version at
    ``N_LAB``^3 on random fields, bx = 8 and 4, every variant in f32 and
    bf16, and the stencil variants at n = 15 and 40; kernel, plain and
    (copy) ``_foreach_copy_`` times at bx = 8; each stencil
    instantiation's resources and the SASS classes of its march loop."""
    from tidy3d_tpu_torch.labs import _common, kernel_lab

    out = []
    names = kernel_lab.E + kernel_lab.H
    for dtype, tol in ((torch.float32, TOL_UPDATE), (torch.bfloat16,
                                                     TOL_BF16)):
        f = lab_fields(21, dtype, names)
        o = {c: torch.empty_like(v) for c, v in f.items()}
        for variant in kernel_lab.VARIANTS:
            key = kernel_lab.launch_key(variant, dtype)
            worst = 0.0
            for bx in (8, 4):
                got = kernel_lab.lab_step(f, variant, bx)
                sync()
                ref, plain_ms = timed(lambda: kernel_lab.lab_step_reference(
                    f, variant))
                rel, ab = lab_err(got, ref)
                log(f"[lab_step] {N_LAB}^3 {key} bx={bx}: kernel vs plain "
                    f"max rel err {rel:.3e} (max abs {ab:.3e}, tol {tol:g})")
                assert rel <= tol, f"lab_step {key} bx={bx}: {rel:.3e}"
                if variant == "copy":
                    assert all(torch.equal(got[c], ref[c]) for c in names), \
                        f"lab_step {key}: the copy is not bit-identical"
                worst = max(worst, ab)
                del got, ref
            ms, ms4 = (cuda_ms(lambda: kernel_lab.lab_step(
                f, variant, bx, out=o), 20) for bx in (8, 4))
            lib, extra = None, {}
            if variant == "copy":
                src, dst = [f[c] for c in names], [o[c] for c in names]
                lib = cuda_ms(lambda: torch._foreach_copy_(dst, src), 20)
            else:
                symbol = kernel_lab.kernel_symbol(variant, dtype)
                extra = dict(kernel_lab.resources(variant, dtype),
                             **ptxas_of("lab_step", symbol),
                             sass=_common.sass_classes("lab_step", symbol))
                log(f"[lab_step] {key}: {extra['threads']} threads, "
                    f"{extra['registers']} registers, {extra['spill_bytes']} "
                    f"B spilled, {extra['smem']} B shared, "
                    f"{extra['blocks_per_sm']} blocks/SM; SASS of the march "
                    f"loop {extra['sass']}")
                if dtype == torch.bfloat16:
                    assert extra["sass"]["bf16x2"] > 0 and \
                        extra["sass"]["convert"] == 0, extra["sass"]
            bnd = bound(kernel_lab.step_bytes(N_LAB, dtype),
                        0 if variant == "copy"
                        else kernel_lab.FLOPS_PER_CELL * N_LAB ** 3,
                        PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
            log(f"[lab_step] {N_LAB}^3 {key} bx=8: kernel {ms:.3f} ms/step "
                f"({kernel_lab.step_bytes(N_LAB, dtype) / ms / 1e6:.0f} "
                f"GB/s; bx=4 {ms4:.3f} ms), plain {plain_ms:.3f} ms, bound "
                f"{bnd[0]:.3f} ms by "
                f"{bnd[1]}"
                + (f", torch._foreach_copy_ {lib:.3f} ms" if lib else "")
                + f"; kernel/bound {ms / bnd[0]:.2f} (bx=4 "
                f"{ms4 / bnd[0]:.2f}) | {smi}")
            out.append(entry(
                f"lab_step_{key}", "tidy3d_tpu_torch/csrc/lab_step.cu",
                "scripts/kernel_lab.py:29", launches[key], worst, ms,
                plain_ms, bnd, lib, ms_bx4=ms4, **extra))
        del f, o
        lab_step_small(kernel_lab, dtype, tol)
        # the copy's scalar tail: 15^3 values are no whole number of
        # 16-byte vectors
        g = {c: v[:15, :15, :15].contiguous()
             for c, v in lab_fields(23, dtype, names).items()}
        got = kernel_lab.lab_step(g, "copy", 5)
        sync()
        assert all(torch.equal(got[c], g[c]) for c in names), \
            f"lab_step copy {dtype} 15^3: not bit-identical"
        log(f"[lab_step] 15^3 {kernel_lab.launch_key('copy', dtype)}: "
            f"kernel bit-identical to plain (vectors and scalar tail)")
    return out


def run_lab_kstep(smi: str, launches: dict) -> list:
    """Phase 24: the k-step lab's kernel against its plain version at
    ``N_LAB``^3 on random fields, bx = 8 and 4, k = 1 to 4, f32 and bf16
    storage; kernel ms per group and per step at bx = 8 (and bx = 4), plain
    ms, the ratio to the bound, registers, shared memory, blocks per SM and
    the march's x chunks."""
    from tidy3d_tpu_torch.labs import kernel_lab2

    out = []
    dev = torch.device("cuda")
    names = kernel_lab2.E + kernel_lab2.H
    for dtype, tol in ((torch.float32, TOL_UPDATE), (torch.bfloat16,
                                                     TOL_BF16)):
        f = lab_fields(22, dtype, names)
        o = {c: torch.empty_like(v) for c, v in f.items()}
        for k in kernel_lab2.KS:
            key = kernel_lab2.launch_key(k, dtype)
            worst = 0.0
            for bx in (8, 4):
                got = kernel_lab2.lab_kstep(f, k, bx)
                sync()
                ref, p_ms = timed(lambda: kernel_lab2.lab_kstep_reference(
                    f, k, bx))
                rel, ab = lab_err(got, ref)
                log(f"[lab_kstep] {N_LAB}^3 {key} bx={bx}: kernel vs plain "
                    f"max rel err {rel:.3e} (max abs {ab:.3e}, tol {tol:g})")
                assert rel <= tol, f"lab_kstep {key} bx={bx}: {rel:.3e}"
                worst = max(worst, ab)
                if bx == 8:
                    plain_ms = p_ms
                del got, ref
                torch.cuda.empty_cache()
            ms, ms4 = (cuda_ms(lambda: kernel_lab2.lab_kstep(
                f, k, bx, out=o), 10) for bx in (8, 4))
            bnd = bound(kernel_lab2.step_bytes(N_LAB, dtype),
                        kernel_lab2.FLOPS_PER_CELL * N_LAB ** 3 * k)
            res = kernel_lab2.resources(k, dtype)
            res["chunks"] = kernel_lab2.chunks_on(N_LAB, k, dtype, dev)
            log(f"[lab_kstep] {N_LAB}^3 {key} bx=8: kernel {ms:.3f} ms/group "
                f"= {ms / k:.3f} ms/step (bx=4 {ms4:.3f} ms/group), plain "
                f"{plain_ms:.3f} ms/group; bound {bnd[0]:.3f} ms/group = "
                f"{bnd[0] / k:.3f} ms/step by {bnd[1]}, kernel/bound "
                f"{ms / bnd[0]:.2f}; {res['registers']} registers, "
                f"{res['smem']} B shared, {res['threads']} threads, "
                f"{res['blocks_per_sm']} blocks/SM, {res['chunks']} x "
                f"chunks | {smi}")
            out.append(entry(
                f"lab_kstep_{key}", "tidy3d_tpu_torch/csrc/lab_kstep.cu",
                "scripts/kernel_lab2.py:26", launches[key], worst, ms,
                plain_ms, bnd, **res))
        del f, o
    return out


POLE_LAB_LINES = {"vpu_peak": 53, "fma_peak": 250, "pole_chan": 103,
                  "pole_chan_bf16": 103, "pole_packed": 167, "curl_mix": 280}


def run_pole_lab(smi: str, launches: dict) -> list:
    """Phase 25: each pole-lab kernel against its plain version at the
    lab's size (24 x 64 x 128, R = 600, GRID = 16), every repeat's copy
    equal; ``curl_mix`` on the lab's constant window at R = 600 and on a
    random one at R = 40 (the mix grows ~1.8x a repeat); kernel ms and
    TFLOP/s under the lab's flop model, plain ms, registers."""
    from tidy3d_tpu_torch.labs import _common, pole_lab

    dev = torch.device("cuda")
    out = []
    for variant in pole_lab.VARIANTS:
        cases = [(pole_lab.R, None)]
        if variant == "curl_mix":
            cases = [(pole_lab.R, pole_lab.CURL_MIX_WINDOW), (40, None)]
        worst = 0.0
        for reps, constant in cases:
            inputs = pole_lab.make_inputs(variant, seed=31, device=dev,
                                          constant=constant)
            got = pole_lab.run(variant, inputs, reps=reps, copies=True)
            sync()
            assert all(torch.equal(got[0], got[g])
                       for g in range(1, got.shape[0])), \
                f"{variant}: the grid's copies differ"
            ref, plain_ms = timed(lambda: pole_lab.REFERENCES[variant](
                *inputs, reps=reps))
            rel, ab = lab_err({"o": got[0]}, {"o": ref[0]})
            tol = pole_lab.kernel_tolerance(variant, reps)
            what = "constant" if constant is not None else "random"
            log(f"[pole_lab] {variant}, R={reps}, {what} window: kernel vs "
                f"plain max rel err {rel:.3e} (max abs {ab:.3e}, tol "
                f"{tol:.3g}); {got.shape[0]} copies equal")
            assert rel <= tol, f"pole_lab {variant} R={reps}: {rel:.3e}"
            worst = max(worst, ab)
            if reps == pole_lab.R:
                timed_inputs, timed_plain = inputs, plain_ms
            del got, ref
        ms = cuda_ms(lambda: pole_lab.run(variant, timed_inputs), 3)
        fl = pole_lab.flops(variant)
        window = timed_inputs[1 if variant.startswith("pole") else 0].shape
        bnd = bound(nbytes(timed_inputs) + int(np.prod(window)) * (
            2 if variant.endswith("bf16") else 4), pole_lab.ops(variant),
            pole_lab.peak(variant))
        regs = _common.registers_of("lab_pole", variant.replace("_bf16", ""))
        extra = {}
        if variant == "curl_mix":
            extra = dict(pole_lab.curl_mix_resources(),
                         **ptxas_of("lab_pole", "curl_mix_kernel"),
                         sass=_common.sass_classes("lab_pole",
                                                   "curl_mix_kernel"))
            log(f"[pole_lab] curl_mix: {extra['threads']} threads, "
                f"{extra['registers']} registers, {extra['spill_bytes']} B "
                f"spilled, {extra['smem']} B shared, "
                f"{extra['blocks_per_sm']} blocks/SM, no cluster (one block "
                f"a window plane); kernel/bound {ms / bnd[0]:.2f}; SASS of "
                f"the repeat loop {extra['sass']}")
            assert extra["spill_bytes"] == 0, extra
            # the edge rows only: 3 stores and 3 loads of 16 B a half-step
            assert extra["sass"]["lds"] <= 6 and extra["sass"]["sts"] <= 6, \
                extra["sass"]
        if variant == "pole_chan_bf16":
            # no contraction: one operation a lane and instruction, half
            # the bf16 peak's two (an FMA) a lane
            extra["sass"] = _common.sass_classes("lab_pole",
                                                 "pole_chan_bf16_kernel")
            log(f"[pole_lab] pole_chan_bf16: kernel/bound {ms / bnd[0]:.2f}, "
                f"kernel/floor {ms / (2 * bnd[0]):.2f} (no-contraction floor "
                f"{2 * bnd[0]:.3f} ms); SASS of the repeat loop {extra['sass']}")
            assert extra["sass"]["bf16x2"] > 0 and \
                extra["sass"]["convert"] == 0, extra["sass"]
        log(f"[pole_lab] {variant}: kernel {ms:.3f} ms/call "
            f"({fl / (ms * 1e-3) / 1e12:.2f} TFLOP/s), plain "
            f"{timed_plain:.3f} ms, bound {bnd[0]:.3f} ms by {bnd[1]}; "
            f"ptxas {regs} | {smi}")
        out.append(entry(
            f"pole_lab_{variant}", "tidy3d_tpu_torch/csrc/lab_pole.cu",
            f"scripts/pole_lab.py:{POLE_LAB_LINES[variant]}",
            launches[variant], worst, ms, timed_plain, bnd, **extra))
    return out


def run_timemonitors(td, smi: str, flux_kstep: np.ndarray) -> int:
    """Phase 30: ``web.run`` under the default tier of the dispersive case
    with time monitors off the group ends (``timemonitor_case``), the launch
    counts set to 0 just before it and read just after: the fused tier, one
    fused call a step and no family or k-step launch, finite non-zero time
    series, the DFT flux within ``TOL_FLUX`` of phase 9's k-step run
    (``flux_kstep``), the memory estimate at least the peak. Returns the
    fused calls."""
    t_phase = time.perf_counter()
    w = web_run(td, timemonitor_case(td), "dispersive with time monitors, "
                "default tier", smi)
    assert w.tier == "fused", w.tier
    assert w.launches == {"family": 0, "fused": w.steps, "kstep": 0}, \
        w.launches
    assert w.device_launches == 0, w.device_launches
    probe = np.asarray(w.data["probe"].Ez.values)
    flux_t = np.asarray(w.data["flux_time"].flux.values)
    for name, series in (("probe Ez", probe), ("flux_time", flux_t)):
        assert series.size > 1 and np.all(np.isfinite(series)), name
        assert np.any(series != 0), name
    err = float(np.max(np.abs(w.flux - flux_kstep))
                / np.max(np.abs(flux_kstep)))
    what, est, peak, base = MEMORY[-1]
    log(f"[timemon] {what}: kernel tier {w.tier}, {w.steps} steps, "
        f"{w.launches['fused']} fused calls; probe {probe.shape} and "
        f"flux-time {flux_t.shape} samples finite and non-zero (|flux_t| max "
        f"{float(np.max(np.abs(flux_t))):.4e}); DFT flux vs the k-step run's "
        f"max rel err {err:.3e} (tol {TOL_FLUX:g}); {w.rate} Gcell*steps/s; "
        f"peak {peak - base} B, estimate {est} B (ratio "
        f"{est / max(peak - base, 1):.3f}); phase took "
        f"{time.perf_counter() - t_phase:.1f} s | {smi}")
    assert err <= TOL_FLUX, f"time-monitor run: flux rel err {err:.3e}"
    assert est >= peak - base, (est, peak, base)
    return w.launches["fused"]


def raw_err(ref: dict, got: dict) -> float:
    """The largest difference of two raw monitor sets, relative to the
    largest magnitude of each monitor."""
    assert set(ref) == set(got)
    worst = 0.0
    for idx in ref:
        assert set(ref[idx]) == set(got[idx]), idx
        if not ref[idx]:
            continue
        scale = max(float(np.max(np.abs(v))) for v in ref[idx].values())
        for comp, r in ref[idx].items():
            g = got[idx][comp]
            assert g.shape == r.shape and np.all(np.isfinite(g)), (idx, comp)
            worst = max(worst, float(np.max(np.abs(g - r))) / max(scale,
                                                                  1e-30))
    return worst


def bf16_variants() -> list:
    """``(name, defines)`` of the bf16 kernel libraries: the family and
    fused kernels storing everything in bf16, and the k-step kernel in the
    four combinations beside float32 (psi; Q; psi and Q; all three)."""
    from tidy3d_tpu_torch.solver.kernels import step

    bf, f = torch.bfloat16, torch.float32
    out = [(name, step.storage_defines(bf, bf, bf))
           for name in ("step", "fused")]
    return out + [("kstep", step.storage_defines(*c)) for c in (
        (f, bf, f), (f, f, bf), (f, bf, bf), (bf, bf, bf))]


def bf16_compare(got: dict, ref: dict, what: str) -> tuple:
    """``(largest relative difference, largest absolute difference, share
    of bit-equal values)`` of a bf16 kernel's flat output against its plain
    version's, each of fields, psi and pole currents relative to its own
    largest magnitude; asserts ``TOL_BF16``."""
    worst_rel = worst_abs = 0.0
    for group in ("E", "H", "psi", "Q"):
        keys = [key for key in ref if key.split(":")[0].rstrip(
            "0123456789") == group]
        if not keys:
            continue
        g = {key: got[key] for key in keys}
        r = {key: ref[key] for key in keys}
        worst_abs = max(worst_abs, max_diff(g, r))
        worst_rel = max(worst_rel, rel_err(g, r))
    share = equal_share(got, ref)
    log(f"[bf16] {what}: kernel vs plain max rel err {worst_rel:.3e} (max "
        f"abs {worst_abs:.3e}, tol {TOL_BF16:g}), {share:.4%} of the values "
        f"bit-equal")
    assert worst_rel <= TOL_BF16, f"{what}: rel err {worst_rel:.3e}"
    return worst_rel, worst_abs, share


def run_bf16(td, dev, smi: str, plan, plan_d, plan_m, w_f32) -> list:
    """Phase 28: bf16 storage on the card. The bf16 libraries' build
    seconds and resources; each bf16 kernel against its bf16 plain version
    at full size; 200 k-step steps in turns; ``web.run`` of the dispersive
    case in bf16 (against ``w_f32``, phase 9's float32 run) under a memory
    limit that refuses the float32 run; short ``web.run``s that launch the
    other instantiations on their main paths. Returns the kernels line's
    bf16 entries."""
    from tidy3d_tpu_torch import _build, convert
    from tidy3d_tpu_torch.exceptions import SetupError
    from tidy3d_tpu_torch.labs import _common
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
    from tidy3d_tpu_torch.solver.kernels import fused, kstep, step
    from tidy3d_tpu_torch.solver.lowering import lower

    bf, f = torch.bfloat16, torch.float32
    bf16 = (bf, bf, bf)
    t_phase = time.perf_counter()
    # the libraries (built with the others in phase 2)
    for name, defines in bf16_variants():
        label = _build.label(name, defines)
        info = _build.BUILDS[label]
        regs = _common.registers(label)
        log(f"[bf16] build {label}: built={info.built} in {info.seconds:.2f} "
            f"s (all sources in parallel), {len(regs)} kernels")
        if name != "kstep":
            for mangled, (r, st_, ld_) in sorted(regs.items()):
                log(f"[bf16] {label} {mangled}: {r} registers, spill "
                    f"{st_}/{ld_} B")
            continue
        storage = tuple(bf if f"T3D_{k}_BF16" in defines else f
                        for k in ("FIELD", "PSI", "Q"))
        rows = []
        for (np_, bl, bulk), (r, st_, ld_) in sorted(
                kstep_registers(label).items()):
            occ = kstep.occupancy(np_, bl, bulk, storage)
            rows.append(f"{'Bloch' if bl else f'NP={np_}'} "
                        f"{'bulk' if bulk else 'shell'} {r} regs, spill "
                        f"{st_}/{ld_} B, {occ} blocks/SM")
        log(f"[bf16] {label}: " + "; ".join(rows))
    onestep = {}
    for what, storage in (("float32", (f, f, f)), ("bf16", bf16)):
        onestep[what] = onestep_resources(storage)
        log(f"[bf16] {what} libraries: family kernel "
            f"{onestep[what]['family']}, fused kernel "
            f"{onestep[what]['fused']}")
    res = {}

    # one family half-step (E and H), kernel against plain
    def family(runner, seed, what, reps):
        state = random_state(runner, seed)
        worst, src = (0.0, 0.0, 1.0), state["H"]
        for fam in ("E", "H"):
            before = step.LAUNCHES
            kf, kp = step.family_update(fam, state, runner.consts, src,
                                        runner.meta)
            sync()
            assert step.LAUNCHES == before + 1, "kernel did not launch"
            assert {v.dtype for v in kf.values()} == {bf}
            rf, rp = step.family_update_reference(fam, state, runner.consts,
                                                  src, runner.meta)
            e = bf16_compare(flat_state({"E": kf, "psi": kp, "Q": []}),
                             flat_state({"E": rf, "psi": rp, "Q": []}),
                             f"{what} family {fam}")
            worst = (max(worst[0], e[0]), max(worst[1], e[1]),
                     min(worst[2], e[2]))
            src = rf
        if not reps:
            return worst, None
        nE = src

        def pair(fn):
            def once():
                e_, _ = fn("E", state, runner.consts, state["H"],
                           runner.meta)
                fn("H", state, runner.consts, e_, runner.meta)
            return once

        k_ms = cuda_ms(pair(step.family_update), reps) / 2
        p_ms = cuda_ms(pair(step.family_update_reference), 2) / 2
        ncell = int(np.prod(runner.shape))
        bnd = bound(
            (3 * nbytes(state["E"], state["H"]) + 2 * nbytes(state["psi"])
             + nbytes(stepping_consts(runner))) / 2,
            OPS_FAMILY * ncell + OPS_PSI * numel(state["psi"]) / 2)
        del nE
        log(f"[bf16] {what}: family kernel {k_ms:.3f} ms/launch, plain "
            f"{p_ms:.3f}; bound {bnd[0]:.3f} ms by {bnd[1]}, ratio "
            f"{k_ms / bnd[0]:.2f} | {smi}")
        return worst, (k_ms, p_ms, bnd)

    mixed = lower(mixed_case(td, dispersive=True))
    family(FDTDRunner(mixed, device=dev, precision="bfloat16",
                      kernel="pallas2"), 21, "64x48x80 mixed, 1 pole", 0)
    res["family"] = family(FDTDRunner(plan, device=dev, precision="bfloat16",
                                      kernel="pallas2"), 22,
                           f"{plan.shape} broadband", 20)

    # one fused step on the dispersive case
    fr = FDTDRunner(plan_d, device=dev, precision="bfloat16", kernel="fused")
    state = random_state(fr, 23)
    src = step_sources(fr)
    before = fused.LAUNCHES
    got = fused.fused_step(state, fr.consts, fr.meta, src)
    sync()
    assert fused.LAUNCHES == before + 1, "fused kernel did not launch"
    assert {qr.dtype for Qp in got[3] for qr, _ in Qp.values()} == {bf}
    ref = fused.fused_step_reference(state, fr.consts, fr.meta, src)
    e_fused = bf16_compare(fused_flat(got), fused_flat(ref),
                           f"{plan_d.shape} dispersive fused step (Q' "
                           "included)")
    del got, ref
    q_out = q_buffers(state)
    f_ms = cuda_ms(lambda: fused.fused_step(state, fr.consts, fr.meta, src,
                                            q_out=q_out), 20)
    fp_ms = timed(lambda: fused.fused_step_reference(state, fr.consts,
                                                     fr.meta, src))[1]
    f_bnd = bound(*fused_work(fr, state))
    log(f"[bf16] {plan_d.shape} dispersive: fused kernel {f_ms:.3f} ms/step, "
        f"plain {fp_ms:.3f}; bound {f_bnd[0]:.3f} ms by {f_bnd[1]}, ratio "
        f"{f_ms / f_bnd[0]:.2f} | {smi}")
    res["fused"] = (e_fused, (f_ms, fp_ms, f_bnd))
    del state, fr, q_out

    # one k-step group: broadband and dispersive in bf16, the 7-pole Au
    # case with the pole state alone in bf16, the Bloch dipole in bf16
    def group(runner, seed, what, reps=10):
        st = random_state(runner, seed)
        k, t0 = runner.k, 36
        before = kstep.LAUNCHES
        got = kstep.kstep_group(st, runner.consts, runner.meta,
                                runner.tables, t0, k, out=st["alt"])
        sync()
        assert kstep.LAUNCHES == before + 1, "k-step kernel did not launch"
        assert step.storage_of(got, kstep.COPIES[:1 + runner.is_complex]) \
            == runner.storage
        ref, p_ms = timed(lambda: kstep.kstep_group_reference(
            st, runner.consts, runner.meta, runner.tables, t0, k))
        err = bf16_compare(flat_state(got), flat_state(ref),
                           f"{what} k-step group ({runner.storage_name})")
        del got, ref
        g_ms = cuda_ms(lambda: kstep.kstep_group(
            st, runner.consts, runner.meta, runner.tables, t0, k,
            out=st["alt"]), reps)
        bnd = group_bound(runner, st, k)
        r = kstep_resources(len(runner.plan.poles), runner.is_complex,
                            runner.storage)
        log(f"[bf16] {what}: k-step kernel {g_ms:.3f} ms/group, plain "
            f"{p_ms:.3f}; bound {bnd[0]:.3f} ms/group by {bnd[1]} (the "
            f"group's bytes at its storage types), ratio "
            f"{g_ms / bnd[0]:.2f}; registers {r['registers']}, blocks per "
            f"SM {r['blocks_per_sm']} | {smi}")
        return err, (g_ms, p_ms, bnd), r

    res["broadband"] = group(FDTDRunner(plan, device=dev,
                                        precision="bfloat16",
                                        kernel="kstep"), 24,
                             f"{plan.shape} broadband")
    kd = FDTDRunner(plan_d, device=dev, precision="bfloat16", kernel="kstep")
    res["dispersive"] = group(kd, 25, f"{plan_d.shape} dispersive")
    os.environ["TIDY3D_TPU_Q_DTYPE"] = "bfloat16"
    try:
        km = FDTDRunner(plan_m, device=dev, kernel="kstep")
    finally:
        del os.environ["TIDY3D_TPU_Q_DTYPE"]
    assert km.storage == (f, f, bf), km.storage
    res["q"] = group(km, 26, f"{plan_m.shape} 7-pole Au, Q in bf16", 5)
    del km
    plan_b = lower(bloch_case(td))
    res["bloch"] = group(FDTDRunner(plan_b, device=dev, precision="bfloat16"),
                         27, f"{plan_b.shape} Bloch dipole")

    # 4 virtual x-shards of the dispersive case, one group
    sr = sharded_runner(plan_d, [dev] * 4, precision="bfloat16")
    glob = random_state(kd, 28)
    states = convert.shard_states_from_reference(glob, sr)
    del glob
    before = kstep.SHARDED_LAUNCHES
    news = shard_group(kstep.kstep_group, sr, states, 36)
    sync()
    assert kstep.SHARDED_LAUNCHES == before + 4, "sharded kernel idle"
    got = flat_state(convert.shard_states_to_reference(news, sr,
                                                       tensors=True))
    ref, sp_ms = timed(lambda: convert.shard_states_to_reference(
        shard_group(kstep.kstep_group_reference, sr, states, 36), sr,
        tensors=True))
    e_sh = bf16_compare(got, flat_state(ref), "4 x-shards dispersive group")
    del got, ref
    s_ms = cuda_ms(lambda: shard_group(kstep.kstep_group, sr, states, 36), 5)
    # at the bf16 sizes, as phase 12's float32 bound
    s_bnd, u_bnd, _ = sharded_bound(kd, kd.init_state(), states, kd.k)
    log(f"[bf16] 4 x-shards dispersive: group {s_ms:.3f} ms (exchange and "
        f"4 launches), plain {sp_ms:.3f}; bound {s_bnd[0]:.3f} ms by "
        f"{s_bnd[1]} (unsharded {u_bnd[0]:.3f}) | {smi}")
    # the sharded runner's own loop: 20 steps, launch counts read around
    kstep.SHARDED_LAUNCHES = 0
    sr.run_steps(0, 20, sr.init_state())
    sync()
    res["sharded"] = (e_sh, (s_ms, sp_ms, s_bnd), kstep.SHARDED_LAUNCHES)
    assert res["sharded"][2] == 4 * 20 // sr.k, res["sharded"][2]
    del sr, states, news, kd

    # 200 k-step steps of the dispersive case, kernel against plain
    rates = compare_runners_bf16(plan_d, dev, smi)

    # web.run of the dispersive case in bf16 under a limit between the
    # bf16 and the float32 estimate: the float32 run refused, no launch
    est = {name: FDTDRunner(plan_d, device=dev, precision=prec)
           .estimate_device_memory()["total"]
           for name, prec in (("f32", None), ("bf16", "bfloat16"))}
    limit = (est["f32"] + est["bf16"]) // 2
    assert est["bf16"] < limit < est["f32"], est
    os.environ["TIDY3D_TPU_HBM_BYTES"] = str(limit)
    try:
        step.LAUNCHES = fused.LAUNCHES = kstep.LAUNCHES = 0
        kstep.DEVICE_LAUNCHES = 0
        try:
            td.web.run(dispersive_case(td), task_name="chip_smoke",
                       verbose=False)
            raise AssertionError("the float32 run passed the memory gate")
        except SetupError as err:
            refused = str(err)
        launches = (step.LAUNCHES, fused.LAUNCHES, kstep.LAUNCHES,
                    kstep.DEVICE_LAUNCHES)
        assert not any(launches), launches
        log(f"[bf16] TIDY3D_TPU_HBM_BYTES={limit} (estimates: float32 "
            f"{est['f32']}, bf16 {est['bf16']} B): the float32 web.run "
            f"raised SetupError ({refused[:100]}...), launches {launches}")
        os.environ["TIDY3D_TPU_PRECISION"] = "bfloat16"
        w = web_run(td, dispersive_case(td), "dispersive bf16, default tier",
                    smi)
    finally:
        del os.environ["TIDY3D_TPU_HBM_BYTES"]
        os.environ.pop("TIDY3D_TPU_PRECISION", None)
    assert w.storage == "fields bfloat16, psi bfloat16, Q bfloat16", \
        w.storage
    k = int(w.tier.split("k=")[1].rstrip(")"))
    assert w.launches == {"family": 0, "fused": 0, "kstep": w.steps // k}, \
        w.launches
    dev_flux = float(np.max(np.abs(w.flux - w_f32.flux))
                     / np.max(np.abs(w_f32.flux)))
    log(f"[bf16] web.run dispersive: bf16 flux vs float32 flux max rel dev "
        f"{dev_flux:.3e} (tol {TOL_BF16_FLUX:g}); Gcell*steps/s bf16 "
        f"{w.rate} vs float32 {w_f32.rate}; peak memory bf16 "
        f"{w.peak} B vs float32 {w_f32.peak} B "
        f"({w.peak / w_f32.peak:.3f}) | {smi}")
    assert dev_flux <= TOL_BF16_FLUX, dev_flux

    # the other instantiations on short main paths (web.run, launch counts
    # set to 0 just before each and read just after)
    main = {"kstep": w.launches["kstep"]}
    os.environ["TIDY3D_TPU_PRECISION"] = "bfloat16"
    try:
        for name, tier in (("family", "pallas2"), ("fused", "fused")):
            wm = web_run(td, mixed_dft_case(td, dispersive=True),
                         f"64x48x80 mixed bf16, {tier} tier", smi,
                         tier=tier)
            assert wm.launches[name] > 0 and sum(wm.launches.values()) == \
                wm.launches[name], wm.launches
            main[name] = wm.launches[name]
        wb = web_run(td, bloch_case(td), "Bloch dipole bf16, default tier",
                     smi)
        assert wb.launches == {"family": 0, "fused": 0,
                               "kstep": wb.steps // k}, wb.launches
        main["bloch"] = wb.launches["kstep"]
        os.environ["TIDY3D_TPU_PRECISION"] = "float32"
        os.environ["TIDY3D_TPU_Q_DTYPE"] = "bfloat16"
        wq = web_run(td, mixed_dft_case(td, dispersive=True),
                     "64x48x80 mixed, Q in bf16, kstep tier", smi,
                     tier="kstep")
        assert wq.storage == "fields float32, psi float32, Q bfloat16"
        assert wq.launches["kstep"] > 0 and sum(wq.launches.values()) == \
            wq.launches["kstep"], wq.launches
        main["q"] = wq.launches["kstep"]
    finally:
        os.environ.pop("TIDY3D_TPU_PRECISION", None)
        os.environ.pop("TIDY3D_TPU_Q_DTYPE", None)
    log(f"[bf16] phase 28 took {time.perf_counter() - t_phase:.1f} s; main "
        f"path launches {main}")

    src_step, src_fused = ("tidy3d_tpu_torch/csrc/step.cu",
                           "tidy3d_tpu_torch/csrc/fused.cu")
    kstep_src = "tidy3d_tpu_torch/csrc/kstep.cu"
    kstep_tpu = "tidy3d_tpu/solver/kernels/pallas_kstep.py:1425"
    (fe, (fk, fp, fb)) = res["family"]
    out = [entry("family_update_bf16", src_step,
                 "tidy3d_tpu/solver/kernels/pallas_step.py:118",
                 main["family"], fe[1], fk, fp, fb, bit_equal=fe[2],
                 instantiations=onestep["bf16"]["family"]),
           entry("fused_step_bf16", src_fused,
                 "tidy3d_tpu/solver/kernels/pallas_fused.py:109",
                 main["fused"], res["fused"][0][1], res["fused"][1][0],
                 res["fused"][1][1], res["fused"][1][2],
                 bit_equal=res["fused"][0][2],
                 instantiations=onestep["bf16"]["fused"])]
    for name, key, launches in (("kstep_group_bf16", "dispersive",
                                 main["kstep"]),
                                ("kstep_group_q_bf16", "q", main["q"]),
                                ("kstep_group_bloch_bf16", "bloch",
                                 main["bloch"])):
        e, (g, p, b), r = res[key]
        out.append(entry(name, kstep_src, kstep_tpu, launches, e[1], g, p, b,
                         bit_equal=e[2], **r))
    e, (g, p, b), n = res["sharded"]
    out.append(entry("kstep_group_sharded_bf16", kstep_src,
                     f"{kstep_tpu} with :1386", n, e[1], g, p, b,
                     bit_equal=e[2]))
    log(f"[bf16] broadband group: {res['broadband'][1][0]:.3f} ms vs bound "
        f"{res['broadband'][1][2][0]:.3f}; 200-step rates {rates}")
    return out


def compare_runners_bf16(plan, dev, smi: str) -> dict:
    """200 steps of ``plan`` on the kstep tier in bf16, kernel against
    plain in turns plain, kernel, kernel, plain; fields within
    ``TOL_BF16``. Returns the Gcell*steps/s of each."""
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner

    ncell = int(np.prod(plan.shape))
    runners = {name: FDTDRunner(plan, device=dev, precision="bfloat16",
                                kernel="kstep", use_kernel=name == "kernel")
               for name in ("plain", "kernel")}
    rates = {"plain": [], "kernel": []}
    finals = {}
    for name in ("plain", "kernel", "kernel", "plain"):
        st, secs = run_steps_timed(runners[name], STEPS_COMPARE)
        rates[name].append(ncell * STEPS_COMPARE / secs / 1e9)
        finals[name] = {f"{fam}:{c}": v for fam in ("E", "H")
                        for c, v in st[fam].items()}
        del st
    err = rel_err(finals["kernel"], finals["plain"])
    log(f"[bf16] dispersive {plan.shape}, kstep tier in bf16: "
        f"{STEPS_COMPARE} steps kernel vs plain max rel err {err:.3e} (tol "
        f"{TOL_BF16:g}), {equal_share(finals['kernel'], finals['plain']):.4%}"
        f" bit-equal; Gcell*steps/s plain {rates['plain']} kernel "
        f"{rates['kernel']} | {smi}")
    assert max_abs(finals["plain"]) > 0
    assert err <= TOL_BF16, f"200 bf16 steps: rel err {err:.3e}"
    return rates


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import tidy3d_tpu_torch as td
    from tidy3d_tpu_torch.solver.lowering import lower
    from tidy3d_tpu_torch import _build
    from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
    from tidy3d_tpu_torch.solver.kernels import fused, kstep, step

    os.makedirs(OUT_DIR, exist_ok=True)
    LOG_FILE.append(open(os.path.join(OUT_DIR, "chip_smoke_log.txt"), "w"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    # 2. build the seven kernel sources, in parallel
    sources = ["step", "fused", "kstep", "post_e", "lab_step", "lab_kstep",
               "lab_pole"]
    # with the bf16 variants of phase 28: one nvcc each, all at once
    _build.load_all(sources + bf16_variants())
    for name in sources:
        info = _build.BUILDS[name]
        log(f"[build] {info.path} built={info.built} in {info.seconds:.2f} s")
        for line in info.ptxas.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] ptxas: {line.strip()}")
    # every instantiation of the k-step kernel, bulk and shell
    for (np_, bl, bulk), (regs, st, ld) in sorted(kstep_registers().items()):
        log(f"[build] kstep {'Bloch' if bl else f'NP={np_}'} "
            f"{'bulk' if bulk else 'shell'}: {regs} registers, spill "
            f"{st}/{ld} B, {kstep.occupancy(np_, bl, bulk)} blocks of 512 "
            f"threads per SM")
    assert len(kstep_registers()) == 2 * (kstep.MAX_POLES + 2)
    # the one-step kernels' instantiations and the SASS of their bulk march
    # loops, float32 and bf16
    onestep, sass = {}, {}
    bf = torch.bfloat16
    for what, storage in (("float32", (torch.float32,) * 3),
                          ("bf16", (bf, bf, bf))):
        onestep[what] = onestep_resources(storage)
        for kern in ("family", "fused"):
            log(f"[build] {what} {kern} kernel: " + "; ".join(
                f"{k}: {v['registers']} regs, spill {v['spill_bytes']} B, "
                f"{v['blocks_per_sm']} blocks of 256 threads per SM"
                for k, v in onestep[what][kern].items()))
        sass[what] = onestep_sass(storage)
        for loop, cls in sass[what].items():
            log(f"[build] {what} {loop} bulk march loop SASS: {cls}")
    for loop, cls in sass["bf16"].items():
        # bf16 pairs load as 32-bit words: no 16-bit load in a bulk loop
        assert not any(k.endswith(".16") for k in cls["loads"]), (loop, cls)
        assert cls["loads"].get("LDGSTS.32", 0) > 0, (loop, cls)
    log_new_instantiations()

    stamp("3")
    # 3. one family update, kernel against plain
    mixed = FDTDRunner(lower(mixed_case(td)), device=dev, kernel="pallas2")
    assert mixed.shape == (64, 48, 80), mixed.shape
    compare_update(step, mixed, random_state(mixed, 1), "64x48x80 mixed")
    mixed_d = FDTDRunner(lower(mixed_case(td, dispersive=True)), device=dev,
                         kernel="pallas2")
    assert len(mixed_d.plan.poles) == 1
    err_family_poles = compare_update(
        step, mixed_d, random_state(mixed_d, 3), "64x48x80 mixed, 1 pole")

    t0 = time.perf_counter()
    plan = lower(full_case(td))
    lower_s = time.perf_counter() - t0
    ncell = int(np.prod(plan.shape))
    log(f"[full] grid {plan.shape} = {ncell} cells, {plan.num_steps} steps, "
        f"lowered in {lower_s:.1f} s")
    kr = FDTDRunner(plan, device=dev, kernel="pallas2")
    state = random_state(kr, 2)
    err_full = compare_update(step, kr, state, f"{plan.shape} full")
    log(f"[update] {plan.shape}: family kernel blocks of the bulk and "
        f"shell launches and device launches {step.LAST_BLOCKS}")

    def update_pair(fn):
        def once():
            nE, _ = fn("E", state, kr.consts, state["H"], kr.meta)
            fn("H", state, kr.consts, nE, kr.meta)
        return once

    k_ms = cuda_ms(update_pair(step.family_update), 20) / 2
    p_ms = cuda_ms(update_pair(step.family_update_reference), 5) / 2
    # per launch, half of the E and H pair: each reads 6 fields and writes
    # 3, with its psi slabs read and written
    fam_bound = bound(
        (3 * nbytes(state["E"], state["H"]) + 2 * nbytes(state["psi"])
         + nbytes(stepping_consts(kr))) / 2,
        OPS_FAMILY * ncell + OPS_PSI * numel(state["psi"]) / 2)
    log(f"[update] {plan.shape}: family kernel {k_ms:.3f} ms/launch "
        f"({36 * ncell / (k_ms * 1e-3) / 1e9:.0f} GB/s at 36 B/cell), plain "
        f"{p_ms:.3f} ms/launch | {smi}")
    del state, kr

    stamp("4")
    # 4. 200 steps on the two-phase tier, plain / kernel / kernel / plain
    rates_2 = compare_runners(plan, dev, ncell, "broadband 384^3", smi,
                              kernel="pallas2")

    stamp("5")
    # 5. one fused step, kernel against plain; times at 384^3
    compare_fused(fused, mixed_d, random_state(mixed_d, 4),
                  "64x48x80 mixed, 1 pole")
    del mixed, mixed_d
    t0 = time.perf_counter()
    plan_d = lower(dispersive_case(td))
    log(f"[dispersive] grid {plan_d.shape}, {len(plan_d.poles)} pole, "
        f"{plan_d.num_steps} steps, lowered in "
        f"{time.perf_counter() - t0:.1f} s")
    fr = FDTDRunner(plan_d, device=dev, kernel="fused")
    assert fr.tier == "fused" and len(plan_d.poles) == 1
    state = random_state(fr, 5)
    err_fused = compare_fused(fused, fr, state, f"{plan_d.shape} dispersive")
    src = step_sources(fr)
    q_out = q_buffers(state)
    f_ms = cuda_ms(lambda: fused.fused_step(state, fr.consts, fr.meta, src,
                                            q_out=q_out), 20)
    fp_ms = cuda_ms(lambda: fused.fused_step_reference(
        state, fr.consts, fr.meta, src), 5)
    # one step: E, H, psi, Q and the constants read, E', H', psi', Q'
    # written; the pole term and the pole update inside
    fused_bound = bound(*fused_work(fr, state))
    log(f"[fused] {plan_d.shape} dispersive: fused kernel {f_ms:.3f} "
        f"ms/step with the pole update ({fused_bound[0]:.3f} ms bound by "
        f"{fused_bound[1]}, ratio {f_ms / fused_bound[0]:.2f}), plain "
        f"{fp_ms:.3f} ms/step | {smi}")
    fb = FDTDRunner(plan, device=dev, kernel="fused")
    st_b = random_state(fb, 6)
    src_b = step_sources(fb)
    fb_ms = cuda_ms(lambda: fused.fused_step(st_b, fb.consts, fb.meta,
                                             src_b), 20)
    fb_bound = bound(*fused_work(fb, st_b))
    log(f"[fused] {plan.shape} broadband: fused kernel {fb_ms:.3f} ms/step "
        f"({fb_bound[0]:.3f} ms bound by {fb_bound[1]}, ratio "
        f"{fb_ms / fb_bound[0]:.2f}) vs two family launches "
        f"{2 * k_ms:.3f} ms | {smi}")
    del state, q_out, st_b, fb

    stamp("6")
    # 6. 200 steps on the fused tier: dispersive 384^3 and 7-pole Au 280^3
    rates_d = compare_runners(plan_d, dev, ncell, "dispersive 384^3", smi,
                              kernel="fused")
    plan_m = lower(metal_case(td))
    ncell_m = int(np.prod(plan_m.shape))
    assert len(plan_m.poles) == 7, len(plan_m.poles)
    log(f"[metal] grid {plan_m.shape}, {len(plan_m.poles)} poles")
    mr = FDTDRunner(plan_m, device=dev, kernel="fused")
    st_m = random_state(mr, 7)
    err_metal = compare_fused(fused, mr, st_m, f"{plan_m.shape} 7-pole Au")
    src_m = step_sources(mr)
    q_m = q_buffers(st_m)
    m_ms = cuda_ms(lambda: fused.fused_step(st_m, mr.consts, mr.meta,
                                            src_m, q_out=q_m), 10)
    m_bound = bound(*fused_work(mr, st_m))
    log(f"[metal] {plan_m.shape}: fused kernel {m_ms:.3f} ms/step with the "
        f"7 poles' update ({m_bound[0]:.3f} ms bound by {m_bound[1]}, ratio "
        f"{m_ms / m_bound[0]:.2f}) | {smi}")
    del st_m, q_m, mr
    rates_m = compare_runners(plan_m, dev, ncell_m, "7-pole Au 280^3", smi,
                              kernel="fused")

    stamp("7")
    # 7. the k-step kernel: one group against plain, times, 200 steps
    mk = FDTDRunner(lower(mixed_case(td, dispersive=True)), device=dev,
                    kernel="kstep")
    err_kstep = [compare_kstep(kstep, mk, random_state(mk, 8),
                               "64x48x80 mixed, 1 pole")]
    del mk
    ks_ms, ks_bound, ks_res, ks_lists = {}, {}, {}, {}
    for what, kplan, nc, seed, fused_ms in (
            ("broadband", plan, ncell, 9, fb_ms),
            ("dispersive", plan_d, ncell, 10, f_ms),
            ("7-pole Au", plan_m, ncell_m, 11, m_ms)):
        kr = FDTDRunner(kplan, device=dev, kernel="kstep")
        assert kr.k == 2, kr.k
        st = random_state(kr, seed)
        err_kstep.append(compare_kstep(kstep, kr, st,
                                       f"{kplan.shape} {what}"))
        k = kr.k

        def group(fn):
            return lambda: fn(st, kr.consts, kr.meta, kr.tables, 36, k,
                              out=st["alt"])

        g_ms = cuda_ms(group(kstep.kstep_group), 10)
        gp_ms = cuda_ms(group(kstep.kstep_group_reference), 3)
        ks_ms[what] = (g_ms, gp_ms)
        ks_bound[what] = group_bound(kr, st, k)
        ks_res[what] = kstep_resources(len(kplan.poles), False)
        ks_lists[what] = lists_per_group(kr)
        nb, ns = (len(ids) for ids in kstep.classify_blocks(kr.meta, k))
        log(f"[kstep] {kplan.shape} {what}, k={k}: k-step kernel {g_ms:.3f} "
            f"ms/group = {g_ms / k:.3f} ms/step ({nc * k / g_ms / 1e6:.2f} "
            f"Gcell*steps/s), plain {gp_ms:.3f} ms/group = {gp_ms / k:.3f} "
            f"ms/step; bound {ks_bound[what][0]:.3f} ms/group by "
            f"{ks_bound[what][1]}, ratio {g_ms / ks_bound[what][0]:.2f}; "
            f"fused kernel (pole update inside) {fused_ms:.3f} ms/step | "
            f"{smi}")
        log(f"[kstep] {what}: {nb} bulk and {ns} shell blocks "
            f"({nb / (nb + ns):.1%} bulk), {ks_lists[what]} device launches "
            f"a group, registers {ks_res[what]['registers']}, blocks per SM "
            f"{ks_res[what]['blocks_per_sm']}")
        del st, kr
    compare_runners(plan, dev, ncell, "broadband 384^3", smi, kernel="kstep")
    rates_kd = compare_runners(plan_d, dev, ncell, "dispersive 384^3", smi,
                               kernel="kstep")
    rates_km = compare_runners(plan_m, dev, ncell_m, "7-pole Au 280^3", smi,
                               kernel="kstep")

    stamp("8")
    # 8. profile windows
    p2 = profile_window(FDTDRunner(plan, device=dev, kernel="pallas2"),
                        os.path.join(OUT_DIR, "chip_smoke_prof_pallas2.txt"))
    report_profile(p2, "broadband, two-phase tier",
                   ncell / (float(np.mean(rates_2["kernel"])) * 1e9) * 1e3,
                   smi)
    pf = profile_window(fr, os.path.join(OUT_DIR, "chip_smoke_prof_fused.txt"))
    report_profile(pf, "dispersive, fused tier",
                   ncell / (float(np.mean(rates_d["kernel"])) * 1e9) * 1e3,
                   smi)
    # the fused tier updates the poles inside its kernel: no plain update
    assert pf["poles_ranges"] == 0, pf["poles_ranges"]
    del fr
    pk = profile_window(FDTDRunner(plan_d, device=dev, kernel="kstep"),
                        os.path.join(OUT_DIR, "chip_smoke_prof_kstep.txt"))
    report_profile(pk, "dispersive, kstep tier",
                   ncell / (float(np.mean(rates_kd["kernel"])) * 1e9) * 1e3,
                   smi)

    stamp("9")
    # 9. the main paths: web.run, launch counts read around each
    none = {"family": 0, "fused": 0, "kstep": 0}
    w2 = web_run(td, full_case(td), "broadband, two-phase tier", smi,
                 tier="pallas2")
    assert w2.launches == dict(none, family=2 * w2.steps), w2.launches
    wfd = web_run(td, dispersive_case(td), "dispersive, fused tier", smi,
                  tier="fused")
    assert wfd.launches == dict(none, fused=wfd.steps), wfd.launches
    wfb = web_run(td, full_case(td), "broadband, fused tier", smi,
                  tier="fused")
    assert wfb.launches == dict(none, fused=wfb.steps), wfb.launches
    n_kstep = 0
    rates_k, w_k = {}, {}
    for what, sim, wf in (("dispersive", dispersive_case(td), wfd),
                          ("broadband", full_case(td), wfb)):
        w = web_run(td, sim, f"{what}, default tier", smi)
        k = int(w.tier.split("k=")[1].rstrip(")"))
        assert w.tier.startswith("kstep") and w.steps % k == 0, w.tier
        assert w.launches == dict(none, kstep=w.steps // k), (w.launches, k)
        assert w.device_launches == ks_lists[what] * w.steps // k, \
            (w.device_launches, ks_lists[what])
        err = float(np.max(np.abs(w.flux - wf.flux))
                    / np.max(np.abs(wf.flux)))
        log(f"[web.run] {what}: kstep flux vs fused flux max rel err "
            f"{err:.3e} (tol {TOL_FLUX:g})")
        assert err <= TOL_FLUX, f"{what}: kstep flux rel err {err:.3e}"
        n_kstep += w.launches["kstep"]
        rates_k[what] = w.rate
        w_k[what] = w
    log(f"[web.run] Gcell*steps/s: broadband two-phase {w2.rate}, fused "
        f"{wfb.rate}, kstep {rates_k['broadband']}; dispersive fused "
        f"{wfd.rate}, kstep {rates_k['dispersive']} | {smi}")

    stamp("28")
    # 28. bf16 storage: every bf16 kernel against its plain version, the
    # bf16 web.run and the memory gate
    bf16_entries = run_bf16(td, dev, smi, plan, plan_d, plan_m,
                            w_k["dispersive"])
    stamp("30")
    # 30. the fused tier on the default path: time monitors off the group
    # ends
    n_fused_auto = run_timemonitors(td, smi, w_k["dispersive"].flux)
    del plan_m, w_k
    torch.cuda.empty_cache()
    stamp("31-35")
    # 31-35. Bloch with poles, more than 8 slots, nonlinear and modulated
    # media: the two-copy and pole-table kernels and post_e
    new_entries = run_fifteenth(td, dev, smi)
    torch.cuda.empty_cache()

    stamp("10-11")
    # 10-11. Bloch (complex) runs
    bloch = run_bloch(td, dev, smi)

    stamp("12-15")
    # 12-15. sharded runs on virtual shards
    shard = run_sharded(td, dev, smi, full_case(td), plan, plan_d)
    torch.cuda.empty_cache()

    stamp("26")
    # 26. the device mode solver against ARPACK
    modes = run_mode_solver(td, smi)
    stamp("16-18")
    # 16-18. mode, mode-solver, permittivity, projection and diffraction
    # monitors through web.run
    n_kstep += run_waveguide(td, smi, modes)
    n_kstep += run_farfield(td, smi, rates_k["broadband"])
    bloch["launches"] += run_diffraction(td, smi, bloch["rate_planewave"])
    stamp("27")
    # 27. web.Job
    n_kstep += run_job(td, smi)
    stamp("19")
    # 19. checkpoint and resume
    run_resume(td, dev, plan_d, smi)
    del plan, plan_d
    stamp("20")
    # 20. web.run under TIDY3D_TPU_PROFILE, in a process of its own
    n_kstep += run_profiled(smi)
    stamp("21")
    # 21. the memory estimate against every run's peak, and the gate
    run_memory(td, smi)
    stamp("29")
    # 29. inverse design on the card: the two-solve adjoint on the k-step
    # kernel, Adam, central differences; the autodiff route
    n_kstep += run_invdes(td, smi)

    stamp("22-25")
    # 22-25. the labs: their entry points, then each kernel against plain
    lab_counts = run_lab_mains(smi)
    labs = run_lab_step(smi, lab_counts["kernel_lab"])
    torch.cuda.empty_cache()
    labs += run_lab_kstep(smi, lab_counts["kernel_lab2"])
    torch.cuda.empty_cache()
    labs += run_pole_lab(smi, lab_counts["pole_lab"])

    leaked = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
    assert not leaked, f"JAX was imported: {leaked[:5]}"

    kstep_src = "tidy3d_tpu_torch/csrc/kstep.cu"
    kstep_tpu = "tidy3d_tpu/solver/kernels/pallas_kstep.py:1425"
    kernels = {"kernels": [
        entry("family_update", "tidy3d_tpu_torch/csrc/step.cu",
              "tidy3d_tpu/solver/kernels/pallas_step.py:118",
              w2.launches["family"], max(err_full, err_family_poles), k_ms,
              p_ms, fam_bound, instantiations=onestep["float32"]["family"],
              sass={f: sass["float32"][f"family {f}"] for f in "EH"},
              sass_bf16={f: sass["bf16"][f"family {f}"] for f in "EH"}),
        entry("fused_step", "tidy3d_tpu_torch/csrc/fused.cu",
              "tidy3d_tpu/solver/kernels/pallas_fused.py:109",
              wfd.launches["fused"] + wfb.launches["fused"] + n_fused_auto,
              max(err_fused, err_metal), f_ms, fp_ms, fused_bound,
              instantiations=onestep["float32"]["fused"],
              sass=sass["float32"]["fused NP=1"],
              sass_bf16=sass["bf16"]["fused NP=1"]),
        entry("kstep_group", kstep_src, kstep_tpu, n_kstep, max(err_kstep),
              ks_ms["dispersive"][0], ks_ms["dispersive"][1],
              ks_bound["dispersive"], **ks_res["dispersive"]),
        entry("kstep_group_bloch", kstep_src, kstep_tpu, bloch["launches"],
              bloch["err"], bloch["ms"], bloch["plain_ms"], bloch["bound"],
              registers=bloch["registers"],
              blocks_per_sm=bloch["blocks_per_sm"]),
        entry("kstep_group_sharded", kstep_src,
              f"{kstep_tpu} with :1386", shard["launches"], shard["err"],
              shard["ms"], shard["plain_ms"], shard["bound"],
              registers=shard["registers"],
              blocks_per_sm=shard["blocks_per_sm"]),
    ] + new_entries + bf16_entries + labs}
    stamp("36")
    log(f"[time] chip_smoke.py took {time.perf_counter() - t_start:.1f} s; "
        f"phases begun at (s): {STAMPS}")
    log(smi)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
