"""More modulation entries than ``post_e``'s parameter block holds.

``csrc/post_e.cu`` takes up to ``MAX_ENTRIES`` (8) modulation entries in
its parameter block; a plan with more passes them all, with their time
samples of the step, in a device table, so that one launch takes every
entry and E' is rounded to the fields' type once, after the last entry and
the fixed point, as the reference rounds it
(``tidy3d_tpu/solver/fdtd.py:1632-1688``, then ``_cast_state``).

Checked on the CPU: the nine-entry plan's constants against the JAX
runner's and one ``pallas2`` step against its XLA ``_step`` (1e-6 of the
largest magnitude), and the plain version's single rounding in bf16. On a
card (``gpu``, skipped without one): the table launch against
``post_e_reference`` within one bf16 step of the largest |E'| in bf16, and
in float32 bit-equal to the two launches (8 entries, then 1) the kernel
made before the table.
"""

import jax
import numpy as np
import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch import convert
from tidy3d_tpu_torch.solver import nonlinear
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.kernels import post_e as post_e_kernels

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    DL, FREQ0, SIZE, lower_reference as lower, max_rel_err, random_state,
)
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

NUM_ENTRIES = 9
TOL_STEP = 1e-6
STEP = 20


@pytest.fixture(autouse=True)
def _xla(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "xla")


def _medium(i: int):
    """Permittivity modulated at f0 / (3 + i), conductivity in every other
    one: one modulation entry each."""
    stm = tt.SpaceTimeModulation(
        time_modulation=tt.ContinuousWaveTimeModulation(
            freq0=FREQ0 / (3 + i), amplitude=0.3, phase=0.4 + 0.1 * i),
        space_modulation=tt.SpatialModulationUniform(amplitude=1.0,
                                                    phase=0.2))
    return tt.Medium(permittivity=2.0, conductivity=0.5,
                     modulation_spec=tt.ModulationSpec(
                         permittivity=stm,
                         conductivity=stm if i % 2 else None))


def nine_entries(monitors=False):
    """Nine nested boxes around a strong Ez dipole, each of its own
    modulated medium, PML on every side. Lowering gives each structure its
    entry over its whole box, so the innermost cells take all nine in
    turn (where a rounding between entries would show)."""
    return tt.Simulation(
        center=(0, 0, 0), size=SIZE, run_time=3.5e-15,
        sources=[tt.PointDipole(
            center=(0.02, -0.01, 0.03), polarization="Ez",
            source_time=tt.GaussianPulse(freq0=FREQ0, fwidth=FREQ0 / 5,
                                         amplitude=1e3))],
        structures=[tt.Structure(
            geometry=tt.Box(center=(0, 0, 0),
                            size=(0.45 - 0.03 * i, 0.35 - 0.02 * i,
                                  0.6 - 0.04 * i)),
            medium=_medium(i)) for i in range(NUM_ENTRIES)],
        monitors=[tt.FluxMonitor(center=(0, 0, 0), size=(0.35, 0.3, 0.45),
                                 freqs=[FREQ0], name="flux")]
        if monitors else [],
        boundary_spec=tt.BoundarySpec.all_sides(tt.PML(num_layers=3)),
        grid_spec=tt.GridSpec.uniform(dl=DL), shutoff=0.0)


def test_nine_entries_match_xla():
    """The constants (nine entries, each with its maps) and one step from
    a random state against the JAX runner's XLA ``_step``."""
    plan = lower(nine_entries())
    jr = JaxRunner(plan)
    port = FDTDRunner(plan, device="cpu")
    assert port.tier == "pallas2"
    assert len(port.host_consts["mod"]) == len(jr.consts["mod"]) \
        == NUM_ENTRIES > post_e_kernels.MAX_ENTRIES
    for ce, ref in zip(port.host_consts["mod"], jr.consts["mod"]):
        assert set(ce) == set(ref)
        for key in ("Beps", "Bsig"):
            for comp, pair in ce.get(key, {}).items():
                for v, r in zip(pair, ref[key][comp]):
                    np.testing.assert_array_equal(v, r)
    st = random_state(np.random.default_rng(7), port.shape,
                      port.psi_shapes())
    st["H"] = {c: np.float32(1e-2) * v for c, v in st["H"].items()}
    ref = jax.device_get(jr._step(STEP, jax.device_put(dict(st, mon=[])),
                                  jax.device_put(jr.consts)))
    got = convert.state_to_reference(
        port.step(STEP, convert.state_from_reference(st, port)))
    for fam in ("E", "H"):
        err = max_rel_err(ref[fam], got[fam])
        assert err <= TOL_STEP, f"{fam}: rel err {err:.2e}"


def _passes_inputs(runner, seed=11):
    """E_lin of the order of E from a seeded random state, and E."""
    st = convert.state_from_reference(random_state(
        np.random.default_rng(seed), runner.shape, runner.psi_shapes()),
        runner)
    gen = torch.Generator(device=runner.device).manual_seed(seed)
    new = {c: v * (1.0 + 1e-2 * torch.rand(v.shape, generator=gen,
                                            device=v.device)).to(v.dtype)
           for c, v in st["E"].items()}
    return new, st["E"]


def test_plain_passes_round_once_in_bf16():
    """In bf16 the plain version keeps E' in float32 through all nine
    entries and rounds it once: it equals the float32 result rounded,
    where rounding after the eighth entry would not."""
    runner = FDTDRunner(lower(nine_entries()), device="cpu",
                        precision="bfloat16")
    new, old = _passes_inputs(runner)
    got = nonlinear.post_e_reference(new, old, runner.consts, STEP)
    wide = nonlinear.post_e_reference(new, old, runner.consts, STEP,
                                      store=False)
    mods = runner.consts["mod"]
    split = nonlinear.post_e_reference(new, old, dict(runner.consts,
                                                      mod=mods[:8]), STEP)
    split = nonlinear.post_e_reference(split, old, dict(runner.consts,
                                                        mod=mods[8:]), STEP)
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    for c in got:
        assert torch.equal(got[c], wide[c].to(torch.bfloat16)), c
    assert any(not torch.equal(got[c], split[c]) for c in got)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_table_launch_matches_plain(precision, cuda):
    """One launch of the table instantiation: in bf16 bit-equal to
    ``post_e_reference``, where the split launches of the kernel before the
    table (E' rounded between them) are not; in float32 within 1e-6 of it
    and bit-equal to the split launches."""
    from tidy3d_tpu_torch.solver.lowering import lower as port_lower

    runner = FDTDRunner(port_lower(nine_entries()), device=cuda,
                        precision=precision)
    new, old = _passes_inputs(runner)
    ref = nonlinear.post_e_reference(new, old, runner.consts, STEP)
    calls, tables = post_e_kernels.LAUNCHES, post_e_kernels.TABLE_LAUNCHES
    got = post_e_kernels.post_e({c: v.clone() for c, v in new.items()},
                                old, runner.consts, STEP)
    assert post_e_kernels.LAUNCHES == calls + 1
    assert post_e_kernels.TABLE_LAUNCHES == tables + 1
    mods = runner.consts["mod"]
    split = post_e_kernels.post_e({c: v.clone() for c, v in new.items()},
                                  old, dict(runner.consts, mod=mods[:8]),
                                  STEP)
    split = post_e_kernels.post_e(split, old, dict(runner.consts,
                                                   mod=mods[8:]), STEP)
    scale = max(float(v.float().abs().max()) for v in ref.values())
    diff = max(float((got[c].float() - ref[c].float()).abs().max())
               for c in ref)
    if precision == "float32":
        assert diff <= 1e-6 * scale, diff / scale
        assert all(torch.equal(got[c], split[c]) for c in got)
    else:
        assert all(torch.equal(got[c], ref[c]) for c in got), diff
        assert any(not torch.equal(split[c], ref[c]) for c in split)
