"""The port's host constants against the JAX runner's, exactly.

Both runners build their stepping constants from the same
``SimulationPlan``; the port fixes the tile quanta at 1, 1, 1, so the
reference runs with ``TIDY3D_TPU_TILE_QUANTA=1,1,1`` on its XLA path.
"""

import numpy as np
import pytest

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    DISPERSIVE, lower_reference as lower, SIMS,
)
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

import tidy3d_tpu_torch as td
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner, build_constants


def _equal(a, b, path):
    if isinstance(a, dict):
        assert set(a) == set(b), f"{path}: keys {sorted(a)} != {sorted(b)}"
        for key in a:
            _equal(a[key], b[key], f"{path}/{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: lengths differ"
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype, f"{path}: dtype {x.dtype} != {y.dtype}"
        assert x.shape == y.shape, f"{path}: shape {x.shape} != {y.shape}"
        assert np.array_equal(x, y), f"{path}: values differ"


@pytest.mark.parametrize("case", sorted(SIMS) + sorted(DISPERSIVE))
def test_constants_match_reference(case, monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "xla")
    plan = lower({**SIMS, **DISPERSIVE}[case]())
    ref = JaxRunner(plan)
    consts, pml_meta = build_constants(plan)
    assert pml_meta == ref.pml_meta
    # the pole scalars and residue kinds live on the reference runner, the
    # pole tables in its consts
    runner_attrs = {"pole_scalars", "pole_B_meta"}
    assert set(ref.consts) == set(consts) - runner_attrs
    assert consts["pole_scalars"] == ref.pole_scalars
    assert consts["pole_B_meta"] == ref.pole_B_meta
    assert len(consts["pole_scalars"]) == len(plan.poles)
    _equal({k: ref.consts[k] for k in consts if k not in runner_attrs},
           {k: v for k, v in consts.items() if k not in runner_attrs},
           "consts")


def test_runner_device_consts_are_the_host_consts():
    plan = lower(SIMS["dielectric_mixed"]())
    runner = FDTDRunner(plan, device="cpu")
    host = runner.host_consts
    for fam in ("coeffs_E", "coeffs_H"):
        for comp, (ca, cb) in host[fam].items():
            for h, d in ((ca, runner.consts[fam][comp][0]),
                         (cb, runner.consts[fam][comp][1])):
                if np.ndim(h):
                    assert np.array_equal(d.numpy(), h)
                else:
                    assert d == float(h)
    for a in range(3):
        assert np.array_equal(runner.consts["inv_dual"][a].numpy(),
                              host["inv_dual"][a])


def test_unsupported_plans_raise(monkeypatch):
    # nine Lorentz poles: one more pole slot than the kernels take
    disp = td.Structure(
        geometry=td.Box(center=(0, 0, 0), size=(0.3, 0.3, 0.3)),
        medium=td.Lorentz(eps_inf=2.0, coeffs=[
            (1.0, 3e14 * (1 + 0.1 * i), 1e13) for i in range(9)]))
    sim = SIMS["pml_all"]().copy(update=dict(structures=[disp]))
    with pytest.raises(NotImplementedError, match="dispersive pole slots"):
        FDTDRunner(lower(sim), device="cpu")
    # bfloat16 storage runs (test_bf16_precision_runs_on_every_tier); an
    # unknown storage precision is refused
    with pytest.raises(NotImplementedError, match="precision 'float16'"):
        FDTDRunner(lower(SIMS["pml_all"]()), device="cpu",
                   precision="float16")
    # Bloch runs step on the kstep tier, but not with dispersive poles
    bloch = SIMS["pml_all"]().copy(update=dict(
        structures=[disp.copy(update=dict(medium=td.Lorentz(
            eps_inf=2.0, coeffs=[(1.0, 3e14, 1e13)])))],
        boundary_spec=td.BoundarySpec(
            x=td.Boundary.bloch(bloch_vec=0.3), y=td.Boundary.pml(),
            z=td.Boundary.pml())))
    with pytest.raises(NotImplementedError, match="Bloch"):
        FDTDRunner(lower(bloch), device="cpu")


@pytest.mark.parametrize("tier", ["kstep", "fused", "pallas2"])
def test_bf16_precision_runs_on_every_tier(tier):
    """``precision="bfloat16"`` runs on every tier: fields, psi and pole
    currents stored in bfloat16, as the JAX package stores them on each
    tier (``_cast_state``; the k-step kernel's psi and Q types default to
    the fields'), the monitor accumulators in float32."""
    import torch

    sim = SIMS["pml_all"]()
    runner = FDTDRunner(lower(sim), device="cpu", precision="bfloat16",
                        kernel=tier)
    assert runner.tier == tier
    bf16 = torch.bfloat16
    assert runner.storage == (bf16, bf16, bf16)
    state = runner.run_steps(0, 4, runner.init_state())
    assert {v.dtype for fam in ("E", "H", "psi")
            for v in state[fam].values()} == {bf16}
    assert all(torch.isfinite(v.float()).all() for v in state["E"].values())
    assert max(float(v.float().abs().max()) for v in state["E"].values()) > 0
