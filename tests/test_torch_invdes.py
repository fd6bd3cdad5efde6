"""``tidy3d_tpu_torch.plugins.invdes`` against the JAX package's.

``TopologyDesignRegion.transform`` (clip, conic filter, tanh projection)
and ``penalty`` (the erosion-dilation penalty) and their VJPs on seeded
parameters, to ``TOL_VALUE`` / ``TOL_GRAD`` of the largest magnitude
(measured: transform 3.7e-7 / 2.1e-7, penalty 1.3e-7 / 5.7e-6: the
penalty projects twice at beta = 100, which scales float32 rounding of
the filtered values by ~1e4 in its gradient); ``InverseDesign.objective_fn``
on both gradient methods (``adjoint``: two ``web.run`` solves;
``autodiff``: ``TopologyObjective``), its value to ``TOL_VALUE_RUN``
relative and its gradient to ``TOL_GRAD_RUN`` of the largest magnitude
(measured: adjoint 5.0e-7 / 1.9e-4, autodiff 5.7e-7 / 1.9e-4, both the
penalty's gradient on these parameters); and 2 ``AdamOptimizer`` steps
against the JAX package's optax run: histories to ``TOL_ADAM`` relative
and the parameters to ``TOL_ADAM`` (measured 7.8e-8 and 2.6e-6). The runs
use the coupling case of ``tests/test_plugins/test_adjoint_invdes.py`` cut
to half its run time (362 steps), with a filter radius of 2 cells and a
penalty, so that every stage of the chain carries a gradient; the port's
solves run on the CPU (``device="cpu"``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch.plugins.invdes import (
    AdamOptimizer, InverseDesign, TopologyDesignRegion,
)

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import COUPLING_REGION, coupling, to_reference
import tidy3d_tpu
from tidy3d_tpu.plugins import invdes as ref_invdes

TOL_VALUE = 1e-6
TOL_GRAD = 1e-5
TOL_VALUE_RUN = 1e-4    # relative
TOL_GRAD_RUN = 1e-3     # of the largest |gradient|
TOL_ADAM = 1e-3
REGION = dict(COUPLING_REGION, eps_bounds=(1.0, 6.0), radius=0.12,
              beta=3.0, penalty_weight=0.05)


def _rel(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.max(np.abs(ref - got)) / np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def sims():
    """The case in both packages (half the run time of the JAX test's)."""
    sim = coupling(run_time=5e-14)
    return sim, to_reference(sim)


def _designs(sims, method):
    sim, ref_sim = sims
    port = InverseDesign(simulation=sim,
                         design_region=TopologyDesignRegion(**REGION),
                         output_monitor_name="out", method=method,
                         device="cpu")
    ref = ref_invdes.InverseDesign(
        simulation=ref_sim,
        design_region=ref_invdes.TopologyDesignRegion(**REGION),
        output_monitor_name="out", method=method)
    return port, ref


@pytest.mark.parametrize("ndim", [2, 3])
def test_transform_and_penalty_match_jax(ndim):
    region = dict(REGION, radius=0.2, beta=5.0, penalty_weight=0.3)
    port = TopologyDesignRegion(**region)
    ref = ref_invdes.TopologyDesignRegion(**region)
    shape = (10, 10, 2) if ndim == 3 else (12, 9)
    rng = np.random.default_rng(0)
    # a few parameters beyond [0, 1]: the clip's gradient is zero there
    params = rng.uniform(-0.1, 1.1, shape).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    for fn in ("transform", "penalty"):
        want, vjp = jax.vjp(lambda p: getattr(ref, fn)(p, dl=0.1),
                            jnp.asarray(params))
        p = torch.tensor(params, requires_grad=True)
        got = getattr(port, fn)(p, dl=0.1)
        assert _rel(want, got.detach().numpy()) <= TOL_VALUE, fn
        cot = w if fn == "transform" else np.float32(1.0)
        (g_ref,) = vjp(jnp.asarray(cot))
        (g,) = torch.autograd.grad(got, p, torch.as_tensor(cot))
        err = _rel(g_ref, g.numpy())
        print(f"{fn} {ndim}D: value {_rel(want, got.detach().numpy()):.1e}, "
              f"VJP {err:.1e}")
        assert err <= TOL_GRAD, (fn, err)
    density = port.transform(params, dl=0.1).numpy()
    assert density.min() >= -1e-6 and density.max() <= 1 + 1e-6


@pytest.mark.parametrize("method", ["adjoint", "autodiff"])
def test_objective_fn_matches_jax(sims, method):
    port, ref = _designs(sims, method)
    params = np.random.default_rng(1).uniform(
        0.3, 0.7, port.design_region.params_shape(sims[0])).astype(
        np.float32)
    v_ref, g_ref = ref.objective_fn(params)
    v, g = port.objective_fn(params)
    e_val = abs(v - v_ref) / abs(v_ref)
    e_grad = _rel(g_ref, g)
    print(f"objective_fn {method}: value {e_val:.1e}, gradient {e_grad:.1e}")
    assert e_val <= TOL_VALUE_RUN and e_grad <= TOL_GRAD_RUN
    assert g.dtype == np.float32 and np.max(np.abs(g)) > 0


def test_adam_matches_optax(sims):
    port, ref = _designs(sims, "adjoint")
    res_ref = ref_invdes.AdamOptimizer(design=ref, num_steps=2,
                                       learning_rate=0.1).run()
    res = AdamOptimizer(design=port, num_steps=2, learning_rate=0.1).run()
    e_hist = _rel(res_ref.objective_history, res.objective_history)
    e_par = float(np.max(np.abs(np.asarray(res_ref.params)
                                - np.asarray(res.params))))
    print(f"Adam: histories {e_hist:.1e}, params {e_par:.1e}")
    assert e_hist <= TOL_ADAM and e_par <= TOL_ADAM
    assert res.params.dtype == np.float32
    assert len(res.params_history) == 2
    sim_final = port.to_simulation(res.params)
    assert len(sim_final.structures) == len(sims[0].structures) + 1


def test_adam_step_is_optax():
    """``adam_step`` repeats optax's ``adam`` on float32 numpy: three
    updates of a seeded gradient sequence, bit for bit."""
    import optax

    from tidy3d_tpu_torch.plugins.invdes.optimizer import adam_init, adam_step

    rng = np.random.default_rng(2)
    params = rng.random((5, 4)).astype(np.float32)
    opt = optax.adam(0.1, b1=0.9, b2=0.999, eps=1e-8)
    st_ref, st = opt.init(params), adam_init(params)
    for _ in range(3):
        g = rng.standard_normal(params.shape).astype(np.float32)
        u_ref, st_ref = opt.update(g, st_ref, params)
        u, st = adam_step(g, st, 0.1, 0.9, 0.999, 1e-8)
        assert u.dtype == np.float32
        np.testing.assert_allclose(u, np.asarray(u_ref), rtol=1e-6, atol=0)
