"""``web.autograd.run_structure_gradients`` in the port against the JAX
package's: the two-solve adjoint gradients of a medium's permittivity, a
box's size and a polyslab's vertices on the simulation of
``tests/test_plugins/test_shape_adjoint.py`` (``make_sim``: a dipole, one
structure and a point field monitor in a 48^3 PML box), with the
objective written twice, in ``jnp`` and in ``torch``, with the same
arithmetic. Values and gradients must agree to ``TOL`` relative (of the
largest magnitude for a vector): measured 2.1e-7 in value, 1.3e-7 for the
permittivity and for the box size and 6.1e-7 for the vertices. Both
solves of the port run on the CPU (``device="cpu"``), on the fused tier.
"""

import numpy as np
import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch.web.autograd import RECORDS, run_structure_gradients

# first: where h5py is missing it makes the JAX package importable
import tests.torch_cases  # noqa: F401
import jax.numpy as jnp
from tests.test_plugins.test_shape_adjoint import VERTS0, make_sim
from tidy3d_tpu.web.autograd import \
    run_structure_gradients as ref_structure_gradients

TOL = 1e-4
CASES = {
    "box": (dict(), {0: [("medium", "permittivity"), ("geometry", "size")]}),
    "polyslab": (dict(verts=VERTS0), {0: [("geometry", "vertices")]}),
}


def objective_jnp(fields):
    return jnp.sum(jnp.abs(fields["point"]["Ez"]) ** 2)


def objective_torch(fields):
    return torch.sum(torch.abs(fields["point"]["Ez"]) ** 2)


@pytest.fixture(scope="module")
def gradients():
    """Each case's (value, gradients) in both packages; the port's runs on
    one CPU thread (the plain versions run their many small operations
    fastest so, beside the suite's other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name, (kw, traced) in CASES.items():
            sim = make_sim(**kw)
            ref_v, ref_g, _ = ref_structure_gradients(sim, objective_jnp,
                                                      traced)
            RECORDS.clear()
            v, g, data = run_structure_gradients(
                tt.Simulation.parse_raw(sim.json()), objective_torch,
                traced, device="cpu")
            assert len(RECORDS) == 1
            out[name] = (ref_v, ref_g, v, g, data, RECORDS[-1])
    finally:
        torch.set_num_threads(threads)
    return out


def _rel(ref, got) -> float:
    ref, got = np.asarray(ref, float), np.asarray(got, float)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.max(np.abs(ref - got)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("name, path", [
    ("box", ("medium", "permittivity")), ("box", ("geometry", "size")),
    ("polyslab", ("geometry", "vertices"))])
def test_structure_gradient_matches_jax(gradients, name, path):
    ref_v, ref_g, v, g, _, _ = gradients[name]
    e_val = abs(v - ref_v) / abs(ref_v)
    e_grad = _rel(ref_g[0][path], g[0][path])
    print(f"{name} {path}: value {e_val:.1e}, gradient {e_grad:.1e}")
    assert e_val <= TOL and e_grad <= TOL
    assert np.all(np.asarray(g[0][path]) != 0)


def test_records_and_logs(gradients):
    """Each call records its stages' host seconds and both runs' logs,
    which name the tier and the source-term counts."""
    for name in CASES:
        rec = gradients[name][-1]
        assert all(rec[key] > 0 for key in ("forward_s", "vjp_s",
                                            "adjoint_s", "assembly_s"))
        for key in ("forward_log", "adjoint_log"):
            lines = rec[key].splitlines()
            assert lines[-1].startswith("kernel tier: fused"), lines[-1]
            assert lines[-2].startswith("source terms: E "), lines[-2]
