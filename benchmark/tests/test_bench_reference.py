"""The plain reference against the port's plain CPU path at a small size,
on every mix of both configurations, and the reference's independence:
it runs with JAX, the JAX package and the port all blocked."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import compare, program
from benchmark.reference import yee
from benchmark.tests import small

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("workload", ["soi_dc.probe", "au_grating.oblique",
                                      "au_grating.normal"])
def test_reference_agrees_with_the_port(workload, monkeypatch):
    import tidy3d_tpu_torch as td

    # every step sampled on both sides: the tier the port picks on the CPU
    # decides nothing here
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "pallas2")
    c, p = small.params(workload)
    pb = c["module"].problem(p)
    sim = c["module"].simulation(td, p)
    data = td.web.run(sim, device="cpu", verbose=False)
    got = program.outputs(data, pb)
    gaps = compare.gaps(got, yee.solve(pb, "cpu"), pb)
    assert gaps and all(v < 1e-5 for v in gaps.values()), gaps


BLOCKED = """
import sys
for name in ("jax", "jaxlib", "flax", "tidy3d_tpu", "tidy3d_tpu_torch"):
    sys.modules[name] = None
sys.path.insert(0, {root!r})
from benchmark.tests import small
from benchmark.reference import yee
c, p = small.params("au_grating.oblique")
out = yee.solve(c["module"].problem(p), "cpu")
tops = {{m.split(".")[0] for m, v in sys.modules.items() if v is not None}}
bad = tops & {{"jax", "jaxlib", "flax", "tidy3d_tpu", "tidy3d_tpu_torch"}}
assert not bad, bad
print("ok", sorted(out))
"""

SETUP = """
import sys, torch
sys.path.insert(0, {root!r})
import importlib.util
spec = importlib.util.spec_from_file_location("run", {run!r})
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
from benchmark.harness import program
from benchmark.tests import small
from benchmark.reference import yee
import tidy3d_tpu_torch as td
c, p = small.params("soi_dc.probe")
sim = c["module"].simulation(td, p)
plan = program.lower(sim, torch.device("cpu"))
program.warm_up(sim, plan, torch.device("cpu"), program.Spans())
yee.solve(c["module"].problem(p), "cpu")
print("forbidden", run.forbidden_modules())
"""


def test_reference_imports_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c",
                          BLOCKED.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ok" in out.stdout


def test_setup_and_reference_load_no_jax():
    out = subprocess.run([sys.executable, "-c", SETUP.format(
        root=str(ROOT), run=str(ROOT / "benchmark" / "run.py"))],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "forbidden []" in out.stdout
