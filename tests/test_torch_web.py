"""``tidy3d_tpu_torch.web.run`` against ``tidy3d_tpu.web.run``, and the
port's import path without JAX.

The reference runs with its defaults on the CPU (the XLA path); the port
runs its plain PyTorch path with ``device="cpu"``. Flux and field data of
the two ``SimulationData`` agree to 2e-5 of the largest magnitude.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import SIMS, monitors, to_reference
from tidy3d_tpu import web as ref_web

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch.exceptions import WebError

TOL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-30))


def test_web_run_matches_reference():
    mons = monitors() + [tt.FluxTimeMonitor(
        center=(0, 0, 0), size=(0.3, 0.25, 0.4), interval=2,
        name="flux_t")]
    sim = SIMS["pml_all"](monitors=mons, run_time=2e-14)
    ref = ref_web.run(to_reference(sim), verbose=False)
    got = tt.web.run(sim, device="cpu", verbose=False)
    assert isinstance(got, tt.SimulationData)
    for name in ("flux", "flux_t"):
        r, g = ref[name].flux, got[name].flux
        assert r.values.shape == g.values.shape
        assert np.all(np.isfinite(g.values)) and np.any(g.values != 0)
        assert _rel(r.values, g.values) <= TOL, name
    for name, comps in (("field", ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")),
                        ("time", ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"))):
        scale = max(np.max(np.abs(getattr(ref[name], c).values))
                    for c in comps)
        for c in comps:
            r = getattr(ref[name], c)
            g = getattr(got[name], c)
            assert r.values.shape == g.values.shape
            for dim in r.dims:
                assert np.allclose(r.coords[dim], g.coords[dim]), (name, dim)
            err = np.max(np.abs(r.values - g.values)) / scale
            assert err <= TOL, f"{name}.{c}: rel err {err:.2e}"
    assert "Gcell*steps/s" in got.log


def test_web_run_refuses_what_is_not_ported():
    """A nonlinear Bloch run raises before the run, with the reference's
    words (``tidy3d_tpu/solver/fdtd.py:124-127``); a nonlinear (Kerr) and a
    time-modulated medium run on the ``pallas2`` tier and give the JAX
    package's flux (``solver/nonlinear.py``)."""
    box = tt.Box(center=(0, 0, 0.1), size=(0.2, 0.2, 0.2))
    kerr = tt.Medium(permittivity=2.0, nonlinear_spec=tt.NonlinearSpec(
        models=[tt.KerrNonlinearity(n2=1e-3)]))
    modulation = tt.ModulationSpec(permittivity=tt.SpaceTimeModulation(
        time_modulation=tt.ContinuousWaveTimeModulation(freq0=1e13,
                                                        amplitude=0.1)))
    modulated = tt.Medium(permittivity=2.0, modulation_spec=modulation)
    for medium in (kerr, modulated):
        sim = SIMS["pml_all"](monitors=monitors()).copy(update=dict(
            structures=[tt.Structure(geometry=box, medium=medium)]))
        got = tt.web.run(sim, device="cpu", verbose=False)
        assert "kernel tier: pallas2" in got.log
        ref = ref_web.run(to_reference(sim), verbose=False)
        for mon in sim.monitors:
            if hasattr(ref[mon.name], "flux"):
                err = _rel(ref[mon.name].flux.values,
                           got[mon.name].flux.values)
                assert err <= TOL, f"{mon.name}: rel err {err:.2e}"
    bloch = SIMS["pml_all"]().copy(update=dict(
        structures=[tt.Structure(geometry=box, medium=kerr)],
        boundary_spec=tt.BoundarySpec(
            x=tt.Boundary.bloch(bloch_vec=0.2), y=tt.Boundary.periodic(),
            z=tt.Boundary.pml(num_layers=3))))
    with pytest.raises(NotImplementedError,
                       match="nonlinear media with Bloch"):
        tt.web.run(bloch, device="cpu", verbose=False)


@pytest.mark.parametrize("knob", ["TIDY3D_TPU_PSI_DTYPE",
                                  "TIDY3D_TPU_Q_DTYPE"])
def test_web_run_bf16_storage_knobs(monkeypatch, knob):
    """The JAX package's k-step kernel stores psi or the pole state in
    bf16 under these knobs (``pallas_kstep.py:158-175``) and its one-step
    tiers read neither; the port runs them on every tier at those types
    and names them on the ``kernel tier:`` line."""
    from tidy3d_tpu_torch.solver.kernels import fused, kstep, step

    monkeypatch.setenv(knob, "bfloat16")
    kind = {"TIDY3D_TPU_PSI_DTYPE": "psi", "TIDY3D_TPU_Q_DTYPE": "Q"}[knob]
    launches = (step.LAUNCHES, fused.LAUNCHES, kstep.LAUNCHES)
    sim = SIMS["pml_all"](monitors=monitors()[1:2], run_time=5e-15)
    for tier, name in (("auto", "fused"), ("kstep", "kstep (k=2)"),
                       ("fused", "fused"), ("pallas2", "pallas2")):
        monkeypatch.setenv("TIDY3D_TPU_KERNEL", tier)
        data = tt.web.run(sim, device="cpu", verbose=False)
        types = {what: "float32" for what in ("fields", "psi", "Q")}
        if name.startswith("kstep"):
            types[kind] = "bfloat16"
        assert data.log.splitlines()[-1] == (
            f"kernel tier: {name} [storage: fields {types['fields']}, "
            f"psi {types['psi']}, Q {types['Q']}]")
        assert np.all(np.isfinite(data["flux"].flux.values))
    assert (step.LAUNCHES, fused.LAUNCHES, kstep.LAUNCHES) == launches


def test_job_and_batch_match_web_run():
    """``web.Job`` and ``web.Batch`` (and ``run_async``) on the CPU give
    the ``SimulationData`` of ``web.run``: the same flux and fields."""
    sims = {"a": SIMS["pml_all"](monitors=monitors(), run_time=5e-15),
            "b": SIMS["periodic"](monitors=monitors(), run_time=5e-15)}
    want = {name: tt.web.run(sim, device="cpu", verbose=False)
            for name, sim in sims.items()}

    def same(got, ref):
        assert isinstance(got, tt.SimulationData)
        for mon in ("flux", "field"):
            for name in ("flux", "Ex", "Ez", "Hy"):
                r = getattr(ref[mon], name, None)
                if r is not None:
                    assert np.array_equal(getattr(got[mon], name).values,
                                          r.values), (mon, name)

    job = tt.web.Job(simulation=sims["a"], task_name="a", device="cpu",
                     verbose=False)
    same(job.run(), want["a"])
    assert job.status == "success"
    batch = tt.web.Batch(simulations=sims, device="cpu", verbose=False)
    results = batch.run()
    assert sorted(results.keys()) == ["a", "b"]
    for name, data in results.items():
        same(data, want[name])
    for name, data in tt.web.run_async(sims, device="cpu",
                                       verbose=False).items():
        same(data, want[name])
    # the default device is the card: without one the task fails there
    if not torch.cuda.is_available():
        job = tt.web.Job(simulation=sims["a"], task_name="gpu",
                         verbose=False)
        with pytest.raises(WebError, match="no CUDA device"):
            job.run()


def test_web_run_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.web.run(SIMS["pml_all"](), verbose=False)


_NO_JAX = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = ("jax", "jaxlib", "h5py", "tidy3d_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ModuleNotFoundError(f"No module named {name!r}",
                                          name=name)
            return None

    sys.meta_path.insert(0, Block())
    import tidy3d_tpu_torch as td
    sim = td.Simulation(
        center=(0, 0, 0), size=(0.5, 0.5, 0.5), run_time=5e-15,
        sources=[td.PointDipole(center=(0, 0, 0), polarization="Ez",
                 source_time=td.GaussianPulse(freq0=2e14, fwidth=5e13))],
        monitors=[td.FluxMonitor(center=(0, 0, 0), size=(0.2, 0.2, 0.2),
                                 freqs=[2e14], name="flux")],
        boundary_spec=td.BoundarySpec.all_sides(td.PML(num_layers=4)),
        grid_spec=td.GridSpec.uniform(dl=0.05))
    data = td.web.run(sim, device="cpu", verbose=False)
    assert data["flux"].flux.values.shape == (1,)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    print("BLOCKED_MODULES", loaded)
""")


_FULL_AFTER_PORT = textwrap.dedent("""
    import sys
    import tidy3d_tpu_torch
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("tidy3d_tpu", "jax")]
    import tidy3d_tpu
    from tidy3d_tpu.components.simulation import Simulation
    assert tidy3d_tpu.Simulation is Simulation   # the real __init__ ran
    from tidy3d_tpu.web.run import run
    assert tidy3d_tpu.web.run is run
    assert tidy3d_tpu.Simulation is not tidy3d_tpu_torch.Simulation
    # a simulation crosses between the packages through its JSON
    sim = tidy3d_tpu_torch.Simulation(
        size=(1, 1, 1), run_time=1e-14,
        grid_spec=tidy3d_tpu_torch.GridSpec.uniform(dl=0.1))
    ref = tidy3d_tpu.Simulation.parse_raw(sim.json())
    assert type(ref) is Simulation
    assert tidy3d_tpu_torch.Simulation.parse_raw(ref.json()) == sim
    print("FULL_OK")
""")


def test_full_package_after_port():
    """The port loads no module of ``tidy3d_tpu`` or JAX, and ``import
    tidy3d_tpu`` beside it is whole: its own classes, its ``web``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _FULL_AFTER_PORT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FULL_OK" in proc.stdout


def test_port_runs_without_jax():
    """``web.run`` of the port with JAX, h5py and ``tidy3d_tpu`` all
    unimportable."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_MODULES []" in proc.stdout, proc.stdout[-2000:]


def test_web_run_refuses_a_foreign_simulation():
    """A simulation of the JAX package is refused with the route across."""
    ref = to_reference(SIMS["pml_all"]())
    with pytest.raises(TypeError, match=r"parse_raw\(sim.json\(\)\)"):
        tt.web.run(ref, device="cpu", verbose=False)
    back = tt.Simulation.parse_raw(ref.json())
    assert back == SIMS["pml_all"]()
