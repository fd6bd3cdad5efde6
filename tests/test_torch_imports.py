"""The port stands alone: it imports nothing of ``tidy3d_tpu`` or JAX.

An AST scan of every module of ``tidy3d_tpu_torch``, of ``chip_smoke.py``,
of the multi-process tests' worker and of the port's ``labs/`` (no
``tidy3d_tpu`` or ``jax`` import, and every relative import resolves
inside the port); every module of the port
imported, and a small ``web.run`` on the CPU, unsharded and over two
virtual shards (the JAX package's distributed layer imports JAX, so a
stray import of it would show here), in a process where a meta-path finder
makes ``tidy3d_tpu`` and ``jax`` unimportable; and the port's own copy of
``lower()`` against the JAX package's on every simulation of
``tests/torch_cases.py``: the same ``SimulationPlan``, field by field, the
arrays bit for bit.
"""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

from tidy3d_tpu_torch.plugins.mode import device_solver
from tidy3d_tpu_torch.solver.lowering import lower

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import BLOCH, DISPERSIVE, MONITOR_CASES, SIMS, \
    lower_reference, monitors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _mode_solves_on_the_cpu():
    """The mode sources' solves in a bare ``lower()`` run on the CPU."""
    with device_solver.solve_on("cpu"):
        yield
PORT = os.path.join(REPO, "tidy3d_tpu_torch")
FOREIGN = ("tidy3d_tpu", "jax", "jaxlib")


def _sources():
    # chip_smoke.py and the worker of the multi-process tests, whose
    # processes run the port alone
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "tests", "torch_multiprocess_worker.py")]
    for top in (PORT, os.path.join(REPO, "labs")):
        for root, _, files in os.walk(top):
            out += [os.path.join(root, f) for f in files
                    if f.endswith(".py")]
    return sorted(out)


def _package_of(path: str) -> list:
    """The package that holds module ``path`` (an ``__init__`` is its own
    package), as a list of names."""
    return os.path.relpath(path, REPO).split(os.sep)[:-1]


def _exists(dotted) -> bool:
    base = os.path.join(REPO, *dotted)
    return os.path.isfile(base + ".py") or os.path.isfile(
        os.path.join(base, "__init__.py"))


def test_no_module_imports_the_jax_package_or_jax():
    bad, unresolved = [], []
    for path in _sources():
        tree = ast.parse(open(path).read(), path)
        pkg = _package_of(path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.ImportFrom):
                base = pkg[:len(pkg) - (node.level - 1)]
                target = base + (node.module.split(".") if node.module
                                 else [])
                # ``from . import x`` names a module or a name of target
                if not _exists(target) and not all(
                        _exists(target + [a.name]) for a in node.names):
                    unresolved.append((path, node.lineno, ".".join(target)))
            for name in names:
                if name.split(".")[0] in FOREIGN:
                    bad.append((os.path.relpath(path, REPO), node.lineno,
                                name))
    assert len(_sources()) > 60
    assert not bad, bad
    assert not unresolved, unresolved


_BLOCKED = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("tidy3d_tpu", "jax", "jaxlib")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ModuleNotFoundError(f"No module named {name!r}",
                                          name=name)
            return None

    sys.meta_path.insert(0, Block())
    import tidy3d_tpu_torch
    for info in pkgutil.walk_packages(tidy3d_tpu_torch.__path__,
                                      "tidy3d_tpu_torch."):
        importlib.import_module(info.name)
    from tests.torch_cases import SIMS, monitors
    import tidy3d_tpu_torch as td
    data = td.web.run(SIMS["pml_all"](monitors=monitors(), run_time=5e-15),
                      device="cpu", verbose=False)
    assert data["flux"].flux.values.shape == (3,)
    # a sharded run: two virtual CPU shards of the 18 x planes
    import os
    os.environ["TIDY3D_TPU_SHARD"] = "2,1,1"
    sim = SIMS["pml_all"](monitors=monitors()[:2], run_time=5e-15)
    data = td.web.run(sim.copy(update=dict(size=(0.6,) + sim.size[1:])),
                      device="cpu", verbose=False)
    assert "2 x-shards" in data.log
    assert data["flux"].flux.values.shape == (3,)
    os.environ.pop("TIDY3D_TPU_SHARD")
    # the device mode solver, forced onto the CPU, on the 72 x 48 strip of
    # tests/test_plugins/test_mode_tpu.py (eps on one grid for all three)
    import numpy as np
    import torch
    from tidy3d_tpu_torch.plugins.mode import compute_modes, device_solver
    torch.set_num_threads(1)     # small GEMMs beside the suite's workers
    os.environ["TIDY3D_TPU_MODE_SOLVER"] = "filter"
    x_b, y_b = ((np.arange(n + 1) - n / 2) * 0.025 for n in (72, 48))
    xx, yy = np.meshgrid(x_b[:-1], y_b[:-1], indexing="ij")
    eps = np.where((abs(xx) < 0.25) & (abs(yy) < 0.125), 9.0, 1.444**2)
    _, n_eff = compute_modes([eps.astype(complex)] * 3, (x_b, y_b),
                             td.C_0 / 1.55, td.ModeSpec(num_modes=3,
                                                        target_neff=2.2),
                             device="cpu")
    assert device_solver.SOLVES == 1 and device_solver.FALLBACKS == 0
    assert 1.444 < n_eff[0].real < 3.0, n_eff
    # the web layer, the lsf converter and the new exports
    job = td.web.Job(simulation=SIMS["pml_all"](monitors=monitors()[1:2],
                                                run_time=5e-15),
                     task_name="job", device="cpu", verbose=False)
    assert job.run()["flux"].flux.values.shape == (3,)
    from tidy3d_tpu_torch.web.lsf_converter import convert_lsf_to_python
    assert "import tidy3d_tpu_torch as td" in convert_lsf_to_python("addrect;")
    assert td.ModeData and td.Graphene and td.ModulationSpec and td.config
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    print("MODULES", len(list(pkgutil.walk_packages(
        tidy3d_tpu_torch.__path__, "tidy3d_tpu_torch."))), "BLOCKED", loaded)
""")


def test_the_port_imports_and_runs_with_both_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED []" in proc.stdout, proc.stdout[-2000:]


def _public_names(pkg) -> set:
    """The names a package binds at its top level (submodules other than
    ``web`` left out)."""
    return {name for name in dir(pkg) if not name.startswith("_")
            and (name == "web"
                 or not isinstance(getattr(pkg, name), types.ModuleType))}


def _eme_or_heat(obj) -> bool:
    return (getattr(obj, "__module__", None) or "").startswith(
        ("tidy3d_tpu.components.eme", "tidy3d_tpu.components.heat"))


@pytest.mark.parametrize("where", ["top", "web"])
def test_public_names_are_the_references(where):
    """The port binds the JAX package's top-level and ``web`` names, the
    32 of the EME and heat solvers included, each from its own module."""
    import tidy3d_tpu
    import tidy3d_tpu_torch

    ref, port = tidy3d_tpu, tidy3d_tpu_torch
    if where == "web":
        ref, port = ref.web, port.web
        assert sorted(port.__all__) == sorted(ref.__all__)
        assert len(port.__all__) == 14
    want = _public_names(ref)
    got = _public_names(port)
    assert got == want, (sorted(want - got), sorted(got - want))
    if where == "top":
        eme_heat = {n for n in want if _eme_or_heat(getattr(ref, n))}
        assert len(eme_heat) == 32
        for name in sorted(eme_heat) + [
                "ModeData", "ModeSolverData", "DiffractionData",
                "PermittivityData", "FieldDataset", "Updater", "Graphene",
                "RunTimeSpec", "LumpedResistor", "config"]:
            assert getattr(port, name).__module__ == getattr(
                ref, name).__module__.replace(
                    "tidy3d_tpu.", "tidy3d_tpu_torch.", 1), name


def test_plugins_and_solvers_are_the_ports_own():
    """The copied EME and heat solvers and JAX-free plugins: each public
    class of the port lives in the port's module of the reference's
    relative path."""
    import importlib

    for mod, names in (
            ("solver.eme", ["run_eme"]),
            ("components.heat.simulation", ["HeatSimulation"]),
            ("plugins.smatrix", ["ComponentModeler", "Port",
                                 "TerminalComponentModeler"]),
            ("plugins.design", ["DesignSpace", "ParameterFloat"]),
            ("plugins.waveguide", ["RectangularDielectric"]),
            ("plugins.resonance", ["ResonanceFinder"]),
            ("plugins.expressions", ["Expression", "ModePower"]),
            ("plugins.microwave", ["VoltageIntegralAxisAligned"]),
            ("plugins.polyslab", ["ComplexPolySlab"])):
        port = importlib.import_module(f"tidy3d_tpu_torch.{mod}")
        ref = importlib.import_module(f"tidy3d_tpu.{mod}")
        for name in names:
            got, want = getattr(port, name), getattr(ref, name)
            assert got is not want
            assert got.__module__ == want.__module__.replace(
                "tidy3d_tpu.", "tidy3d_tpu_torch.", 1), (mod, name)


def _equal(a, b, path: str):
    """Exact equality of two plans' values: same types by name, arrays of
    the same dtype and shape bit for bit, schema objects by their JSON."""
    assert type(a).__name__ == type(b).__name__, \
        f"{path}: {type(a).__name__} against {type(b).__name__}"
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif hasattr(a, "json") and hasattr(type(a), "model_fields"):
        assert a.json() == b.json(), path
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=True), path
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for key in a:
            _equal(a[key], b[key], f"{path}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, f"{path}: {a!r} against {b!r}"


CASES = {**SIMS, **DISPERSIVE, **BLOCH}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lowering_matches_the_reference(case):
    sim = CASES[case](monitors=monitors())
    got = lower(sim)
    ref = lower_reference(sim)
    assert type(got).__module__ == "tidy3d_tpu_torch.solver.lowering"
    assert type(ref).__module__ == "tidy3d_tpu.solver.lowering"
    _equal(ref, got, case)


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_monitor_case_lowering_matches_the_reference(case):
    """The cases of ``tests/test_torch_monitors.py`` (a mode source, mode,
    mode-solver, permittivity, projection and diffraction monitors) lower
    to the same plan in both packages."""
    sim = MONITOR_CASES[case]()
    _equal(lower_reference(sim), lower(sim), case)
