"""BENCHMARK.json against the benchmark's contract, and each
configuration's grid and step count as its file states them."""

import json
import re
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import cell
from benchmark.reference import yee

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level():
    assert set(MAN) == KEYS
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries(section, keys):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]


def test_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    for w in cells:
        assert any(w in m.get("workloads", cells) for m in MAN["per_layer"])


def test_cells_and_files():
    configs = {c["name"]: c for c in MAN["configs"]}
    used = set()
    pairs = set()
    for w in MAN["workloads"]:
        assert w["chips"] == 1
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        assert (ROOT / "benchmark" / "mixes" / f"{w['traffic']}.json").exists()
        assert len(w["why"]) <= 200
    assert used == set(configs)
    for c in configs.values():
        assert c["file"].startswith("benchmark/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert all(k in data for k in c["reduced"])
        assert (ROOT / "benchmark" / "configs" / f"{c['name']}.py").exists()


@pytest.mark.parametrize("name", ["soi_dc", "au_grating"])
def test_grid_and_steps(name):
    """The grid and the step count are those the file states, for every
    seed and mix: a seed draws physics, never the work."""
    man = cell.manifest()
    for w in [w for w in man["workloads"] if w["config"] == name]:
        c = cell.load(w["name"])
        want = c["config"]["expect"]
        for seed in (0, 7, 2 ** 31 + 5):
            p = cell.draw(c["config"], c["mix"], seed)
            grid = yee.Grid(c["module"].problem(p))
            assert list(grid.shape) == want["shape"]
            assert int(np.prod(grid.shape)) == want["cells"]
            assert len(grid.tmesh) == want["num_steps"]


@pytest.mark.parametrize("name", ["soi_dc", "au_grating"])
def test_port_sees_the_same_grid(name):
    import tidy3d_tpu_torch as td

    man = cell.manifest()
    w = [w for w in man["workloads"] if w["config"] == name][0]
    c = cell.load(w["name"])
    p = cell.draw(c["config"], c["mix"], 11)
    sim = c["module"].simulation(td, p)
    assert list(sim.grid.num_cells) == c["config"]["expect"]["shape"]
    assert len(sim.tmesh) == c["config"]["expect"]["num_steps"]


def test_grating_fits_are_the_library_s():
    """The grating's pole residues are the material library's Rakic fits."""
    import tidy3d_tpu_torch as td

    cfg = json.loads((ROOT / "benchmark/configs/au_grating.json").read_text())
    for key, metal in (("au", "Au"), ("cr", "Cr")):
        lib = td.material_library[metal]["RakicLorentzDrude1998"]
        assert cfg[key]["eps_inf"] == float(lib.eps_inf)
        got = [complex(ar, ai) for ar, ai, _, _ in cfg[key]["poles_re_im"]]
        assert np.allclose(got, [complex(a) for a, _ in lib.poles],
                           rtol=1e-15)


def test_draw_is_fixed_by_the_seed():
    c = cell.load("au_grating.oblique")
    a = cell.draw(c["config"], c["mix"], 2 ** 31 + 17)
    b = cell.draw(c["config"], c["mix"], 2 ** 31 + 17)
    assert a["drawn"] == b["drawn"]
    assert 25.0 <= a["angle_phi_deg"] <= 35.0
    assert 1.5 <= a["source_wavelength_um"] <= 1.6
