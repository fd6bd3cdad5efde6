"""A whole run of the harness, the look for a card skipped, at a small
size on the CPU: a sound run comes out correct; the control (the port's
own bfloat16 storage, the precision below the configurations' float32)
and each fault planted in the timed path come out not correct."""

import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import cell
from benchmark.tests import small

RUN = Path(__file__).resolve().parents[1] / "run.py"


def run_cell(workload, monkeypatch, capsys, seed=2200000011):
    monkeypatch.setattr(cell, "draw", small.small_draw)
    spec = importlib.util.spec_from_file_location("bench_run", RUN)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rc = mod.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", "0", "--trace", "0"], device="cpu")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


CELLS = ["soi_dc.flux", "soi_dc.probe", "au_grating.oblique",
         "au_grating.normal"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload, monkeypatch, capsys):
    out = run_cell(workload, monkeypatch, capsys)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_control_bf16_is_not_correct(workload, monkeypatch, capsys):
    monkeypatch.setenv("TIDY3D_TPU_PRECISION", "bf16")
    out = run_cell(workload, monkeypatch, capsys)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_state_left_unchanged_is_not_correct(workload, monkeypatch, capsys):
    from tidy3d_tpu_torch.solver import fdtd

    monkeypatch.setattr(fdtd.FDTDRunner, "run_steps",
                        lambda self, start, num, state: state)
    out = run_cell(workload, monkeypatch, capsys)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_answer_altered_is_not_correct(workload, monkeypatch, capsys):
    """One frequency of one flux spectrum changed by 1 % where the monitor
    data is made."""
    web_run = importlib.import_module("tidy3d_tpu_torch.web.run")
    real = web_run._make_flux_data

    def altered(plan, raw, idxs, monitor):
        data = real(plan, raw, idxs, monitor)
        vals = np.array(data.flux.values)
        vals[len(vals) // 2] *= 1.01
        return data.copy(update=dict(flux=type(data.flux)(
            vals, coords=data.flux.coords)))

    monkeypatch.setattr(web_run, "_make_flux_data", altered)
    out = run_cell(workload, monkeypatch, capsys)
    assert not out["correct"], out["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_on_the_card(workload, cuda_device, monkeypatch, capsys):
    """The same small run through the port's kernels on the card."""
    monkeypatch.setattr(cell, "draw", small.small_draw)
    spec = importlib.util.spec_from_file_location("bench_run", RUN)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--workload", workload, "--seed", "2200000013",
                     "--seconds", "0", "--trace", "1"],
                    device=cuda_device) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
