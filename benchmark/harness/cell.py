"""A cell of the benchmark as data: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix and the parameters a seed draws."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load(workload: str) -> dict:
    """The cell ``workload``: its manifest entries, configuration, mix and
    the metrics it reports, by name."""
    man = manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(cells: {', '.join(sorted(cells))})")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    mix = json.loads((BENCH / "mixes" / f"{cell['traffic']}.json")
                     .read_text())

    def reported(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return dict(
        cell=cell, config=config, mix=mix, manifest=man,
        module=importlib.import_module(
            f"benchmark.configs.{cell['config']}"),
        end_to_end=[m for m in man["end_to_end"] if reported(m)],
        per_layer=[m for m in man["per_layer"] if reported(m)],
    )


def draw(config: dict, mix: dict, seed: int) -> dict:
    """The parameters of one run: the configuration's numbers, the mix's,
    and each free parameter drawn uniformly from its range by ``seed`` (in
    the order of the names, so that a seed always draws alike)."""
    rng = np.random.default_rng(int(seed) % (1 << 64))
    params = dict(config)
    params.update(mix.get("fixed", {}))
    free = dict(config.get("free", {}))
    free.update(mix.get("free", {}))
    for name in sorted(free):
        lo, hi = free[name]
        params[name] = float(lo + (hi - lo) * rng.random())
    params["drawn"] = {name: params[name] for name in sorted(free)}
    return params
