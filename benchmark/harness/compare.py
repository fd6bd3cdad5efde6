"""The numbers that decide ``correct``: each solve's monitor data against
the plain reference's, one number per kind of monitor, each held to the
limit its configuration states (``limits`` in the configuration's file).

* ``flux_gap``: the largest gap between a flux spectrum and the
  reference's, over every flux monitor and frequency, relative to the
  largest reference flux;
* ``field_gap``: the gap of the field monitors' DFT fields in the 2-norm
  over every component, relative to the reference's norm;
* ``probe_gap``: the largest gap of a time monitor's samples, relative to
  the reference's largest sample.
"""

from __future__ import annotations

import numpy as np


def gaps(prog: dict, ref: dict, pb) -> dict:
    kinds = {mon[1]: mon[0] for mon in pb.monitors}
    flux = [n for n, k in kinds.items() if k == "flux"]
    field = [n for n, k in kinds.items() if k == "field"]
    time = [n for n, k in kinds.items() if k == "time"]
    out = {}
    if flux:
        scale = max(np.max(np.abs(ref[n])) for n in flux)
        out["flux_gap"] = max(float(np.max(np.abs(prog[n] - ref[n])))
                              for n in flux) / scale
    if field:
        num = sum(np.linalg.norm(prog[n][c] - ref[n][c]) ** 2
                  for n in field for c in ref[n])
        den = sum(np.linalg.norm(ref[n][c]) ** 2 for n in field for c in ref[n])
        out["field_gap"] = float(np.sqrt(num / den))
    if time:
        scale = max(np.max(np.abs(ref[n][c])) for n in time for c in ref[n])
        out["probe_gap"] = max(float(np.max(np.abs(prog[n][c] - ref[n][c])))
                               for n in time for c in ref[n]) / scale
    return {k: float(v) for k, v in out.items()}


def worst(per_solve: list) -> dict:
    """The largest of each number over the solves."""
    keys = per_solve[0].keys() if per_solve else ()
    return {k: max(g[k] for g in per_solve) for k in keys}
