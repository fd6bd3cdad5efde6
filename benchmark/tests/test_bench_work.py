"""The frozen work arithmetic of the roofline readers, against a count by
hand at a tiny size, and the trace reduction on made-up intervals."""

import importlib.util
from pathlib import Path

import pytest

from benchmark.harness import trace, work
from benchmark.reference import yee

METRICS = Path(__file__).resolve().parents[1] / "metrics"
PEAKS = {"bytes_per_s": 1e12, "f32_ops_per_s": 1e13}


def reader(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def tiny(bloch=None, poles=True):
    """4 x 4 x 6 cells: 2 CPML layers below and above in z, periodic x and
    y; one dispersive box of 2 x 4 x 1 cells with two pole slots."""
    metal = yee.Material(1.0, [(0j, 1e17 + 0j), (-1e14 + 0j, 1e15 + 0j),
                               (-2e14 + 0j, 3e15 + 0j)] if poles else [])
    return yee.Problem(
        center=(0, 0, 0), size=(0.4, 0.4, 0.2), dl=0.1,
        absorb=((0, 0), (0, 0), (2, 2)), bloch=(bloch or 0.0, 0.0, None),
        medium=yee.Material(1.0),
        structures=[(yee.Box((-0.1, 0, 0.05), (0.2, 1e10, 0.1)), metal)],
        pulse=yee.Pulse(2e14, 2e13), sources=[], monitors=[],
        run_time=1e-15)


def test_describe_by_hand():
    w = work.describe(tiny())
    assert w["shape"] == (4, 4, 6)
    assert w["cells"] == 96
    # z slabs of 3 planes of 4 x 4 cells, below and above
    assert w["psi_cells"] == 2 * 3 * 16
    assert w["copies"] == 1 and w["lossy"]
    # the box holds the cell centres x in (-0.2, 0), z in (0, 0.1)
    assert w["media"] == [(2, 2 * 4 * 1)]
    assert work.describe(tiny(bloch=0.3))["copies"] == 2
    assert not work.describe(tiny(poles=False))["lossy"]


def test_whole_step_by_hand():
    w = work.describe(tiny())
    nbytes, ops = work.whole_step(w)
    fields = 96 * 12 * 4               # 6 read, 6 written
    coef = 96 * 6 * 4                  # ca and cb of 3 components
    psi = 96 * 4 * 2 * 4               # 4 components' slabs, read + write
    q = 2 * 8 * 3 * 2 * 2 * 4          # slots x cells x comps, re/im, r+w
    assert nbytes == fields + coef + psi + q
    assert ops == 6 * 8 * 96 + 4 * 4 * 96 + 13 * 2 * 8 * 3
    assert work.least_seconds(nbytes, ops, PEAKS) == nbytes / 1e12


@pytest.mark.parametrize("name,kernel,calls", [
    ("roofline_pct.kstep", "kstep", 5), ("roofline_pct.fused", "fused", 10),
    ("roofline_pct.family", "family", 20), ("roofline_pct.poles", "poles",
                                            10)])
def test_roofline_readers(name, kernel, calls):
    w = work.describe(tiny(bloch=0.3))
    ctx = {"work": w, "k": 2, "peaks": PEAKS, "kernels": {
        kernel: {"calls": calls, "ok": True, "seconds": 1e-3,
                 "names": {"x"}}}}
    share = reader(name)(ctx)
    c = 2
    if kernel in ("kstep", "fused"):
        nbytes, ops = work.whole_step(w)
        k = 2 if kernel == "kstep" else 1
        want = calls * max(nbytes / 1e12, k * ops / 1e13)
    elif kernel == "family":
        e = c * 96 * 9 * 4 + 96 * 6 * 4 + c * 96 * 2 * 2 * 4 \
            + c * 48 * 2 * 4
        h = c * 96 * 9 * 4 + c * 96 * 2 * 2 * 4
        want = calls / 2 * (e + h) / 1e12
    else:
        want = calls * c * 8 * 3 * (2 * 4 + 2 * 2 * 2 * 4) / 1e12
    assert share == pytest.approx(100 * want / 1e-3)
    ctx["kernels"][kernel]["ok"] = False
    assert reader(name)(ctx) is None


def test_step_mfu_by_hand():
    w = work.describe(tiny(bloch=0.3))
    tr = _Fake([], [("window", 0, 2_000_000)])
    ctx = {"work": w, "steps": 10, "peaks": PEAKS, "trace": tr}
    ops = 2 * (6 * 8 * 96 + 4 * 4 * 96 + 13 * 2 * 8 * 3)
    assert reader("step_mfu")(ctx) == pytest.approx(
        100 * 10 * ops / 2e-3 / 1e13)
    ctx["trace"] = None
    assert reader("step_mfu")(ctx) is None


class _Fake(trace.Trace):
    def __init__(self, kernels, spans):
        self.kernels = kernels
        self.device = [(s, e) for _, s, e in kernels]
        self.spans = spans
        self.window = [(s, e) for n, s, e in spans if n == "window"][0]


def test_trace_reduction():
    tr = _Fake([("a", 10, 20), ("b", 15, 30), ("a", 50, 60)],
               [("window", 0, 100), ("run", 0, 70), ("assemble", 70, 100)])
    assert tr.busy_s() == pytest.approx(30e-9)
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.kernel_s({"a"}) == pytest.approx(20e-9)
    assert tr.launches({"a"}) == 2
    assert tr.kernel_sum_s(exclude={"a"}) == pytest.approx(15e-9)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["assemble", pytest.approx(40e-9)]
    assert ["run", pytest.approx(20e-9)] in gaps
    assert tr.top_ops()[0][0] == "a"
