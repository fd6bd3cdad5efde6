"""Reduces a ``torch.profiler`` trace (device activity only) of whole
solves to what the per-layer metrics read: the device's activity
intervals, the kernels by name, and the idle gaps between device
activity, labelled by the harness span (``program.Spans``, wall-clock ns,
the profiler's time base) the host was in."""

from __future__ import annotations

from collections import defaultdict


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


class Trace:
    """The device events of one profiled sub-window, in ns of the wall
    clock. ``spans``: the harness's ``(name, start, end)``; ``window``:
    the ``window`` span, which holds whole solves."""

    def __init__(self, prof, spans):
        from torch.autograd import DeviceType

        self.kernels = []          # (name, start, end)
        self.device = []           # every device activity: (start, end)
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            name, s = e.name(), e.start_ns()
            end = s + e.duration_ns()
            self.device.append((s, end))
            if not name.startswith(("Memcpy", "Memset")):
                self.kernels.append((name, s, end))
        self.spans = list(spans)
        self.window = [(s, e) for n, s, e in self.spans if n == "window"][-1]

    def alignment(self) -> str:
        """Where the device events lie against the window, for the log."""
        lo, hi = self.window
        if not self.device:
            return "no device events"
        first = min(s for s, _ in self.device)
        last = max(e for _, e in self.device)
        return (f"{len(self.device)} device events, first at "
                f"{(first - lo) * 1e-6:+.3f} ms, last at "
                f"{(last - hi) * 1e-6:+.3f} ms of the window's ends")

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_s(self) -> float:
        lo, hi = self.window
        return sum(e - s for s, e in _union(_clip(self.device, lo, hi))) \
            * 1e-9

    def kernel_names(self, *needles):
        """The distinct kernel names that contain one of ``needles``."""
        return {n for n, _, _ in self.kernels
                if any(k in n for k in needles)}

    def launches(self, names) -> int:
        lo, hi = self.window
        return sum(1 for n, s, e in self.kernels
                   if n in names and e > lo and s < hi)

    def kernel_s(self, names) -> float:
        """Seconds in which a kernel of ``names`` ran (the union of their
        intervals) inside the window."""
        lo, hi = self.window
        iv = [(s, e) for n, s, e in self.kernels if n in names]
        return sum(e - s for s, e in _union(_clip(iv, lo, hi))) * 1e-9

    def kernel_sum_s(self, names=None, exclude=()) -> float:
        """Summed device seconds of the kernels of ``names`` (every kernel
        when None), leaving out those of ``exclude``."""
        lo, hi = self.window
        return sum(min(e, hi) - max(s, lo) for n, s, e in self.kernels
                   if (names is None or n in names) and n not in exclude
                   and e > lo and s < hi) * 1e-9

    def top_ops(self, n=10):
        lo, hi = self.window
        tot = defaultdict(int)
        for name, s, e in self.kernels:
            if e > lo and s < hi:
                tot[name] += min(e, hi) - max(s, lo)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], t * 1e-9] for name, t in top]

    def idle_gaps(self, n=10):
        """The ``n`` longest idle gaps of the device inside the window,
        each named by the innermost harness span the host was in at the
        gap's middle."""
        lo, hi = self.window
        busy = _union(_clip(self.device, lo, hi))
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        inner = [sp for sp in self.spans if sp[0] != "window"]
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = (s + e) / 2
            host = [sp for sp in inner if sp[1] <= mid <= sp[2]]
            label = min(host, key=lambda sp: sp[2] - sp[1])[0] if host \
                else "between"
            out.append([label, (e - s) * 1e-9])
        return out
