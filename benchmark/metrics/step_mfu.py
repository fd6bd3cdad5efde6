"""step_mfu: the whole solve's share of the card's float32 peak: the
operations of every step of every copy (``work.whole_step``, counted from
the simulation's shapes, the simulation's own steps) over the wall time of
the traced solve (runner, memory gate, time loop, monitor data), against
the peak in ``peaks.json``. It reads on every tier, so it still bounds the
step where a later change takes a kernel, and its roofline share, off the
path. Moves gcell_steps_per_s."""

from benchmark.harness import work


def read(ctx):
    tr, peaks = ctx.get("trace"), ctx.get("peaks")
    if tr is None or peaks is None or tr.window_s <= 0:
        return None
    _, ops = work.whole_step(ctx["work"])
    return 100.0 * ctx["steps"] * ops / tr.window_s / peaks["f32_ops_per_s"]
