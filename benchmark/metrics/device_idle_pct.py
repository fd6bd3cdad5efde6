"""device_idle_pct: the share of the traced solves' wall time in which no
operation ran on the card (the union of the profiler's device intervals
over the ``bench.window`` span). Not measured where the profiler dropped
launches. Moves gcell_steps_per_s."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("launches_ok") or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
