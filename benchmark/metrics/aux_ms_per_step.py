"""aux_ms_per_step: device milliseconds a step of every kernel other than
the tier's main kernels (the sources, the running DFTs, the time
monitors, copies), summed over the traced solves and divided by their
steps. Not measured where the profiler dropped launches. Moves
gcell_steps_per_s."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("launches_ok") or not ctx.get("steps"):
        return None
    main = set().union(*(k["names"] for k in ctx["kernels"].values()))
    return 1e3 * tr.kernel_sum_s(exclude=main) / ctx["steps"]
