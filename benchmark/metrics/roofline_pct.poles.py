"""roofline_pct.poles: the pole kernel (``csrc/poles.cu``) against its
roofline. A call updates every pole slot of every copy once: on each
dispersive medium's cells it reads E^{n+1} and E^n of the three components
and reads and writes each slot's complex current. The share is the calls'
least time over the seconds in which the kernel ran. Moves
gcell_steps_per_s."""

from benchmark.harness import work

F = work.F32


def read(ctx):
    kern = ctx.get("kernels", {}).get("poles")
    w = ctx.get("work")
    if not kern or not kern["ok"] or not kern["calls"] \
            or ctx.get("peaks") is None or not w["media"]:
        return None
    c = w["copies"]
    nbytes = c * sum(cells * 3 * (2 * F + slots * 2 * 2 * F)
                     for slots, cells in w["media"])
    ops = c * work.OPS_POLE * work.pole_values(w)
    least = kern["calls"] * work.least_seconds(nbytes, ops, ctx["peaks"])
    return 100.0 * least / kern["seconds"]
