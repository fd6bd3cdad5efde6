"""roofline_pct.fused: the fused kernel (``csrc/fused.cu``) against its
roofline. One call is one whole step (both half-steps, the CPML, the J
sources and the pole update, the pole-table path included), which reads
each field, coefficient, CPML slab and pole current once and writes each
field, slab and current once. The share is the calls' least time over the
seconds in which the kernel ran. Moves gcell_steps_per_s."""

from benchmark.harness import work


def read(ctx):
    kern = ctx.get("kernels", {}).get("fused")
    if not kern or not kern["ok"] or not kern["calls"] \
            or ctx.get("peaks") is None:
        return None
    nbytes, ops = work.whole_step(ctx["work"])
    least = kern["calls"] * work.least_seconds(nbytes, ops, ctx["peaks"])
    return 100.0 * least / kern["seconds"]
