"""roofline_pct.kstep: the k-step kernel (``csrc/kstep.cu``) against its
roofline. One call advances every copy k steps (both half-steps, the CPML,
the sources and the poles) and reads each field, coefficient, CPML slab
and pole current once and writes each field, slab and current once; its
operations are k steps of the Yee update. The share is the calls' least
time over the seconds in which the kernel ran. Moves gcell_steps_per_s."""

from benchmark.harness import work


def read(ctx):
    kern = ctx.get("kernels", {}).get("kstep")
    if not kern or not kern["ok"] or not kern["calls"] \
            or ctx.get("peaks") is None:
        return None
    w, k = ctx["work"], ctx["k"]
    nbytes, ops = work.whole_step(w)
    least = kern["calls"] * work.least_seconds(nbytes, k * ops,
                                               ctx["peaks"])
    return 100.0 * least / kern["seconds"]
