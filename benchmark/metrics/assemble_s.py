"""assemble_s: host seconds of ``web.run.assemble_sim_data`` per solve
(the monitor data builders), the mean over the window's solves, by the host
clock around the call and the synchronize after it. Moves
gcell_steps_per_s."""


def read(ctx):
    vals = ctx.get("assemble_s") or []
    return sum(vals) / len(vals) if vals else None
