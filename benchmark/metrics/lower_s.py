"""lower_s: host seconds of the port's lowering (``solver.lowering.lower``,
with the mode source's mode solve) in set-up, by the host clock around the
call. Moves setup_s."""


def read(ctx):
    return ctx.get("lower_s")
