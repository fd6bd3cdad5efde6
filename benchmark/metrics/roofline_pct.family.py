"""roofline_pct.family: the family kernel (``csrc/step.cu``) against its
roofline. A call updates one family (E or H) of every copy: it reads the
family's fields and the other family's, its coefficients and CPML slabs
(and, for E, every pole current), and writes the family and its slabs. A
step makes one call of each family. The share is the calls' least time
over the seconds in which the kernel ran. Moves gcell_steps_per_s."""

from benchmark.harness import work

F = work.F32


def _calls(w):
    c, n, psi = w["copies"], w["cells"], w["psi_cells"]
    q = work.pole_values(w)
    e = (c * n * 9 * F + work.coef_bytes(w) + c * psi * 2 * 2 * F
         + c * q * 2 * F,
         c * (3 * work.OPS_YEE_COMP * n + 2 * work.OPS_PSI * psi
              + work.OPS_POLE_TERM * q))
    h = (c * n * 9 * F + c * psi * 2 * 2 * F,
         c * (3 * work.OPS_YEE_COMP * n + 2 * work.OPS_PSI * psi))
    return e, h


def read(ctx):
    kern = ctx.get("kernels", {}).get("family")
    if not kern or not kern["ok"] or not kern["calls"] \
            or ctx.get("peaks") is None:
        return None
    e, h = _calls(ctx["work"])
    per_pair = work.least_seconds(*e, ctx["peaks"]) \
        + work.least_seconds(*h, ctx["peaks"])
    return 100.0 * (kern["calls"] / 2) * per_pair / kern["seconds"]
