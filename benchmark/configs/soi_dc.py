"""The SOI directional coupler (``soi_dc.json``): the simulation handed to
the solver under test, and the same simulation as the plain reference's
problem. ``p`` holds the configuration's numbers, the mix's and the values
drawn from the seed."""

from __future__ import annotations

import numpy as np

C_0 = 2.99792458e14


def _layout(p):
    """Every position and size of the coupler, in um."""
    lx, ly, lz = p["domain_um"]
    w, t = p["strip_um"]
    g = p["gap_um"]
    y1 = g / 2 + w / 2                       # the driven strip, at y > 0
    f_c = C_0 / p["wavelength_um"]
    lo, hi = p["monitor_freq_span"]
    src_x = -lx / 2 + p["source_inset_um"]
    mw, mh = p["mode_plane_um"]
    out_x = lx / 2 - p["monitor_inset_um"]
    pw, ph = p["port_plane_um"]
    return dict(
        size=(lx, ly, lz),
        strips=[((0.0, s * y1, 0.0), (None, w, t)) for s in (1, -1)],
        f0=C_0 / p["source_wavelength_um"],
        freqs=np.linspace(f_c * lo, f_c * hi, p["num_freqs"]).tolist(),
        f_c=f_c,
        mode=((src_x, mw / 2, 0.0), (0.0, mw, mh)),
        through=((out_x, pw / 4, 0.0), (0.0, pw / 2, ph)),
        cross=((out_x, -pw / 4, 0.0), (0.0, pw / 2, ph)),
        plane=((0.0, 0.0, 0.0), (lx, ly, 0.0)),
        probe=((out_x, -y1, 0.0), (0.0, 0.0, 0.0)),
    )


def simulation(td, p):
    """The coupler as a ``Simulation`` of the package ``td``."""
    L = _layout(p)
    inf = td.inf
    mons = [td.FluxMonitor(center=L[k][0], size=L[k][1], freqs=L["freqs"],
                           name=k) for k in ("through", "cross")]
    mons.append(td.FieldMonitor(center=L["plane"][0], size=L["plane"][1],
                                freqs=[L["f_c"]], name="plane",
                                colocate=False))
    if p.get("probe"):
        mons.append(td.FieldTimeMonitor(
            center=L["probe"][0], size=L["probe"][1],
            fields=list(p["probe_fields"]), name="probe"))
    core = td.Medium(permittivity=p["eps_core"])
    return td.Simulation(
        center=(0, 0, 0), size=L["size"], run_time=p["run_time_s"],
        medium=td.Medium(permittivity=p["eps_clad"]),
        structures=[td.Structure(geometry=td.Box(
            center=c, size=(inf,) + s[1:]), medium=core)
            for c, s in L["strips"]],
        sources=[td.ModeSource(
            center=L["mode"][0], size=L["mode"][1], direction="+",
            source_time=td.GaussianPulse(freq0=L["f0"],
                                         fwidth=L["f0"] * p["fwidth_frac"]),
            mode_spec=td.ModeSpec(num_modes=1), mode_index=0)],
        monitors=mons,
        boundary_spec=td.BoundarySpec.all_sides(
            td.PML(num_layers=p["pml_layers"])),
        grid_spec=td.GridSpec.uniform(dl=p["dl_um"]),
        courant=p["courant"], shutoff=p["shutoff"])


def problem(p):
    """The coupler as the plain reference's problem."""
    from ..reference import yee

    L = _layout(p)
    core = yee.Material(p["eps_core"])
    mons = [("flux", k, yee.Box(*L[k]), L["freqs"])
            for k in ("through", "cross")]
    mons.append(("field", "plane", yee.Box(*L["plane"]), [L["f_c"]],
                 yee.E_COMPS + yee.H_COMPS))
    if p.get("probe"):
        mons.append(("time", "probe", yee.Box(*L["probe"]),
                     tuple(p["probe_fields"])))
    n = p["pml_layers"]
    return yee.Problem(
        center=(0.0, 0.0, 0.0), size=L["size"], dl=p["dl_um"],
        absorb=((n, n),) * 3, bloch=(None, None, None),
        medium=yee.Material(p["eps_clad"]),
        structures=[(yee.Box(c, (yee.INF,) + s[1:]), core)
                    for c, s in L["strips"]],
        pulse=yee.Pulse(L["f0"], L["f0"] * p["fwidth_frac"]),
        sources=[("mode", yee.Box(*L["mode"]), "+", 0)],
        monitors=mons, run_time=p["run_time_s"], courant=p["courant"])
