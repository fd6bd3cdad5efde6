"""The Au/Cr grating (``au_grating.json``): the simulation handed to the
solver under test, and the same simulation as the plain reference's
problem. ``p`` holds the configuration's numbers, the mix's and the values
drawn from the seed."""

from __future__ import annotations

import numpy as np

C_0 = 2.99792458e14


def _poles(fit):
    return [(complex(ar, ai), complex(cr, ci))
            for ar, ai, cr, ci in fit["poles_re_im"]]


def _layout(p):
    """Every position and size of the grating, in um."""
    dl = p["dl_um"]
    period = p["cells_xy"] * dl
    h = round(p["cells_z"] * dl, 9)
    t, cr = p["line_thickness_um"], p["cr_um"]
    f_c = C_0 / p["wavelength_um"]
    lo, hi = p["monitor_freq_span"]
    zm = p["monitor_height"] * h
    return dict(
        size=(period, period, h),
        substrate=((0, 0, -cr - h / 2), (None, None, h)),
        cr=((0, 0, -cr / 2), (None, None, cr)),
        au=((0, 0, t / 2), (period * p["line_fill"], None, t)),
        f0=C_0 / p["source_wavelength_um"],
        freqs=np.linspace(f_c * lo, f_c * hi, p["num_freqs"]).tolist(),
        source=((0, 0, p["source_height"] * h), (None, None, 0.0)),
        reflected=((0, 0, zm), (None, None, 0.0)),
        transmitted=((0, 0, -zm), (None, None, 0.0)),
        theta=np.deg2rad(p["angle_theta_deg"]),
        phi=np.deg2rad(p["angle_phi_deg"]),
    )


def _size(s, inf):
    return tuple(inf if v is None else v for v in s)


def simulation(td, p):
    """The grating as a ``Simulation`` of the package ``td``."""
    L = _layout(p)
    inf = td.inf
    pw = td.PlaneWave(
        center=L["source"][0], size=_size(L["source"][1], inf),
        direction="-", pol_angle=0.0, angle_theta=L["theta"],
        angle_phi=L["phi"],
        source_time=td.GaussianPulse(freq0=L["f0"],
                                     fwidth=L["f0"] * p["fwidth_frac"]))
    if L["theta"] == 0.0:
        bx = by = td.Boundary.periodic()
    else:
        bx, by = (td.Boundary.bloch_from_source(
            source=pw, domain_size=L["size"][a], axis=a) for a in (0, 1))
    media = {k: td.PoleResidue(eps_inf=p[k]["eps_inf"], poles=_poles(p[k]))
             for k in ("cr", "au")}
    return td.Simulation(
        center=(0, 0, 0), size=L["size"], run_time=p["run_time_s"],
        sources=[pw],
        structures=[td.Structure(geometry=td.Box(
            center=L["substrate"][0], size=_size(L["substrate"][1], inf)),
            medium=td.Medium(permittivity=p["eps_substrate"]))] + [
            td.Structure(geometry=td.Box(center=L[k][0],
                                         size=_size(L[k][1], inf)),
                         medium=media[k]) for k in ("cr", "au")],
        monitors=[td.FluxMonitor(center=L[k][0], size=_size(L[k][1], inf),
                                 freqs=L["freqs"], name=k)
                  for k in ("reflected", "transmitted")],
        boundary_spec=td.BoundarySpec(
            x=bx, y=by, z=td.Boundary.pml(num_layers=p["pml_layers"])),
        grid_spec=td.GridSpec.uniform(dl=p["dl_um"]),
        courant=p["courant"], shutoff=p["shutoff"])


def problem(p):
    """The grating as the plain reference's problem."""
    from ..reference import yee

    L = _layout(p)
    inf = yee.INF
    n = p["pml_layers"]
    if L["theta"] == 0.0:
        bloch = (0.0, 0.0, None)
    else:
        # the in-plane wave vector of the source over the period, in units
        # of 2 pi (vacuum above the grating)
        kt = L["f0"] / C_0 * np.sin(L["theta"])
        bloch = (kt * np.cos(L["phi"]) * L["size"][0],
                 kt * np.sin(L["phi"]) * L["size"][1], None)
    return yee.Problem(
        center=(0.0, 0.0, 0.0), size=L["size"], dl=p["dl_um"],
        absorb=((0, 0), (0, 0), (n, n)), bloch=bloch,
        medium=yee.Material(1.0),
        structures=[
            (yee.Box(L["substrate"][0], _size(L["substrate"][1], inf)),
             yee.Material(p["eps_substrate"]))] + [
            (yee.Box(L[k][0], _size(L[k][1], inf)),
             yee.Material(p[k]["eps_inf"], _poles(p[k])))
            for k in ("cr", "au")],
        pulse=yee.Pulse(L["f0"], L["f0"] * p["fwidth_frac"]),
        sources=[("plane", yee.Box(L["source"][0],
                                   _size(L["source"][1], inf)), "-",
                  L["theta"], L["phi"], 0.0)],
        monitors=[("flux", k, yee.Box(L[k][0], _size(L[k][1], inf)),
                   L["freqs"]) for k in ("reflected", "transmitted")],
        run_time=p["run_time_s"], courant=p["courant"])
