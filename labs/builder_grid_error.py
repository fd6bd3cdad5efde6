"""Lab: the grid errors of the mode-overlap and far-field builders.

    python3 labs/builder_grid_error.py [--device cpu|cuda]

The port's ``web.run`` builds mode amplitudes and far fields exactly as
the JAX package's does (``tidy3d_tpu/web/run.py:322-342``, ``:455-524``,
``components/field_projection.py``): each uses the recorded E and H of a
plane as if they sat on it, though on the Yee grid they lie half a cell
apart along the normal. Two small cases show what that costs, one JSON
line each:

* a Si strip (eps 12.1, 0.5 x 0.22 um) in SiO2 at dl = 0.04 um, a mode
  source of mode 0 and a mode monitor 2 um downstream: the backward
  amplitude over the forward one, the forward power over the plane's flux
  and the power balance ``(|a+|^2 - |a-|^2) / flux``, with a 12-layer PML,
  a 30-layer PML (a reflection from the far wall would change), and with
  the plane moved by half a cell (a grid artifact would change);
* an Ez dipole with a field-projection box of 1.2 um at dl = 0.05 and
  0.025 um: |E_theta| over phi at theta = 90 degrees (max / min) and the
  largest |E_theta(theta) / E_theta(90) / sin(theta) - 1| over theta in
  [30, 150] degrees (a first-order grid error halves with dl).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import tidy3d_tpu_torch as td  # noqa: E402

FREQ0 = td.C_0 / 1.55


def waveguide(layers: int, x_plane: float, device: str) -> dict:
    freqs = np.linspace(FREQ0 * 0.95, FREQ0 * 1.05, 3).tolist()
    plane = dict(center=(x_plane, 0, 0), size=(0, 1.4, 1.4))
    sim = td.Simulation(
        center=(0, 0, 0), size=(3.0, 1.6, 1.6), run_time=2e-13,
        medium=td.Medium(permittivity=2.085),
        structures=[td.Structure(
            geometry=td.Box(center=(0, 0, 0), size=(td.inf, 0.5, 0.22)),
            medium=td.Medium(permittivity=12.1))],
        sources=[td.ModeSource(
            center=(-1.0, 0, 0), size=(0, 1.4, 1.4), direction="+",
            source_time=td.GaussianPulse(freq0=FREQ0, fwidth=FREQ0 / 10),
            mode_spec=td.ModeSpec(num_modes=1), mode_index=0)],
        monitors=[td.FluxMonitor(**plane, freqs=freqs, name="flux"),
                  td.ModeMonitor(**plane, freqs=freqs, name="mode",
                                 mode_spec=td.ModeSpec(num_modes=1))],
        boundary_spec=td.BoundarySpec.all_sides(td.PML(num_layers=layers)),
        grid_spec=td.GridSpec.uniform(dl=0.04))
    t0 = time.perf_counter()
    data = td.web.run(sim, device=device, verbose=False)
    amps = data["mode"].amps
    fwd = np.abs(amps.sel(direction="+", mode_index=0).values)
    bwd = np.abs(amps.sel(direction="-", mode_index=0).values)
    flux = np.asarray(data["flux"].flux.values)
    return {"case": "waveguide", "pml_layers": layers, "x_plane": x_plane,
            "backward_over_forward": (bwd / fwd).tolist(),
            "forward_power_over_flux": (fwd ** 2 / flux).tolist(),
            "balance_over_flux": ((fwd ** 2 - bwd ** 2) / flux).tolist(),
            "seconds": time.perf_counter() - t0}


def far_field(dl: float, device: str) -> dict:
    theta = np.deg2rad(np.arange(30, 151, 10))
    phi = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    n = int(round(2.0 / dl))
    sim = td.Simulation(
        center=(0, 0, 0), size=(n * dl,) * 3, run_time=4e-14,
        sources=[td.PointDipole(
            center=(0, 0, 0), polarization="Ez",
            source_time=td.GaussianPulse(freq0=FREQ0, fwidth=FREQ0 / 8))],
        monitors=[td.FieldProjectionAngleMonitor(
            center=(0, 0, 0), size=(1.2,) * 3, freqs=[FREQ0], name="far",
            theta=theta, phi=phi)],
        boundary_spec=td.BoundarySpec.all_sides(td.PML()),
        grid_spec=td.GridSpec.uniform(dl=dl), shutoff=0.0)
    t0 = time.perf_counter()
    data = td.web.run(sim, device=device, verbose=False)
    e = np.abs(np.asarray(data["far"].Etheta.values))[0, :, :, 0]
    i90 = int(np.argmin(np.abs(theta - np.pi / 2)))
    pattern = e / e[i90][None, :] / np.sin(theta)[:, None]
    return {"case": "far_field", "dl": dl,
            "isotropy_max_over_min": float(e[i90].max() / e[i90].min()),
            "pattern_max_deviation": float(np.max(np.abs(pattern - 1))),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args(argv)
    for layers, x_plane in ((12, 1.0), (30, 1.0), (12, 1.02)):
        print(json.dumps(waveguide(layers, x_plane, args.device)), flush=True)
    for dl in (0.05, 0.025):
        print(json.dumps(far_field(dl, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
