"""Readings that explain two of ``chip_smoke.py``'s bars, each taken from
the port and, where it fits on the CPU, from the JAX package.

``smatrix``: the straight strip of the S-matrix phase (phase 37) with mode
monitors along the guide. The modal modeler puts its source two cells
behind the input port and divides by that port's own reading, so |S21| is
|a+| at the output port over |a+| just past the source. Printed: |S21|,
|S12|, |S11| and, for the left port's run, |a+| and |a-| along the guide
over |a+| at the right port. On the CPU both packages run the guide cut to
dl = 0.04 um in a 3.2 um box; on a card the port runs the phase's own case
(384^3, dl = 0.02 um)::

    python -m tests.reference_readings smatrix                  # CPU, both
    python -m tests.reference_readings smatrix --packages port --device cuda

``eme``: the taper of the EME phase (phase 36) at dl = 0.05 um and one
frequency through the port's ``run_eme`` on the CPU, keeping 4 or more
modes a cell: |S21|^2 of the fundamental and each input mode's
|S11|^2 + |S21|^2 summed over the kept outputs::

    python -m tests.reference_readings eme --modes 4 8
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

import tests.torch_cases  # noqa: F401  (an empty h5py where it is missing)

PROFILE_X = (-2.4, -2.2, -2.0, -1.5, -1.0, 0.0, 1.0, 2.0, 2.4)


def straight_modeler(pkg, smatrix, dl: float, side: float, full: bool):
    """The two-port modeler of the straight Si strip (eps 12.1, 0.5 x 0.22
    um, in eps 2.085) at 1.55 um with ports on 2 x 2 um planes at x = -2.5
    and 2.5 um and a mode monitor at each of ``PROFILE_X``; ``full``: the
    base of ``chip_smoke.smatrix_case`` (384^3 at dl = 0.02 um), else a 6.4
    x ``side`` x ``side`` um box at ``dl``."""
    freq0 = pkg.C_0 / 1.55
    spec = pkg.ModeSpec(num_modes=1)
    mons = [pkg.ModeMonitor(center=(x, 0, 0), size=(0, 2.0, 2.0),
                            freqs=[freq0], mode_spec=spec, name=f"m{i}")
            for i, x in enumerate(PROFILE_X)]
    if full:
        import chip_smoke

        sim = chip_smoke.smatrix_case(pkg).simulation
    else:
        sim = pkg.Simulation(
            center=(0, 0, 0), size=(6.4, side, side), run_time=4e-13,
            medium=pkg.Medium(permittivity=2.085),
            structures=[pkg.Structure(
                geometry=pkg.Box(center=(0, 0, 0),
                                 size=(pkg.inf, 0.5, 0.22)),
                medium=pkg.Medium(permittivity=12.1))],
            boundary_spec=pkg.BoundarySpec.all_sides(pkg.PML()),
            grid_spec=pkg.GridSpec.uniform(dl=dl))
    sim = sim.copy(update=dict(monitors=mons))
    ports = [smatrix.Port(center=(-2.5, 0, 0), size=(0, 2.0, 2.0),
                          direction="+", mode_spec=spec, name="left"),
             smatrix.Port(center=(2.5, 0, 0), size=(0, 2.0, 2.0),
                          direction="-", mode_spec=spec, name="right")]
    return smatrix.ComponentModeler(simulation=sim, ports=ports,
                                    freqs=[freq0], verbose=False)


def _amp(data, name: str, direction: str) -> float:
    return abs(complex(np.asarray(
        data[name].amps.sel(direction=direction).values).ravel()[0]))


def report(name: str, modeler, batch_data) -> np.ndarray:
    smat = modeler._construct_smatrix(batch_data)

    def s(port_in, port_out):
        return abs(complex(smat.sel(
            port_in=port_in, port_out=port_out, mode_index_in=0,
            mode_index_out=0).values.ravel()[0]))

    run = batch_data["smatrix_left_0"]
    a_in = _amp(run, "smatrix_mnt_left", "+")
    a_out = _amp(run, "smatrix_mnt_right", "+")
    print(f"{name}: |S21| {s('left', 'right'):.5f}, |S12| "
          f"{s('right', 'left'):.5f}, |S11| {s('left', 'left'):.4f}; the "
          f"left port's run: |a+| at the left port {a_in / a_out:.4f} of "
          f"its value at the right port")
    print(f"  x (um)          {list(PROFILE_X)}")
    for direction in "+-":
        print(f"  |a{direction}| / |a+(2.5)| " + str([
            round(_amp(run, f"m{i}", direction) / a_out, 4)
            for i in range(len(PROFILE_X))]))
    sys.stdout.flush()
    return smat.values


def smatrix_readings(args) -> None:
    import tidy3d_tpu_torch as td
    from tidy3d_tpu_torch.plugins import smatrix

    full = args.device != "cpu"
    port = straight_modeler(td, smatrix, args.dl, args.side, full)
    print(f"grid {port.simulation.grid.num_cells} cells, device "
          f"{args.device}")
    values = {}
    if args.packages in ("both", "reference"):
        from tidy3d_tpu.plugins.smatrix import ComponentModeler

        ref = ComponentModeler.parse_raw(port.json())
        t0 = time.perf_counter()
        data = ref.batch_data
        print(f"reference runs {time.perf_counter() - t0:.1f} s")
        values["reference"] = report("reference", ref, data)
    if args.packages in ("both", "port"):
        t0 = time.perf_counter()
        data = port.make_batch(args.device).run()
        print(f"port runs {time.perf_counter() - t0:.1f} s")
        values["port"] = report("port", port, data)
    if len(values) == 2:
        print("port against reference: S-matrix max abs diff "
              f"{np.max(np.abs(values['port'] - values['reference'])):.2e}")


def eme_readings(args) -> None:
    import tidy3d_tpu_torch as td
    from tidy3d_tpu_torch.solver.eme import run_eme

    import chip_smoke

    for num_modes in args.modes:
        sim = chip_smoke.eme_taper_case(td)
        spec = sim.eme_grid_spec.copy(update=dict(
            mode_spec=td.EMEModeSpec(num_modes=num_modes)))
        sim = sim.copy(update=dict(
            freqs=[td.C_0 / 1.55], eme_grid_spec=spec,
            grid_spec=td.GridSpec.uniform(dl=args.dl)))
        t0 = time.perf_counter()
        data = run_eme(sim, device="cpu")
        # (f, sweep_index, mode_index_out, mode_index_in)
        s11 = np.asarray(data.smatrix.S11.values)[0, 0]
        s21 = np.asarray(data.smatrix.S21.values)[0, 0]
        power = (np.abs(s11) ** 2 + np.abs(s21) ** 2).sum(axis=0)
        print(f"{num_modes} modes a cell ({time.perf_counter() - t0:.0f} s):"
              f" |S21|^2 of the fundamental {abs(s21[0, 0]) ** 2:.4f}; "
              f"|S11|^2 + |S21|^2 per input mode "
              f"{np.round(power, 4).tolist()}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="what", required=True)
    sm = sub.add_parser("smatrix")
    sm.add_argument("--dl", type=float, default=0.04)
    sm.add_argument("--side", type=float, default=3.2)
    sm.add_argument("--device", default="cpu")
    sm.add_argument("--packages", default="both",
                    choices=("both", "reference", "port"))
    em = sub.add_parser("eme")
    em.add_argument("--modes", type=int, nargs="+", default=[4, 8])
    em.add_argument("--dl", type=float, default=0.05)
    args = parser.parse_args(argv)
    if args.what == "smatrix":
        smatrix_readings(args)
    else:
        eme_readings(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
