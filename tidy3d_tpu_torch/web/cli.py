"""Command-line interface.

Behavioral model: the upstream tidy3d web/cli/app.py (tidy3d_cli:39 with
configure/migration/convert commands). Here the solver is local (TPU), so
`configure` stores an optional API key for future remote relays, `run` solves
a simulation file directly, and `bench` reports solver throughput.
Implemented with argparse (no click dependency requirement).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

CONFIG_DIR = os.path.expanduser("~/.tidy3d_tpu")
CONFIG_FILE = os.path.join(CONFIG_DIR, "config")


def configure_fn(apikey: str) -> None:
    """Store the API key in the user config file."""
    os.makedirs(CONFIG_DIR, exist_ok=True)
    with open(CONFIG_FILE, "w", encoding="utf-8") as f:
        f.write(f'apikey = "{apikey}"\n')
    print(f"API key stored at {CONFIG_FILE}.")


def _cmd_configure(args) -> int:
    apikey = args.apikey
    if apikey is None:
        try:
            apikey = input("Enter your api key: ").strip()
        except EOFError:
            print("no api key provided", file=sys.stderr)
            return 1
    configure_fn(apikey)
    return 0


def _cmd_run(args) -> int:
    from .. import Simulation
    from .run import run as web_run

    sim = Simulation.from_file(args.simulation)
    data = web_run(sim, task_name=args.task_name or "cli",
                   verbose=not args.quiet)
    out = args.output or (os.path.splitext(args.simulation)[0] + "_data.hdf5")
    data.to_file(out)
    print(f"results written to {out}")
    return 0


def _cmd_validate(args) -> int:
    from .. import Simulation

    try:
        sim = Simulation.from_file(args.simulation)
    except Exception as exc:  # noqa: BLE001
        print(f"INVALID: {exc}", file=sys.stderr)
        return 1
    print(f"OK: {len(sim.structures)} structures, "
          f"{len(sim.sources)} sources, {len(sim.monitors)} monitors, "
          f"grid {sim.grid.num_cells}")
    return 0


def _cmd_convert(args) -> int:
    if not args.lsf_file or not args.new_file:
        print("usage: tidy3d-tpu convert <script.lsf> <out.py>",
              file=sys.stderr)
        return 2
    from .lsf_converter import convert_file

    convert_file(args.lsf_file, args.new_file)
    print(f"wrote {args.new_file} (review before running — the converter "
          "covers the common .lsf command subset; unknown commands were "
          "skipped with warnings).")
    return 0


def _cmd_version(args) -> int:
    from ..version import __version__

    print(__version__)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tidy3d-tpu", description="tidy3d-tpu command line tool")
    sub = parser.add_subparsers(dest="command")

    p_cfg = sub.add_parser("configure", help="store the API key")
    p_cfg.add_argument("--apikey", default=None)
    p_cfg.set_defaults(fn=_cmd_configure)

    p_run = sub.add_parser("run", help="solve a simulation file locally")
    p_run.add_argument("simulation", help="path to a Simulation .json/.hdf5")
    p_run.add_argument("--output", "-o", default=None)
    p_run.add_argument("--task-name", default=None)
    p_run.add_argument("--quiet", "-q", action="store_true")
    p_run.set_defaults(fn=_cmd_run)

    p_val = sub.add_parser("validate", help="validate a simulation file")
    p_val.add_argument("simulation")
    p_val.set_defaults(fn=_cmd_validate)

    p_conv = sub.add_parser(
        "convert", help="convert a Lumerical .lsf script to python")
    p_conv.add_argument("lsf_file", nargs="?")
    p_conv.add_argument("new_file", nargs="?")
    p_conv.set_defaults(fn=_cmd_convert)

    p_ver = sub.add_parser("version", help="print version")
    p_ver.set_defaults(fn=_cmd_version)

    args = parser.parse_args(argv)
    if not getattr(args, "fn", None):
        parser.print_help()
        return 0
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
