"""Basic Lumerical FDTD script (.lsf) -> tidy3d_tpu Python translator.

The reference CLI's ``convert`` command is deprecated and points users at
an external community tool (reference: tidy3d web/cli/app.py:120-129,
hirako22/Lumerical-to-Tidy3D-Converter). Here a working translator for
the common command subset ships in-tree: geometry primitives, FDTD
region, sources, and monitors created via the ``add*`` + ``set`` pattern
are emitted as an executable Python script building a
:class:`tidy3d_tpu.Simulation`.

Covered commands: ``addfdtd``, ``addrect``, ``addcircle``, ``addsphere``,
``addpoly``, ``adddipole``, ``addplane``, ``addgaussian``, ``addmode``,
``addpower``, ``addprofile``, ``addindex``, ``set("prop", value)``,
``select``, ``setnamed``. Unknown commands produce warnings, not errors
— the output script is a starting point, exactly like the external tool.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

from ..log import log

UM = 1e-6  # .lsf lengths are SI metres; tidy3d units are microns


class _Obj:
    def __init__(self, kind: str):
        self.kind = kind
        self.props: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return str(self.props.get("name", self.kind))


_NUM = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"


def _parse_value(tok: str) -> Any:
    tok = tok.strip().rstrip(";")
    if tok.startswith('"') and tok.endswith('"'):
        return tok[1:-1]
    # numeric expression with optional suffix constants
    expr = tok.replace("um", "e-6").replace("nm", "e-9")
    try:
        return float(eval(expr, {"__builtins__": {}}, {"pi": 3.141592653589793}))
    except Exception:  # noqa: BLE001 — keep raw token
        return tok


def parse_lsf(text: str) -> List[_Obj]:
    """Parse an .lsf script into a list of objects with properties."""
    objs: List[_Obj] = []
    current: Optional[_Obj] = None
    known_adds = {
        "addfdtd", "addrect", "addcircle", "addsphere", "addpoly",
        "adddipole", "addplane", "addgaussian", "addmode", "addpower",
        "addprofile", "addindex", "addmesh",
    }
    for raw_line in text.splitlines():
        line = raw_line.split("#")[0].strip()
        if not line:
            continue
        for stmt in line.split(";"):
            stmt = stmt.strip()
            if not stmt:
                continue
            m = re.match(r"^(\w+)\s*(?:\((.*)\))?$", stmt)
            if not m:
                log.warning(f"lsf convert: cannot parse '{stmt}' — skipped.",
                            log_once=True)
                continue
            cmd, args = m.group(1), m.group(2)
            if cmd in known_adds:
                current = _Obj(cmd)
                objs.append(current)
            elif cmd == "set" and args:
                if current is None:
                    continue
                parts = _split_args(args)
                if len(parts) == 2:
                    key = _parse_value(parts[0])
                    current.props[str(key)] = _parse_value(parts[1])
            elif cmd == "select" and args:
                name = _parse_value(args)
                for o in objs:
                    if o.name == name:
                        current = o
            elif cmd == "setnamed" and args:
                parts = _split_args(args)
                if len(parts) == 3:
                    name = str(_parse_value(parts[0]))
                    for o in objs:
                        if o.name == name:
                            o.props[str(_parse_value(parts[1]))] = \
                                _parse_value(parts[2])
            elif cmd in ("save", "run", "newproject", "clear", "redrawoff",
                         "redrawon", "deleteall", "switchtolayout"):
                continue
            else:
                log.warning(f"lsf convert: unsupported command '{cmd}' — "
                            "skipped.", log_once=True)
    return objs


def _split_args(args: str) -> List[str]:
    out, buf, depth, in_str = [], "", 0, False
    for ch in args:
        if ch == '"':
            in_str = not in_str
        if ch == "," and depth == 0 and not in_str:
            out.append(buf)
            buf = ""
            continue
        if ch in "([" and not in_str:
            depth += 1
        if ch in ")]" and not in_str:
            depth -= 1
        buf += ch
    if buf.strip():
        out.append(buf)
    return out


def _center_size(o: _Obj) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    def get(key, default=0.0):
        v = o.props.get(key, default)
        return float(v) if isinstance(v, (int, float)) else default

    center = []
    size = []
    for ax in "xyz":
        if f"{ax} min" in o.props or f"{ax} max" in o.props:
            lo = get(f"{ax} min")
            hi = get(f"{ax} max")
            center.append((lo + hi) / 2 / UM)
            size.append((hi - lo) / UM)
        else:
            center.append(get(ax) / UM)
            size.append(get(f"{ax} span") / UM)
    return tuple(center), tuple(size)


def _medium_expr(o: _Obj) -> str:
    if "index" in o.props and isinstance(o.props["index"], (int, float)):
        n = float(o.props["index"])
        return f"td.Medium(permittivity={n * n:.9g})"
    mat = o.props.get("material")
    if isinstance(mat, str) and mat:
        token = re.sub(r"[^A-Za-z0-9]", "", mat.split("(")[0])
        return (f"material_library[{token!r}][list(material_library"
                f"[{token!r}].variants)[0]].medium  # from '{mat}'")
    return "td.Medium(permittivity=1.0)"


def _freq_props(o: _Obj) -> Tuple[float, float]:
    """(freq0, fwidth) in Hz from wavelength start/stop props (metres)."""
    c0 = 299792458.0
    lam1 = o.props.get("wavelength start", 1.55e-6)
    lam2 = o.props.get("wavelength stop", lam1)
    f1, f2 = c0 / float(lam2), c0 / float(lam1)
    f0 = 0.5 * (f1 + f2)
    fw = max(abs(f2 - f1) / 2, f0 / 10)
    return f0, fw


def convert_lsf_to_python(text: str) -> str:
    """Translate an .lsf script into a tidy3d_tpu Python script."""
    objs = parse_lsf(text)
    lines = [
        '"""Auto-generated by tidy3d-tpu convert from a Lumerical .lsf '
        'script."""',
        "",
        "import numpy as np",
        "",
        "import tidy3d_tpu_torch as td",
        "from tidy3d_tpu_torch import web",
        "from tidy3d_tpu_torch.material_library import material_library",
        "",
        "structures = []",
        "sources = []",
        "monitors = []",
        "",
    ]
    fdtd: Optional[_Obj] = None
    freq_default = (299792458.0 / 1.55e-6, 299792458.0 / 1.55e-6 / 10)
    for o in objs:
        c, s = _center_size(o)
        if o.kind == "addfdtd":
            fdtd = o
        elif o.kind == "addrect":
            lines += [
                f"structures.append(td.Structure(  # '{o.name}'",
                f"    geometry=td.Box(center={c}, size={s}),",
                f"    medium={_medium_expr(o)}))",
            ]
        elif o.kind == "addsphere":
            r = float(o.props.get("radius", 0.0)) / UM
            lines += [
                f"structures.append(td.Structure(  # '{o.name}'",
                f"    geometry=td.Sphere(center={c}, radius={r}),",
                f"    medium={_medium_expr(o)}))",
            ]
        elif o.kind == "addcircle":
            r = float(o.props.get("radius", 0.0)) / UM
            length = s[2] or float(o.props.get("z span", 0.0)) / UM
            lines += [
                f"structures.append(td.Structure(  # '{o.name}'",
                f"    geometry=td.Cylinder(center={c}, radius={r}, "
                f"length={length}, axis=2),",
                f"    medium={_medium_expr(o)}))",
            ]
        elif o.kind == "addpoly":
            verts = o.props.get("vertices", [])
            zlo = c[2] - s[2] / 2
            zhi = c[2] + s[2] / 2
            lines += [
                f"structures.append(td.Structure(  # '{o.name}'",
                f"    geometry=td.PolySlab(vertices={verts}, "
                f"slab_bounds=({zlo}, {zhi}), axis=2),",
                f"    medium={_medium_expr(o)}))",
            ]
        elif o.kind == "adddipole":
            f0, fw = _freq_props(o)
            freq_default = (f0, fw)
            kind = str(o.props.get("dipole type", "electric dipole"))
            pol = "Ez" if "electric" in kind.lower() else "Hz"
            lines += [
                f"sources.append(td.PointDipole(  # '{o.name}'",
                f"    center={c}, polarization={pol!r},",
                f"    source_time=td.GaussianPulse(freq0={f0:.6g}, "
                f"fwidth={fw:.6g})))",
            ]
        elif o.kind in ("addplane", "addgaussian", "addmode"):
            f0, fw = _freq_props(o)
            freq_default = (f0, fw)
            direction = "+" if "-" not in str(
                o.props.get("direction", "+")) else "-"
            inj = str(o.props.get("injection axis", "z"))[0]
            size_expr = "(" + ", ".join(
                "0.0" if ax == inj else "td.inf" for ax in "xyz") + ")"
            common = (f"    center={c}, size={size_expr}, "
                      f"direction={direction!r},\n"
                      f"    source_time=td.GaussianPulse(freq0={f0:.6g}, "
                      f"fwidth={fw:.6g})")
            if o.kind == "addplane":
                lines += [f"sources.append(td.PlaneWave(  # '{o.name}'",
                          common + "))"]
            elif o.kind == "addgaussian":
                w = float(o.props.get("waist radius w0", 1e-6)) / UM
                lines += [f"sources.append(td.GaussianBeam(  # '{o.name}'",
                          common + f", waist_radius={w}))"]
            else:
                lines += [f"sources.append(td.ModeSource(  # '{o.name}'",
                          common + ", mode_spec=td.ModeSpec(num_modes=1)))"]
        elif o.kind in ("addpower", "addprofile", "addindex"):
            f0, _ = _freq_props(o)
            mon_cls = {"addpower": "td.FluxMonitor",
                       "addprofile": "td.FieldMonitor",
                       "addindex": "td.PermittivityMonitor"}[o.kind]
            extra = ""
            if o.kind == "addpower" and 0.0 in s:
                extra = ", normal_dir='+'"
            lines += [
                f"monitors.append({mon_cls}(  # '{o.name}'",
                f"    center={c}, size={s}, freqs=[{f0:.6g}],",
                f"    name={o.name!r}{extra}))",
            ]
        elif o.kind == "addmesh":
            log.warning("lsf convert: mesh override region dropped "
                        "(use GridSpec.auto override_structures).",
                        log_once=True)
    if fdtd is not None:
        c, s = _center_size(fdtd)
        run_time = float(fdtd.props.get("simulation time", 1e-12))
        dims = str(fdtd.props.get("dimension", "3D"))
        if "2" in dims:
            s = (s[0], s[1], 0.0)
    else:
        c, s, run_time = (0, 0, 0), (5.0, 5.0, 5.0), 1e-12
        log.warning("lsf convert: no addfdtd region found; emitting a "
                    "default 5 um cube domain.", log_once=True)
    f0, _ = freq_default
    lines += [
        "",
        "sim = td.Simulation(",
        f"    center={c}, size={s}, run_time={run_time:.6g},",
        "    structures=structures, sources=sources, monitors=monitors,",
        "    boundary_spec=td.BoundarySpec.all_sides(td.PML()),",
        f"    grid_spec=td.GridSpec.auto(min_steps_per_wvl=15, "
        f"wavelength={299792458.0 / f0 / UM:.6g}),",
        ")",
        "",
        'data = web.run(sim, task_name="converted_lsf")',
        "",
    ]
    return "\n".join(lines)


def convert_file(lsf_path: str, out_path: str) -> None:
    with open(lsf_path, "r", encoding="utf-8") as f:
        text = f.read()
    script = convert_lsf_to_python(text)
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(script)
