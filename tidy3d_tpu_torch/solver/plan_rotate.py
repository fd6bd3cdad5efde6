"""Cyclic axis rotation of a lowered SimulationPlan.

Purpose: the temporal-blocked Pallas kernel's spatial decomposition rides
a ring halo exchange along the LEADING grid axis only (pallas_kstep
shard mode). Rather than triplicating the halo machinery per axis, a
single-axis y- or z- decomposition is mapped onto that fast path by
cyclically rotating the whole lowered problem so the decomposed axis
becomes axis 0. A cyclic permutation preserves orientation, so the Yee
curl structure is invariant under the matching component relabeling:
with new axis i = old axis p[i] (p a cyclic shift), newE_i = oldE_{p[i]}
satisfies the same update equations with all per-axis tables permuted
the same way. Monitor outputs are rotated back before leaving the
runner, so everything outside FDTDRunner sees original coordinates.

This generalizes every per-axis feature (CPML, Bloch wrap, sources,
coefficient broadcasting, pole masks) for free — the reference's
server-side decomposition is arbitrary-axis (SURVEY §2.2 P1); here any
single decomposed axis rides the fast kernel, and only mixed 2D/3D
layouts fall back to the GSPMD path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

E_COMPS = ("Ex", "Ey", "Ez")
H_COMPS = ("Hx", "Hy", "Hz")


def perm_for_rot(r: int) -> Tuple[int, int, int]:
    """new axis i holds old axis p[i]; r=1 puts old y first, r=2 old z."""
    return (r % 3, (r + 1) % 3, (r + 2) % 3)


def inv_perm(p) -> Tuple[int, int, int]:
    q = [0, 0, 0]
    for i, ax in enumerate(p):
        q[ax] = i
    return tuple(q)


def _t3(arr, p):
    """Transpose a 3D spatial array by p (passes scalars/None through)."""
    if arr is None or np.ndim(arr) != 3:
        return arr
    return np.ascontiguousarray(np.transpose(arr, p))


def _relabel(comp: str, p) -> str:
    """Component name in rotated coordinates: newF_i = oldF_{p[i]}."""
    q = inv_perm(p)
    return comp[0] + "xyz"[q["xyz".index(comp[1])]]


def _rot_comp_dict(d: Dict[str, object], p, fn=lambda v, p: v):
    if d is None:
        return None
    return {_relabel(k, p): fn(v, p) for k, v in d.items()}


def rotate_plan(plan, r: int):
    """Rotated shallow copy of a SimulationPlan (r in {1, 2})."""
    from .lowering import SimulationPlan  # noqa: F401  (type context)

    p = perm_for_rot(r)

    def rot_pair(v, p):
        a, b = v
        return (_t3(a, p), _t3(b, p))

    def rot_slices(sl, p):
        return tuple(sl[p[i]] for i in range(3))

    new_sources = []
    for sp in plan.sources:
        new_sources.append(dataclasses.replace(
            sp,
            comp=_relabel(sp.comp, p),
            slices=rot_slices(sp.slices, p),
            profile=_t3(sp.profile, p)))

    new_monitors = []
    for mp in plan.monitors:
        new_monitors.append(dataclasses.replace(
            mp,
            comps=tuple(_relabel(c, p) for c in mp.comps),
            slices={_relabel(c, p): rot_slices(sl, p)
                    for c, sl in mp.slices.items()},
            coords={_relabel(c, p): crd for c, crd in mp.coords.items()}))

    new_poles = []
    for pole in plan.poles:
        new_poles.append(dataclasses.replace(
            pole,
            c_vals=tuple(pole.c_vals[p[i]] for i in range(3)),
            mask_ids=tuple(pole.mask_ids[p[i]] for i in range(3)),
            c_maps=None if pole.c_maps is None else tuple(
                _t3(pole.c_maps[p[i]], p) for i in range(3))))

    new_nl = None
    if plan.nonlinear is not None:
        new_nl = dict(plan.nonlinear)
        for key in ("chi3", "ktpa"):
            if key in new_nl:
                new_nl[key] = _rot_comp_dict(new_nl[key], p, _t3)

    new_mod = None
    if plan.modulation:
        new_mod = []
        for entry in plan.modulation:
            e = dict(entry)
            for key in ("eps_maps", "sigma_maps"):
                if e.get(key):
                    e[key] = _rot_comp_dict(
                        e[key], p,
                        lambda v, p: (_t3(v[0], p), _t3(v[1], p)))
            new_mod.append(e)

    return dataclasses.replace(
        plan,
        shape=tuple(plan.shape[p[i]] for i in range(3)),
        coeffs_E=_rot_comp_dict(plan.coeffs_E, p, rot_pair),
        coeffs_H=_rot_comp_dict(plan.coeffs_H, p, rot_pair),
        inv_primal=tuple(plan.inv_primal[p[i]] for i in range(3)),
        inv_dual=tuple(plan.inv_dual[p[i]] for i in range(3)),
        pml_dual=tuple(plan.pml_dual[p[i]] for i in range(3)),
        pml_primal=tuple(plan.pml_primal[p[i]] for i in range(3)),
        boundaries=tuple(plan.boundaries[p[i]] for i in range(3)),
        bloch_phases=tuple(plan.bloch_phases[p[i]] for i in range(3)),
        poles=new_poles,
        pole_masks=[_t3(m, p) for m in plan.pole_masks],
        disp_ee=_rot_comp_dict(plan.disp_ee, p, _t3),
        nonlinear=new_nl,
        modulation=new_mod,
        sources=new_sources,
        monitors=new_monitors,
        # consumed only by assemble_sim_data, which always sees the
        # ORIGINAL plan — drop instead of transposing full-grid arrays
        eps_yee=None,
    )


def unrotate_raw(raw: dict, plan_rot, r: int) -> dict:
    """Rotate the runner's raw monitor output back to original axes.

    ``plan_rot`` is the ROTATED plan (whose monitor plans produced the
    arrays). Field arrays are (sx, sy, sz, nf); time arrays (nt, sx, sy,
    sz); permittivity-kind accs are empty. Comp keys relabel back."""
    p = perm_for_rot(r)
    q = inv_perm(p)

    def unlabel(comp: str) -> str:
        # inverse of _relabel: oldF_{p[i]} = newF_i
        return comp[0] + "xyz"[p["xyz".index(comp[1])]]

    out = {}
    for idx, mon in raw.items():
        mp = plan_rot.monitors[idx]
        new_mon = {}
        for comp, arr in mon.items():
            if np.ndim(arr) == 4:
                axes = (q[0], q[1], q[2], 3) if mp.kind == "field" \
                    else (0, 1 + q[0], 1 + q[1], 1 + q[2])
                arr = np.ascontiguousarray(np.transpose(arr, axes))
            elif np.ndim(arr) == 3:
                arr = np.ascontiguousarray(np.transpose(arr, q))
            new_mon[unlabel(comp)] = arr
        out[idx] = new_mon
    return out
