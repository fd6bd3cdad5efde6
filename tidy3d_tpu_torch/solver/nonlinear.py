"""The passes between the E update and the pole update: time-modulated
permittivity and conductivity, then the chi3 / Kerr / two-photon-absorption
fixed point (the port of ``tidy3d_tpu/solver/fdtd.py:480-542``, their
constants, and ``:1632-1688``, their arithmetic in ``FDTDRunner._step``).

After the E family and its J sources (``E_lin``, from the old field ``E``),
each modulation entry solves, per component it modulates,

    E' = (E_lin + num E) / (1 + den)

with ``num = Beps1 c_n + Beps2 s_n - S`` and ``den = Beps1 c_{n+1} + Beps2
s_{n+1} + S``, ``S = Bsig1 c_h + Bsig2 s_h`` (``Beps = cb eps0 delta_eps /
dt`` and ``Bsig = cb delta_sigma / 2`` per component and cell, ``c``, ``s``
the entry's cos/sin time tables at steps n, n + 1 and n + 1/2), and then
``num_iters`` fixed-point sweeps give

    E' = E_lin - B (E'^3 - E^3) - K ((E + E') / 2)^3

with ``B = cb eps0 chi3 / dt`` and ``K = cb ktpa`` per component. A map
that is uniform is one float32 scalar (``compact``), as in the reference.
Both copies of a Bloch run take the modulation with the same coefficients;
the JAX package refuses a nonlinear Bloch run, and so does the port.

``post_e_reference`` is the plain version (whole-array PyTorch operations,
out of place, differentiable): the types follow JAX's promotion on the
reference's inputs, so a bfloat16 field stays bfloat16 through the cubes
of the first sweep and everything a float32 coefficient touches is
float32; the result is rounded to the fields' type once (``store``).
``kernels.post_e.post_e`` runs all of it in one launch of
``csrc/post_e.cu`` on a card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import EPSILON_0
from .lowering import E_COMPS

f32 = np.float32


def compact(arr):
    """A float32 array, or its one value (a ``np.float32``) when uniform."""
    arr = np.asarray(arr, f32)
    flat0 = arr.flat[0]
    if np.all(arr == flat0):
        return f32(flat0)
    return arr


def build_post_e_constants(plan, coeffs_E: dict) -> dict:
    """``{"nl": {"B": {comp: v}, "K": {comp: v}}, "nl_num_iters": n}``
    where the plan has nonlinear media, and ``{"mod": [entry, ...]}`` where
    it has modulated ones: each entry's ``eps_c``/``eps_s`` tables
    (``num_steps + 1`` long, for the n + 1 sample) and ``Beps`` maps, and
    its ``sig_c``/``sig_s`` tables (at n + 1/2) and ``Bsig`` maps, as
    ``FDTDRunner._build_constants`` builds them. ``coeffs_E[comp] = (ca,
    cb)`` on the host."""
    out = {}
    if plan.nonlinear is not None:
        nl = {"B": {}, "K": {}}
        for comp in E_COMPS:
            _, cb = coeffs_E[comp]
            chi3 = plan.nonlinear["chi3"].get(comp)
            ktpa = plan.nonlinear["ktpa"].get(comp)
            if chi3 is not None:
                nl["B"][comp] = compact(cb * EPSILON_0 * chi3 / plan.dt)
            if ktpa is not None:
                nl["K"][comp] = compact(cb * ktpa)
        out["nl"] = nl
        out["nl_num_iters"] = int(plan.nonlinear["num_iters"])
    if plan.modulation:
        entries = []
        tmesh = plan.tmesh
        for entry in plan.modulation:
            ce = {}
            if entry.get("eps_maps"):
                w = 2 * np.pi * entry["eps_freq"]
                ph, amp = entry["eps_phase"], entry["eps_amp"]
                t_pad = np.concatenate([tmesh, tmesh[-1:] + plan.dt])
                ce["eps_c"] = (amp * np.cos(w * t_pad + ph)).astype(f32)
                ce["eps_s"] = (-amp * np.sin(w * t_pad + ph)).astype(f32)
                ce["Beps"] = {}
                for comp, (m1, m2) in entry["eps_maps"].items():
                    _, cb = coeffs_E[comp]
                    scale = cb * EPSILON_0 / plan.dt
                    ce["Beps"][comp] = (compact(scale * m1),
                                        compact(scale * m2))
            if entry.get("sigma_maps"):
                w = 2 * np.pi * entry["sigma_freq"]
                ph, amp = entry["sigma_phase"], entry["sigma_amp"]
                t_half = tmesh + plan.dt / 2
                ce["sig_c"] = (amp * np.cos(w * t_half + ph)).astype(f32)
                ce["sig_s"] = (-amp * np.sin(w * t_half + ph)).astype(f32)
                ce["Bsig"] = {}
                for comp, (m1, m2) in entry["sigma_maps"].items():
                    _, cb = coeffs_E[comp]
                    ce["Bsig"][comp] = (compact(cb * 0.5 * m1),
                                        compact(cb * 0.5 * m2))
            entries.append(ce)
        out["mod"] = entries
    return out


TIME_KEYS = ("eps_c", "eps_s", "sig_c", "sig_s")


def pad_mod_tables(consts: dict, extra: int) -> None:
    """Extends each modulation table by ``extra`` steps with its last value,
    in place (``tidy3d_tpu/solver/fdtd.py:2193-2199``: the implicit update
    stays defined past the physical run)."""
    for ce in consts.get("mod", ()):
        for key in TIME_KEYS:
            if key in ce:
                ce[key] = np.pad(ce[key], (0, extra), mode="edge")


def post_e_to_device(consts: dict, to_device) -> dict:
    """The device copy of the passes' constants: maps by ``to_device``
    (numpy array -> tensor, numpy scalar -> float), the time tables stay
    host numpy (the step reads one value of each)."""
    out = {}
    if "nl" in consts:
        out["nl"] = {kind: {c: to_device(v) for c, v in maps.items()}
                     for kind, maps in consts["nl"].items()}
        out["nl_num_iters"] = consts["nl_num_iters"]
    if "mod" in consts:
        out["mod"] = [{key: ({c: (to_device(b1), to_device(b2))
                              for c, (b1, b2) in v.items()}
                             if key in ("Beps", "Bsig") else v)
                       for key, v in ce.items()} for ce in consts["mod"]]
    return out


def has_post_e(consts: dict) -> bool:
    """Whether the run has any pass after the E update."""
    return bool(consts.get("mod")) or "nl" in consts


def _at(table, step: int) -> float:
    """``table[step]`` with the index clamped, as ``lax.dynamic_index_in_dim``
    reads it."""
    return f32(table[min(max(step, 0), len(table) - 1)])


def mod_times(ce: dict, step: int) -> tuple:
    """``(c_n, s_n, c_n1, s_n1, c_h, s_h)`` of an entry at ``step``, float32
    (0 where the entry has no such table)."""
    zero = f32(0.0)
    eps = (_at(ce["eps_c"], step), _at(ce["eps_s"], step),
           _at(ce["eps_c"], step + 1), _at(ce["eps_s"], step + 1)) \
        if "eps_c" in ce else (zero,) * 4
    sig = (_at(ce["sig_c"], step), _at(ce["sig_s"], step)) \
        if "sig_c" in ce else (zero,) * 2
    return eps + sig


def _mul(b, t):
    """``b * t`` in float32: a scalar coefficient times a float32 scalar
    stays a float32 scalar."""
    if isinstance(b, torch.Tensor):
        return b * float(t)
    return f32(b) * t


def mod_num_den(ce: dict, comp: str, step: int):
    """``(num, den)`` of entry ``ce`` on ``comp`` at ``step`` (float32
    scalars or maps), or None where the entry leaves ``comp`` alone
    (``tidy3d_tpu/solver/fdtd.py:1637-1664``)."""
    c_n, s_n, c_n1, s_n1, c_h, s_h = mod_times(ce, step)
    num = den = f32(0.0)     # jnp.zeros(()): float32
    has = False
    if comp in ce.get("Beps", {}):
        b1, b2 = ce["Beps"][comp]
        num = num + (_mul(b1, c_n) + _mul(b2, s_n))
        den = den + (_mul(b1, c_n1) + _mul(b2, s_n1))
        has = True
    if comp in ce.get("Bsig", {}):
        b1, b2 = ce["Bsig"][comp]
        s_term = _mul(b1, c_h) + _mul(b2, s_h)
        num = num - s_term
        den = den + s_term
        has = True
    return (num, den) if has else None


def _wide(t):
    """A tensor widened to float32, where JAX promotes a float32 operand."""
    return t if t.dtype == torch.float32 else t.float()


def _cube(t):
    """``t * t * t`` at ``t``'s own type, then widened (JAX cubes a bfloat16
    field in bfloat16 before a float32 coefficient promotes it)."""
    return _wide(t * t * t)


def post_e_reference(new_e: dict, old_e: dict, consts: dict, step: int,
                     store: bool = True) -> dict:
    """The passes on one copy, out of place: ``new_e`` holds E_lin (the E
    family with its J sources), ``old_e`` the field before the step.
    Returns the new ``{comp: E'}``, rounded to ``new_e``'s types
    (``store``) or in float32."""
    out = dict(new_e)
    for ce in consts.get("mod", ()):
        for comp in E_COMPS:
            nd = mod_num_den(ce, comp, step)
            if nd is None:
                continue
            num, den = nd
            den1 = 1.0 + den            # float32, as a scalar or a map
            if not isinstance(num, torch.Tensor):
                num = float(num)
            if not isinstance(den1, torch.Tensor):
                den1 = float(den1)
            out[comp] = (_wide(out[comp]) + num * _wide(old_e[comp])) / den1
    if "nl" in consts:
        nl = consts["nl"]
        for comp in E_COMPS:
            B, K = nl["B"].get(comp), nl["K"].get(comp)
            if B is None and K is None:
                continue
            e_old, e_lin = old_e[comp], out[comp]
            e_it = e_lin
            e_old3 = _cube(e_old)
            for _ in range(consts["nl_num_iters"]):
                e_new = _wide(e_lin)
                if B is not None:
                    e_new = e_new - B * (_cube(e_it) - e_old3)
                if K is not None:
                    e_new = e_new - K * _cube(0.5 * (e_old + e_it))
                e_it = e_new
            out[comp] = e_it
    if store:
        out = {c: v.to(new_e[c].dtype) for c, v in out.items()}
    return out
