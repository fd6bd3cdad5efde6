"""Carries stepping state between ``tidy3d_tpu`` (numpy) and the port.

The JAX runner's unsharded one-step tiers keep E/H as dicts of
``(nx, ny, nz)`` arrays, psi slabs keyed ``"comp|axis|side"`` and the pole
currents ``Q`` as a list (one entry per pole) of ``{comp: (qr, qi)}``. A
complex (Bloch) run adds the imaginary copy ``E1``, ``H1``, ``psi1`` (and
``Q1``, empty: the port takes no Bloch run with poles), as in
``tidy3d_tpu/solver/fdtd.py:816-821``. The XLA path stores every slab in
natural layout (the slab width on its own axis); the Pallas tiers store the
z slabs transposed as ``(x, z-slab, y)`` (``tidy3d_tpu/solver/fdtd.py:
803-809``). The port always uses the natural layout. ``z_transposed=True``
names the Pallas layout on the numpy side.
"""

from __future__ import annotations

import numpy as np
import torch

_COPIES = (("E", "H", "psi"), ("E1", "H1", "psi1"))


def _is_z_slab(key: str) -> bool:
    return key.split("|")[1] == "2"


def state_from_reference(state_np: dict, runner, z_transposed: bool = False
                         ) -> dict:
    """Port state (tensors on ``runner.device``, empty monitor
    accumulators) from the reference's E/H/psi numpy dicts (both copies of
    a complex run) and, where the plan has poles, its ``Q`` list."""

    def put(a):
        # a copy: the runner updates the pole currents in place
        return torch.from_numpy(np.array(a, np.float32)).to(runner.device)

    state = runner.init_state()
    if ("E1" in state_np) != ("E1" in state):
        raise ValueError("the reference state and the runner differ in "
                         "their field copies (real against complex)")
    for e, h, p in _COPIES[:1 + ("E1" in state)]:
        for fam in (e, h):
            state[fam] = {c: put(v) for c, v in state_np[fam].items()}
        psi = {}
        for key, v in state_np[p].items():
            if z_transposed and _is_z_slab(key):
                v = np.transpose(v, (0, 2, 1))
            psi[key] = put(v)
        if set(psi) != set(state[p]):
            raise ValueError("psi slabs differ from the port's: "
                             f"{sorted(set(psi) ^ set(state[p]))}")
        for key, v in psi.items():
            if tuple(v.shape) != tuple(state[p][key].shape):
                raise ValueError(f"psi slab '{key}': shape {tuple(v.shape)}, "
                                 f"expected {tuple(state[p][key].shape)}")
        state[p] = psi
    Q = state_np.get("Q", [])
    if len(Q) != len(state["Q"]):
        raise ValueError(f"{len(Q)} pole currents given, the plan has "
                         f"{len(state['Q'])} poles")
    state["Q"] = [{c: (put(qr), put(qi)) for c, (qr, qi) in Qp.items()}
                  for Qp in Q]
    return state


def state_to_reference(state: dict, z_transposed: bool = False) -> dict:
    """The reference's E/H/psi numpy dicts (with ``E1``, ``H1``, ``psi1``
    and an empty ``Q1`` for a complex run) and ``Q`` list from port
    state."""
    out = {}
    for e, h, p in _COPIES[:1 + ("E1" in state)]:
        for fam in (e, h):
            out[fam] = {c: v.cpu().numpy() for c, v in state[fam].items()}
        out[p] = {}
        for key, v in state[p].items():
            a = v.cpu().numpy()
            if z_transposed and _is_z_slab(key):
                a = np.ascontiguousarray(np.transpose(a, (0, 2, 1)))
            out[p][key] = a
    out["Q"] = [{c: (qr.cpu().numpy(), qi.cpu().numpy())
                 for c, (qr, qi) in Qp.items()} for Qp in state.get("Q", [])]
    if "E1" in state:
        out["Q1"] = []
    return out
