"""Carries stepping state between ``tidy3d_tpu`` (numpy) and the port.

The JAX runner's unsharded one-step tiers keep E/H as dicts of
``(nx, ny, nz)`` arrays, psi slabs keyed ``"comp|axis|side"`` and the pole
currents ``Q`` as a list (one entry per pole) of ``{comp: (qr, qi)}``. The XLA
path stores every slab in natural layout (the slab width on its own axis);
the Pallas tiers store the z slabs transposed as ``(x, z-slab, y)``
(``tidy3d_tpu/solver/fdtd.py:803-809``). The port always uses the natural
layout. ``z_transposed=True`` names the Pallas layout on the numpy side.
"""

from __future__ import annotations

import numpy as np
import torch

_FIELDS = ("E", "H")


def _is_z_slab(key: str) -> bool:
    return key.split("|")[1] == "2"


def state_from_reference(state_np: dict, runner, z_transposed: bool = False
                         ) -> dict:
    """Port state (tensors on ``runner.device``, empty monitor
    accumulators) from the reference's E/H/psi numpy dicts and, where the
    plan has poles, its ``Q`` list."""

    def put(a):
        # a copy: the runner updates the pole currents in place
        return torch.from_numpy(np.array(a, np.float32)).to(runner.device)

    state = runner.init_state()
    for fam in _FIELDS:
        state[fam] = {c: put(v) for c, v in state_np[fam].items()}
    psi = {}
    for key, v in state_np["psi"].items():
        if z_transposed and _is_z_slab(key):
            v = np.transpose(v, (0, 2, 1))
        psi[key] = put(v)
    if set(psi) != set(state["psi"]):
        raise ValueError("psi slabs differ from the port's: "
                         f"{sorted(set(psi) ^ set(state['psi']))}")
    for key, v in psi.items():
        if tuple(v.shape) != tuple(state["psi"][key].shape):
            raise ValueError(f"psi slab '{key}': shape {tuple(v.shape)}, "
                             f"expected {tuple(state['psi'][key].shape)}")
    state["psi"] = psi
    Q = state_np.get("Q", [])
    if len(Q) != len(state["Q"]):
        raise ValueError(f"{len(Q)} pole currents given, the plan has "
                         f"{len(state['Q'])} poles")
    state["Q"] = [{c: (put(qr), put(qi)) for c, (qr, qi) in Qp.items()}
                  for Qp in Q]
    return state


def state_to_reference(state: dict, z_transposed: bool = False) -> dict:
    """The reference's E/H/psi numpy dicts and ``Q`` list from port
    state."""
    out = {fam: {c: v.cpu().numpy() for c, v in state[fam].items()}
           for fam in _FIELDS}
    out["psi"] = {}
    for key, v in state["psi"].items():
        a = v.cpu().numpy()
        if z_transposed and _is_z_slab(key):
            a = np.ascontiguousarray(np.transpose(a, (0, 2, 1)))
        out["psi"][key] = a
    out["Q"] = [{c: (qr.cpu().numpy(), qi.cpu().numpy())
                 for c, (qr, qi) in Qp.items()} for Qp in state.get("Q", [])]
    return out
