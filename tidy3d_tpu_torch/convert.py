"""Carries stepping state between ``tidy3d_tpu`` (numpy) and the port, and
between a global state and the shards of a sharded run.

The JAX runner's unsharded one-step tiers keep E/H as dicts of
``(nx, ny, nz)`` arrays, psi slabs keyed ``"comp|axis|side"`` and the pole
currents ``Q`` as a list (one entry per pole) of ``{comp: (qr, qi)}``. A
complex (Bloch) run adds the imaginary copy ``E1``, ``H1``, ``psi1`` and its
pole currents ``Q1``, as in
``tidy3d_tpu/solver/fdtd.py:816-821``. The XLA path stores every slab in
natural layout (the slab width on its own axis); the Pallas tiers store the
z slabs transposed as ``(x, z-slab, y)`` (``tidy3d_tpu/solver/fdtd.py:
803-809``). The port always uses the natural layout. ``z_transposed=True``
names the Pallas layout on the numpy side.

Storage types: an array is carried to the port at the runner's type for
its kind (``runner.dtype`` for the fields, ``psi_dtype``, ``q_dtype``),
through float32: a bfloat16 array of the reference widens to float32
exactly and narrows back exactly. A port tensor comes back as float32
numpy, exactly (``_numpy``).
"""

from __future__ import annotations

import numpy as np
import torch

_COPIES = (("E", "H", "psi"), ("E1", "H1", "psi1"))


def _is_z_slab(key: str) -> bool:
    return key.split("|")[1] == "2"


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as float32 numpy (a bfloat16 one widened exactly)."""
    t = t.detach()
    return (t if t.dtype == torch.float32 else t.float()).cpu().numpy()


def _tensor(a, dtype, device) -> torch.Tensor:
    """A numpy array (or tensor) as a new tensor of ``dtype`` on
    ``device``, through float32."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, np.float32))
    return a.to(device=device, dtype=dtype, copy=True).contiguous()


def state_from_reference(state_np: dict, runner, z_transposed: bool = False
                         ) -> dict:
    """Port state (tensors on ``runner.device``, empty monitor
    accumulators) from the reference's E/H/psi numpy dicts (both copies of
    a complex run) and, where the plan has poles, its ``Q`` list (and
    ``Q1``)."""

    def put(a, dtype=runner.dtype):
        # a copy: the runner updates the pole currents in place
        return _tensor(a, dtype, runner.device)

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
            psi[key] = put(v, runner.psi_dtype)
        if set(psi) != set(state[p]):
            raise ValueError("psi slabs differ from the port's: "
                             f"{sorted(set(psi) ^ set(state[p]))}")
        for key, v in psi.items():
            if tuple(v.shape) != tuple(state[p][key].shape):
                raise ValueError(f"psi slab '{key}': shape {tuple(v.shape)}, "
                                 f"expected {tuple(state[p][key].shape)}")
        state[p] = psi
    for key in ("Q", "Q1")[:1 + ("E1" in state)]:
        Q = state_np.get(key, [])
        if len(Q) != len(state[key]):
            raise ValueError(f"{len(Q)} pole currents given in {key}, the "
                             f"plan has {len(state[key])} poles")
        state[key] = [{c: (put(qr, runner.q_dtype), put(qi, runner.q_dtype))
                       for c, (qr, qi) in Qp.items()} for Qp in Q]
    return state


def state_to_reference(state: dict, z_transposed: bool = False) -> dict:
    """The reference's E/H/psi numpy dicts (with ``E1``, ``H1``, ``psi1``
    and ``Q1`` for a complex run) and ``Q`` list from port state."""
    out = {}
    for e, h, p in _COPIES[:1 + ("E1" in state)]:
        for fam in (e, h):
            out[fam] = {c: _numpy(v) for c, v in state[fam].items()}
        out[p] = {}
        for key, v in state[p].items():
            a = _numpy(v)
            if z_transposed and _is_z_slab(key):
                a = np.ascontiguousarray(np.transpose(a, (0, 2, 1)))
            out[p][key] = a
    for key in ("Q", "Q1")[:1 + ("E1" in state)]:
        out[key] = [{c: (_numpy(qr), _numpy(qi))
                     for c, (qr, qi) in Qp.items()}
                    for Qp in state.get(key, [])]
    return out


def shard_states_from_reference(state_np: dict, runner) -> list:
    """The state of each shard of a sharded ``runner`` (tensors on the
    shards' devices, empty monitor parts) from a global state (E/H/psi
    dicts and the ``Q`` list of a real run, of numpy arrays or tensors):
    every x-spanning array as the shard's padded x-slice, its halo planes
    already holding the neighbours' core edges (what a ring exchange
    gives), and the x psi slabs on the edge shards that hold them."""
    lay = runner.layout
    states = runner.init_state()["shards"]
    for s, (sh, st) in enumerate(zip(runner.shards, states)):
        def put(a, dtype=runner.dtype):
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.array(a, np.float32))
            if a.shape[0] == lay.nx:
                a = lay.take(a, s)
            return _tensor(a, dtype, sh.device)

        for fam in ("E", "H"):
            st[fam] = {c: put(v) for c, v in state_np[fam].items()}
        st["psi"] = {key: put(state_np["psi"][key], runner.psi_dtype)
                     for key in st["psi"]}
        Q = state_np.get("Q", [])
        if len(Q) != len(st["Q"]):
            raise ValueError(f"{len(Q)} pole currents given, the plan has "
                             f"{len(st['Q'])} poles")
        st["Q"] = [{c: (put(qr, runner.q_dtype), put(qi, runner.q_dtype))
                    for c, (qr, qi) in Qp.items()} for Qp in Q]
    return states


def shard_states_to_reference(states: list, runner,
                              tensors: bool = False) -> dict:
    """The global state (E/H/psi dicts and ``Q`` list, of float32 numpy
    arrays, or with ``tensors`` of tensors of their own types on the first
    shard's device) from the shards' states: the owned planes of each
    x-spanning array joined in x order, and each x psi slab from the edge
    shard that holds it."""
    lay = runner.layout
    dev = states[0]["E"]["Ex"].device

    def one(a):
        return a.to(dev) if tensors else _numpy(a)

    def join(arrays):
        parts = [one(lay.owned(a)) for a in arrays]
        return torch.cat(parts) if tensors else np.concatenate(parts)

    out = {fam: {c: join([st[fam][c] for st in states])
                 for c in states[0][fam]} for fam in ("E", "H")}
    out["psi"] = {}
    for st in states:
        for key, v in st["psi"].items():
            if key.split("|")[1] == "0":
                out["psi"][key] = one(v)
    for key, v in states[0]["psi"].items():
        if key.split("|")[1] != "0":
            out["psi"][key] = join([st["psi"][key] for st in states])
    out["Q"] = [{c: (join([st["Q"][pi][c][0] for st in states]),
                     join([st["Q"][pi][c][1] for st in states]))
                 for c in Qp} for pi, Qp in enumerate(states[0]["Q"])]
    return out
