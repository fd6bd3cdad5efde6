"""The fused kernel's table path (more than 8 pole slots) carries the pole
drive ``D_i = sum_p (Re Gc_p qr_{p,i} - Im Gc_p qi_{p,i})`` from step to
step (``csrc/fused.cu``, ``kernels/fused.py``), where the JAX fused kernel
recomputes it from every slot's currents (``pole_term``,
``pallas_fused.py:414-425``).

On the CPU, at ``tests/test_torch_many_poles.py``'s sizes (9 and 13
slots): the derived drive against the pole term of the JAX package's XLA
``_step`` (1e-6); a plain walker of the kernel's dataflow (D carried, each
current read once, masks grouped, D' from the rounded Q') for 20 steps
against the JAX package's XLA ``_step`` (2e-5; in bf16 against the port's
plain fused tier, 1e-2: the fused dataflow itself reads ~2e-2 from the XLA
step in bf16, and the walker no farther); which states the
wrapper derives a drive for (fresh, currents replaced or edited in place:
derived; the kernel's own output: kept); the runner's drive sets, their
swap, the memory estimate and the checkpoint names. The kernel against its
plain version needs a CUDA card and skips without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidy3d_tpu_torch import convert
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner, _named
from tidy3d_tpu_torch.solver.kernels import fused as fused_kernels
from tidy3d_tpu_torch.solver.kernels import step as step_kernels
from tidy3d_tpu_torch.solver.lowering import E_COMPS

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    lower_reference as lower, max_rel_err, random_state,
)
from tests.test_torch_many_poles import STEP, TOL, TOL_BF16, TOL_STEP, \
    stack_sim
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

WALK_STEPS = 20


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv("TIDY3D_TPU_TILE_QUANTA", raising=False)
    monkeypatch.setenv("TIDY3D_TPU_PAD_ALIGN", "0")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "xla")


def _state(port, seed):
    """A seeded numpy state of ``port``'s shapes (reference layout)."""
    return random_state(np.random.default_rng(seed), port.shape,
                        port.psi_shapes(), port.consts["pole_scalars"])


@pytest.mark.parametrize("slots", [9, 13])
def test_derived_drive_is_the_jax_pole_term(slots):
    """With E, H and psi zero and no source, the XLA ``_step``'s E' is
    ``-cb * (sum of every slot's pole term)`` where no wall masks it: the
    derived drive equals that term within 1e-6 of its largest value."""
    plan = lower(stack_sim(slots, monitors=False).copy(
        update=dict(sources=[])))
    jr = JaxRunner(plan)
    port = FDTDRunner(plan, device="cpu", kernel="fused")
    st = _state(port, slots)
    for fam in ("E", "H", "psi"):
        st[fam] = {k: np.zeros_like(v) for k, v in st[fam].items()}
    ref = jax.device_get(jr._step(0, jax.device_put(dict(st, mon=[])),
                                  jax.device_put(jr.consts)))
    drive = fused_kernels.derive_drive(
        convert.state_from_reference(st, port)["Q"], port.consts)
    assert fused_kernels.slot_order(port.consts) == list(range(slots))
    for comp in E_COMPS:
        e = np.asarray(ref["E"][comp])
        cb = np.broadcast_to(
            torch.as_tensor(port.consts["coeffs_E"][comp][1]).numpy(),
            e.shape)
        live = e != 0
        assert live.mean() > 0.9
        term = -e[live] / cb[live]
        err = float(np.max(np.abs(term - drive[comp].numpy()[live]))
                    / np.max(np.abs(term)))
        print(f"[drive] {slots} slots {comp}: {err:.2e}")
        assert err <= TOL_STEP, f"{slots} {comp}: {err:.2e}"


def test_slot_order_groups_masks():
    """Slots whose residues read one mask come next to each other, in the
    order of each group's first slot; a plan already so keeps its order."""
    def meta(mid):
        return [{"kind": "mask", "mask_id": mid + ci, "B0": (1.0, 0.0)}
                for ci in range(3)]

    dense = [{"kind": "dense"}, {"kind": "zero"}, {"kind": "dense"}]
    consts = {"pole_B_meta": [meta(0), meta(3), meta(0), dense, meta(3),
                              meta(0)]}
    assert fused_kernels.slot_order(consts) == [0, 2, 5, 1, 4, 3]
    consts = {"pole_B_meta": [meta(0), meta(0), meta(3), dense]}
    assert fused_kernels.slot_order(consts) == [0, 1, 2, 3]


def test_table_slot_cap():
    """The staged table holds at most ``MAX_TABLE_SLOTS`` slots: a plan
    with more leaves the fused tier under ``auto`` (the reason names the
    cap); 13 slots are taken."""
    cap = fused_kernels.MAX_TABLE_SLOTS
    assert fused_kernels.unsupported_reason(1, 13) is None
    assert fused_kernels.unsupported_reason(1, cap) is None
    assert fused_kernels.unsupported_reason(1, cap + 1) == \
        f"{cap + 1} pole slots (the kernel takes {cap})"


# --------------------------------------------------------------------------- #
# a plain walker of the kernel's dataflow against the JAX package
# --------------------------------------------------------------------------- #


def walker_step(port, state, step):
    """One step of the table path as the kernel computes it, in plain
    torch: E' takes the carried drive as one pole term (a slot of Gc = 1
    whose currents are (D, 0): ``rhs - (1 * D - 0 * 0)``); J sources; H'
    from the float32 E'; then per component ``E' + E`` once (E' rounded to
    the fields' type) and the slots in ``slot_order``, each current read
    once, a mask's product with ``E' + E`` formed where the mask differs
    from the one held, Q' rounded to the currents' type and its term added
    to D' as rounded; the H sources after, as the runner adds them."""
    consts, meta = port.consts, port.meta
    drive = state["drive"]
    pseudo = dict(state, Q=[{c: (drive[c], torch.zeros_like(drive[c]))
                             for c in E_COMPS}])
    pc = dict(consts, pole_scalars=[(0j, 1 + 0j)])
    new_e, psi_e = step_kernels.family_update_reference(
        "E", pseudo, pc, state["H"], meta, store=False)
    for comp, sl, term, w in port.step_sources("E", step):
        new_e[comp][sl].add_(term * w)
    new_h, psi_h = step_kernels.family_update_reference(
        "H", state, consts, new_e, meta, store=False)
    f_dt, q_dt = state["E"]["Ex"].dtype, state["Q"][0]["Ex"][0].dtype
    new_q = [{} for _ in state["Q"]]
    new_drive = {}
    for ci, comp in enumerate(E_COMPS):
        esum = new_e[comp].to(f_dt).float() + state["E"][comp].float()
        held, mes, acc = None, None, None
        for pi in fused_kernels.slot_order(consts):
            (A, gc), m = consts["pole_scalars"][pi], consts[
                "pole_B_meta"][pi][ci]
            qr, qi = (t.float() for t in state["Q"][pi][comp])
            r = A.real * qr + (-A.imag) * qi
            im = A.real * qi + A.imag * qr
            if m["kind"] == "mask":
                if m["mask_id"] != held:
                    held = m["mask_id"]
                    mes = consts["pole_masks"][held] * esum
                r = r + m["B0"][0] * mes
                im = im + m["B0"][1] * mes
            elif m["kind"] == "dense":
                b_re, b_im = consts["pole_B_dense"][f"{pi}_{ci}"]
                r = r + b_re * esum
                im = im + b_im * esum
            r, im = r.to(q_dt), im.to(q_dt)
            new_q[pi][comp] = (r, im)
            t = gc.real * r.float() - gc.imag * im.float()
            acc = t if acc is None else acc + t
        new_drive[comp] = acc
    psi = dict(state["psi"])
    psi.update(psi_e)
    psi.update(psi_h)
    new = {"E": {c: v.to(f_dt) for c, v in new_e.items()},
           "H": {c: v.to(f_dt) for c, v in new_h.items()},
           "psi": {k: v.to(state["psi"][k].dtype) for k, v in psi.items()},
           "Q": new_q, "drive": new_drive}
    port._inject("H", new["H"], step)
    return new


def _errors(ref: dict, got: dict) -> dict:
    """Fields, psi and every slot's currents of two reference-layout
    states, each set's largest difference relative to its largest
    magnitude."""
    def f32(d):
        return {k: np.asarray(v, np.float32) for k, v in d.items()}

    errs = {fam: max_rel_err(f32(ref[fam]), f32(got[fam]))
            for fam in ("E", "H", "psi")}
    errs["Q"] = max_rel_err(*(
        f32({f"{p}:{c}:{i}": v for p, Qp in enumerate(s["Q"])
             for c, pair in Qp.items() for i, v in enumerate(pair)})
        for s in (ref, got)))
    return errs


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_walker_matches_xla(precision):
    """20 steps of the 13-slot stack from a seeded random state, the
    walker against the JAX package's XLA ``_step`` at the same storage
    types: within 2e-5 in float32. In bf16 the fused dataflow itself (the
    port's plain fused tier, which rounds where the JAX fused kernel
    does) reads about 2e-2 from the XLA step after 20 steps, and the
    walker as much (both printed); the walker is held within 1e-2 of that
    plain fused tier, whose bf16 runs the JAX fused tier in interpret mode
    holds (``tests/test_torch_many_poles.py``)."""
    plan = lower(stack_sim(13, run_time=6e-15, monitors=False))
    assert plan.num_steps > STEP + WALK_STEPS
    jr = JaxRunner(plan, precision=precision)
    port = FDTDRunner(plan, device="cpu", kernel="fused",
                      precision=precision)
    st = _state(port, 20)
    ref = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jr.dtype),
                                 dict(st, mon=[]))
    step = jax.jit(jr._step)
    consts = jax.device_put(jr.consts)
    state = convert.state_from_reference(st, port)
    state["drive"] = fused_kernels.derive_drive(state["Q"], port.consts)
    plain = convert.state_from_reference(st, port)
    for n in range(WALK_STEPS):
        ref = step(STEP + n, ref, consts)
        state = walker_step(port, state, STEP + n)
        if precision == "bfloat16":
            plain = port.step(STEP + n, plain)
    ref = jax.device_get(ref)
    errs = _errors(ref, convert.state_to_reference(state))
    print(f"[walker] {precision} {WALK_STEPS} steps against the XLA step: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if precision == "bfloat16":
        plain = convert.state_to_reference(plain)
        spread = _errors(ref, plain)
        errs = _errors(plain, convert.state_to_reference(state))
        print("[walker] bf16: the plain fused tier against the XLA step "
              + ", ".join(f"{k} {v:.2e}" for k, v in spread.items())
              + "; the walker against the plain fused tier "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    tol = TOL if precision == "float32" else TOL_BF16
    assert max(errs.values()) <= tol, errs
    # the carried drive is the drive of the carried currents
    again = fused_kernels.derive_drive(state["Q"], port.consts)
    err = max_rel_err({c: v.numpy() for c, v in again.items()},
                      {c: v.numpy() for c, v in state["drive"].items()})
    assert err <= TOL_STEP, err


# --------------------------------------------------------------------------- #
# the wrapper's decision: which states derive their drive
# --------------------------------------------------------------------------- #


def _currents(shape, slots, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [{c: (torch.randn(shape, generator=g).to(dtype),
                 torch.randn(shape, generator=g).to(dtype)) for c in E_COMPS}
            for _ in range(slots)]


def test_drive_staleness():
    """``drive_for`` derives where the drive does not belong to the
    state's currents as they are: a fresh state, replaced currents, a
    current edited in place, an edited drive; it keeps a drive recorded
    for the currents (the kernel's output set, the steady state)."""
    plan = lower(stack_sim(13, monitors=False))
    port = FDTDRunner(plan, device="cpu", kernel="fused")
    shape = port.shape
    zeros = {c: torch.zeros(shape) for c in E_COMPS}
    state = {"Q": _currents(shape, 13, 0), "drive": zeros}

    def derives(st):
        before = fused_kernels.DRIVE_DERIVES
        drive = fused_kernels.drive_for(st, port.consts)
        want = fused_kernels.derive_drive(st["Q"], port.consts)
        for c in E_COMPS:
            assert torch.equal(drive[c], want[c])
        return fused_kernels.DRIVE_DERIVES - before

    assert derives(state) == 1              # a fresh state
    assert state["drive"] is zeros          # derived in place
    assert derives(state) == 0              # steady
    assert derives(state) == 0
    # a state with no drive derives every call
    assert derives({"Q": state["Q"]}) == 1
    # currents replaced after init_state (chip_smoke's random_state)
    state["Q"] = _currents(shape, 13, 1)
    assert derives(state) == 1
    assert derives(state) == 0
    # one current edited in place
    state["Q"][7]["Ey"][1].mul_(2.0)
    assert derives(state) == 1
    assert derives(state) == 0
    # the drive edited in place
    state["drive"]["Ez"].add_(1.0)
    assert derives(state) == 1
    # a slot replaced by an equal copy: other tensors, derived again
    state["Q"][0] = {c: (qr.clone(), qi.clone())
                     for c, (qr, qi) in state["Q"][0].items()}
    assert derives(state) == 1
    # the kernel's output: D' and Q' written without a version bump and
    # recorded together; the next step finds them current
    q_out = _currents(shape, 13, 2)
    d_out = fused_kernels.derive_drive(q_out, port.consts)
    fused_kernels.record_drive(d_out, q_out)
    assert derives({"Q": q_out, "drive": d_out}) == 0
    # the recorded drive with other currents of equal values
    assert derives({"Q": _currents(shape, 13, 2), "drive": d_out}) == 1


def test_drive_bf16_from_stored_currents():
    """bf16 currents: the drive is their float32 sum, each current widened
    exactly."""
    plan = lower(stack_sim(9, monitors=False))
    port = FDTDRunner(plan, device="cpu", kernel="fused",
                      precision="bfloat16")
    Q = _currents(port.shape, 9, 5, torch.bfloat16)
    drive = fused_kernels.derive_drive(Q, port.consts)
    wide = [{c: (qr.float(), qi.float()) for c, (qr, qi) in Qp.items()}
            for Qp in Q]
    want = fused_kernels.derive_drive(wide, port.consts)
    for c in E_COMPS:
        assert drive[c].dtype == torch.float32
        assert torch.equal(drive[c], want[c])


# --------------------------------------------------------------------------- #
# the runner's drive sets
# --------------------------------------------------------------------------- #


@pytest.fixture
def carrying(monkeypatch):
    """The runner's table-path wiring on the CPU: ``carries_drive`` as on
    a card (the step itself still takes the plain version)."""
    monkeypatch.setattr(FDTDRunner, "carries_drive",
                        property(lambda self: self.tier == "fused"))


def test_runner_drive_sets(carrying, tmp_path):
    """Both drive sets in ``init_state``, swapped with the currents each
    step; counted by the memory estimate (24 B a cell) and left out of the
    checkpoint's names, so a checkpoint of a run without them loads."""
    plan = lower(stack_sim(13, monitors=False))
    port = FDTDRunner(plan, device="cpu", kernel="fused")
    cells = int(np.prod(port.shape))
    state = port.init_state()
    assert set(state["drive"]) == set(E_COMPS)
    assert set(state["alt"]) == {"Q", "drive"}
    first, second = state["drive"], state["alt"]["drive"]
    q_first = state["Q"]
    state = port.run_steps(0, 2, state)
    assert state["drive"] is first and state["alt"]["drive"] is second
    assert state["alt"]["Q"] is not q_first
    state = port.run_steps(2, 1, state)
    assert state["drive"] is second and state["alt"]["drive"] is first
    est = port.estimate_device_memory()
    assert not any(n.startswith("drive") for n, _ in _named(state))
    path = str(tmp_path / "ckpt.npz")
    port.save_checkpoint(path, state, 1, 1.0, 1.0)
    loaded = port.load_checkpoint(path)[0]
    assert set(loaded["drive"]) == set(E_COMPS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FDTDRunner, "carries_drive", property(lambda self: False))
        plain = FDTDRunner(plan, device="cpu", kernel="fused")
        assert "drive" not in plain.init_state()
        base = plain.estimate_device_memory()
        assert plain.load_checkpoint(path)[1] == 1
    assert est["state"] - base["state"] == 2 * 3 * 4 * cells
    assert est["work"] >= 4 * cells


# --------------------------------------------------------------------------- #
# the kernel against its plain version, on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _flat(state: dict) -> dict:
    out = {f"{fam}:{k}": v.float().cpu().numpy() for fam in ("E", "H", "psi")
           for k, v in state[fam].items()}
    out.update({f"Q{p}:{c}:{i}": v.float().cpu().numpy()
                for p, Qp in enumerate(state["Q"]) for c, pair in Qp.items()
                for i, v in enumerate(pair)})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_replaced_currents_kernel_matches_plain(precision, cuda):
    """The runner's fused steps on the card with the currents replaced
    after ``init_state``: the first step derives the drive once, the next
    ones carry it; three steps against the plain version's three (float32:
    1e-6 after one step, 2e-5 after three; bf16 1e-2), two tables built
    (the ping-pong's two directions)."""
    from tidy3d_tpu_torch.solver.lowering import lower as port_lower

    plan = port_lower(stack_sim(13))
    port = FDTDRunner(plan, device=cuda, kernel="fused", precision=precision)
    plain = FDTDRunner(plan, device=cuda, kernel="fused", precision=precision,
                       use_kernel=False)
    assert port.carries_drive and not plain.carries_drive
    st = _state(port, 4)
    state = port.init_state()
    state["Q"] = convert.state_from_reference(st, port)["Q"]
    ref = {k: state[k] for k in ("E", "H", "psi", "Q", "mon")}
    derives, builds = (fused_kernels.DRIVE_DERIVES,
                       fused_kernels.TABLE_BUILDS)
    for n in range(3):
        state = port.step(STEP + n, state)
        ref = plain.step(STEP + n, ref)
        err = max_rel_err(_flat(ref), _flat(state))
        tol = TOL_BF16 if precision == "bfloat16" else \
            TOL_STEP if n == 0 else TOL
        print(f"[drive] {precision} step {n}: {err:.2e}")
        assert err <= tol, f"step {n}: {err:.2e}"
    assert fused_kernels.DRIVE_DERIVES == derives + 1
    assert fused_kernels.TABLE_BUILDS == builds + 2
