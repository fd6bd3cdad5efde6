"""The fused tier's pole update, folded into the fused step, against the JAX
package.

``fused_step_reference`` returns ``(E', H', psi', Q')``: the pole update
``Q' = A Q + B (E' + E)`` is part of the step, out of place. Held here:

* float32: one step (the plain fused step and the H sources, as the runner
  takes it) against the JAX runner's XLA ``_step`` on the same seeded numpy
  state, to 1e-6 of each group's largest magnitude, and 50 whole steps of
  the runner's ``fused`` tier against 50 XLA steps, to 2e-5, on a Lorentz
  pole, the 7-pole Au fit (mask residues) and the Lorentz pole with dense
  residue maps;
* bfloat16: one step against the JAX package's fused tier in interpret mode
  at the same storage types, to 1e-2 (the port takes E' + E from E' rounded
  to bf16 and computes the update in float32; the JAX tier rounds each
  operation of its weak-typed bf16 update);
* the input currents untouched, the runner's ``fused`` step calling no
  ``update_poles``, the fused tier's second pole-current set (its ping-pong
  swap, the memory estimate's count of it, and checkpoints of the current
  set only), and ``select_tier`` on a CUDA device for time monitors off and
  on the k-step group ends.

The kernel-against-plain cases at the end need a CUDA card and skip
without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch import convert
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner, select_tier
from tidy3d_tpu_torch.solver.kernels import fused as fused_kernels
from tidy3d_tpu_torch.solver.kernels import poles as poles_kernels

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    DIELECTRIC, DISPERSIVE, GOLD, SIMS, lower_reference as lower,
    max_rel_err, random_state,
)
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

TOL_XLA = 1e-6      # float32 rounding of the same expression tree
TOL_STEPS = 2e-5    # the reference's own bar for whole runs
TOL_BF16 = 1e-2     # one bf16 rounding is 2^-9 of a value at most
STEP = 40           # a step inside the source pulse
STEPS = 50
BF16 = torch.bfloat16
# (case, dense residue maps)
CASES = {"lorentz": ("lorentz_mixed", False),
         "gold": ("gold_halfspace", False),
         "lorentz_dense": ("lorentz_mixed", True)}
# the bf16 cases: the JAX fused tier in interpret mode takes the mixed-wall
# grid, not the all-PML one of gold_halfspace, so the 7-pole Au fit fills a
# box of the mixed-wall case there
BF16_CASES = ("lorentz", "gold_mixed", "lorentz_dense")


def gold_mixed(**kw):
    """The 7-pole Au fit in a box beside the dielectric, mixed walls."""
    return DISPERSIVE["lorentz_mixed"](**kw).copy(update=dict(
        structures=[DIELECTRIC, tt.Structure(
            geometry=tt.Box(center=(0.05, 0.0, 0.1), size=(0.35, 0.3, 0.3)),
            medium=GOLD)]))


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "xla")
    for key in ("TIDY3D_TPU_KSTEP", "TIDY3D_TPU_PRECISION",
                "TIDY3D_TPU_PSI_DTYPE", "TIDY3D_TPU_Q_DTYPE",
                "TIDY3D_TPU_PAD_ALIGN"):
        monkeypatch.delenv(key, raising=False)


def _plan(key):
    if key == "gold_mixed":
        return lower(gold_mixed())
    name, dense = CASES[key]
    plan = lower(DISPERSIVE[name]())
    if dense:
        nx = plan.shape[0]
        ramp = (1.0 + 0.5 * np.arange(nx) / nx).reshape(-1, 1, 1)
        for pp in plan.poles:
            pp.c_maps = tuple(m * ramp for m in
                              pp.dense_c_maps(plan.pole_masks, plan.shape))
    return plan


def _kinds(port):
    return {m["kind"] for metas in port.consts["pole_B_meta"] for m in metas}


def _flat(state: dict) -> dict:
    """E, H, psi and Q of a numpy state as one flat dict."""
    out = {}
    for fam in ("E", "H", "psi"):
        out.update({f"{fam}:{k}": np.asarray(v, np.float32)
                    for k, v in state[fam].items()})
    for pi, Qp in enumerate(state["Q"]):
        for c, (qr, qi) in Qp.items():
            out[f"Q{pi}:{c}:re"] = np.asarray(qr, np.float32)
            out[f"Q{pi}:{c}:im"] = np.asarray(qi, np.float32)
    return out


def _errors(ref: dict, got: dict) -> dict:
    """Each group's (E, H, psi, every pole's Q) largest difference relative
    to its largest magnitude."""
    assert set(ref) == set(got)
    out = {}
    for group in sorted({k.split(":")[0] for k in ref}):
        keys = [k for k in ref if k.split(":")[0] == group]
        out[group] = max_rel_err({k: ref[k] for k in keys},
                                 {k: got[k] for k in keys})
    return out


def _check(what, ref, got, tol):
    errs = _errors(_flat(ref), _flat(got))
    print(f"[fused poles] {what}: " + ", ".join(
        f"{g} {e:.2e}" for g, e in errs.items()))
    assert any(g.startswith("Q") for g in errs), "no pole currents compared"
    for group, err in errs.items():
        assert err <= tol, f"{what} {group}: rel err {err:.2e}"


def _to_np(out) -> dict:
    """A JAX state as float32 numpy in the reference layout."""
    return convert.state_to_reference({
        "E": {c: torch.from_numpy(np.array(v, np.float32))
              for c, v in out["E"].items()},
        "H": {c: torch.from_numpy(np.array(v, np.float32))
              for c, v in out["H"].items()},
        "psi": {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in out["psi"].items()},
        "Q": [{c: (torch.from_numpy(np.array(qr, np.float32)),
                   torch.from_numpy(np.array(qi, np.float32)))
               for c, (qr, qi) in Qp.items()} for Qp in out["Q"]]})


def _state(port, seed):
    return random_state(np.random.default_rng(seed), port.shape,
                        port.psi_shapes(), port.consts["pole_scalars"])


@pytest.mark.parametrize("key", sorted(CASES))
def test_plain_step_matches_xla(key):
    plan = _plan(key)
    jr = JaxRunner(plan)
    port = FDTDRunner(plan, device="cpu", kernel="fused")
    assert _kinds(port) == ({"dense"} if CASES[key][1] else {"mask"})
    st = _state(port, 17)
    out = jax.jit(lambda s, c: jr._step(STEP, s, c))(
        jax.device_put(dict(st, mon=[])), jax.device_put(jr.consts))
    state = convert.state_from_reference(st, port)
    nE, nH, psi, Q = fused_kernels.fused_step_reference(
        state, port.consts, port.meta, port.step_sources("E", STEP))
    port._inject("H", nH, STEP)
    got = convert.state_to_reference({"E": nE, "H": nH, "psi": psi, "Q": Q})
    _check(f"{key} one step", _to_np(out), got, TOL_XLA)


@pytest.mark.parametrize("key", sorted(CASES))
def test_fused_tier_steps_match_xla(key):
    plan = _plan(key)
    jr = JaxRunner(plan)
    port = FDTDRunner(plan, device="cpu", kernel="fused")
    st = _state(port, 19)
    out = jax.jit(lambda s, c: jax.lax.fori_loop(
        0, STEPS, lambda n, x: jr._step(n, x, c), s))(
        jax.device_put(dict(st, mon=[])), jax.device_put(jr.consts))
    state = port.run_steps(0, STEPS, convert.state_from_reference(st, port))
    _check(f"{key} {STEPS} steps", _to_np(out),
           convert.state_to_reference(state), TOL_STEPS)


def _bf16(tree):
    """Every float32 array of a numpy state rounded to a bf16 value."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(BF16).float().numpy()
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_bf16(v) for v in tree)
    return tree


def _z_t(psi: dict) -> dict:
    """psi slabs between the natural and the Pallas (x, z-slab, y) layout
    of the z slabs."""
    return {k: (np.ascontiguousarray(np.transpose(v, (0, 2, 1)))
                if k.split("|")[1] == "2" else v) for k, v in psi.items()}


@pytest.mark.parametrize("key", BF16_CASES)
def test_bf16_step_matches_fused_interpret(key, monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "fused_interpret")
    plan = _plan(key)
    assert len(plan.poles) == (7 if key == "gold_mixed" else 1)
    jr = JaxRunner(plan, precision="bfloat16")
    assert jr.fused is not None
    port = FDTDRunner(plan, device="cpu", precision="bfloat16",
                      kernel="fused")
    st = _bf16(_state(port, 37))
    out = jax.jit(lambda s, c: jr._step(STEP, s, c))(
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                               dict(st, psi=_z_t(st["psi"]), mon=[])),
        jax.device_put(jr.consts))
    assert out["Q"][0]["Ex"][0].dtype == jnp.bfloat16
    ref = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                 dict(out, mon=[]))
    ref["psi"] = _z_t(ref["psi"])
    got = port.step(STEP, convert.state_from_reference(st, port))
    assert got["Q"][0]["Ex"][0].dtype == BF16
    _check(f"{key} bf16 step vs fused_interpret", ref,
           convert.state_to_reference(got), TOL_BF16)


def test_input_currents_untouched():
    port = FDTDRunner(_plan("gold"), device="cpu", kernel="fused")
    state = convert.state_from_reference(_state(port, 3), port)
    before = [{c: (qr.clone(), qi.clone()) for c, (qr, qi) in Qp.items()}
              for Qp in state["Q"]]
    _, _, _, Q = fused_kernels.fused_step(
        state, port.consts, port.meta, port.step_sources("E", STEP))
    assert len(Q) == len(state["Q"]) == 7
    for old, now, new in zip(before, state["Q"], Q):
        for c in old:
            for part in range(2):
                assert torch.equal(old[c][part], now[c][part])
                assert new[c][part].data_ptr() != now[c][part].data_ptr()
                assert not torch.equal(new[c][part], now[c][part])


def test_runner_step_calls_no_plain_pole_update(monkeypatch):
    """The runner's fused step takes Q' from the step; the second
    pole-current set swaps with the first each step."""
    def refuse(*args, **kwargs):
        raise AssertionError("update_poles called on the fused tier")

    monkeypatch.setattr(poles_kernels, "update_poles", refuse)
    port = FDTDRunner(_plan("lorentz"), device="cpu", kernel="fused")
    state = convert.state_from_reference(_state(port, 4), port)
    assert set(state["alt"]) == {"Q"}
    first = state["Q"]
    before = fused_kernels.LAUNCHES
    state.update(port.step(STEP, state))
    assert fused_kernels.LAUNCHES == before
    assert state["alt"]["Q"] is first and state["Q"] is not first
    state = port.run_steps(STEP + 1, 3, state)
    assert all(torch.isfinite(v).all() for Qp in state["Q"]
               for pair in Qp.values() for v in pair)


def test_plain_pole_update_stays_on_pallas2(monkeypatch):
    calls = []
    real = poles_kernels.update_poles

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(poles_kernels, "update_poles", counted)
    port = FDTDRunner(_plan("lorentz"), device="cpu", kernel="pallas2")
    state = port.init_state()
    assert "alt" not in state
    port.run_steps(0, 2, state)
    assert len(calls) == 2


def _time_sims(start_steps: float = 0.0, interval: int = 1):
    """The Lorentz case with a point field-time monitor (Ez) and a
    flux-time monitor on a box around the source, both from ``start_steps``
    time steps on."""
    base = DISPERSIVE["lorentz_mixed"]()
    dt = lower(base).dt
    mons = {
        "field": tt.FieldTimeMonitor(
            center=(0, 0, 0), size=(0, 0, 0), fields=["Ez"],
            start=start_steps * dt, interval=interval, name="probe"),
        "flux": tt.FluxTimeMonitor(
            center=(0, 0, 0), size=(0.3, 0.3, 0.3),
            start=start_steps * dt, interval=interval, name="flux_t"),
    }
    return {what: base.copy(update=dict(monitors=[m]))
            for what, m in mons.items()}


@pytest.mark.parametrize("what", ["field", "flux"])
def test_auto_takes_fused_for_default_start_time_monitors(what, monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    plan = lower(_time_sims()[what])
    assert any(mp.kind == "field_time" and mp.t_start == 0
               for mp in plan.monitors)
    n = FDTDRunner(plan, device="cpu").num_sources
    # the choice reads only the device's type: no card needed
    assert select_tier(plan, n, torch.device("cuda")) == ("fused", 1)
    # a start on a group end and an even interval: the k-step tier
    late = lower(_time_sims(start_steps=0.5, interval=2)[what])
    assert all(mp.t_start % 2 == 1 and mp.t_interval == 2
               for mp in late.monitors if mp.kind == "field_time")
    assert select_tier(late, n, torch.device("cuda")) == ("kstep", 2)
    # the CPU's auto stays fused either way
    assert select_tier(late, n, torch.device("cpu")) == ("fused", 1)


def test_memory_estimate_counts_the_second_pole_set():
    plan = _plan("gold")
    fused = FDTDRunner(plan, device="cpu", kernel="fused")
    two = FDTDRunner(plan, device="cpu", kernel="pallas2")
    cells = int(np.prod(fused.shape))
    q_bytes = 7 * 6 * 4 * cells
    ef, e2 = (r.estimate_device_memory() for r in (fused, two))
    # the fused tier holds a second Q set; pallas2 the plain update's
    # temporaries instead
    assert ef["state"] - e2["state"] == q_bytes
    assert ef["work"] == 4 * cells
    assert e2["work"] == two._pole_work(cells) > 4 * cells
    # without poles neither holds a second set
    plain = lower(SIMS["pml_all"]())
    a, b = (FDTDRunner(plain, device="cpu", kernel=k).estimate_device_memory()
            for k in ("fused", "pallas2"))
    assert a["state"] == b["state"] and a["work"] == b["work"]


def test_checkpoint_holds_the_current_pole_set(tmp_path):
    port = FDTDRunner(_plan("lorentz"), device="cpu", kernel="fused")
    state = port.run_steps(0, 3, port.init_state())
    path = str(tmp_path / "ck.npz")
    port.save_checkpoint(path, state, 1, 1.0, 1.0)
    with np.load(path) as data:
        assert not any(n.startswith("alt") for n in data.files)
        assert "Q.0.Ex.re" in data.files
    loaded, *_ = port.load_checkpoint(path)
    assert set(loaded["alt"]) == {"Q"}
    for c, (qr, qi) in state["Q"][0].items():
        assert torch.equal(loaded["Q"][0][c][0], qr)
        assert torch.equal(loaded["Q"][0][c][1], qi)
    a = port.run_steps(3, 4, state)
    b = port.run_steps(3, 4, loaded)
    for c in ("Ex", "Ey", "Ez"):
        assert torch.equal(a["E"][c], b["E"][c])


# --------------------------------------------------------------------------- #
# kernel against plain version, on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("key", sorted(CASES))
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_kernel_q_matches_plain(key, precision, cuda):
    port = FDTDRunner(_plan(key), device=cuda, kernel="fused",
                      precision=precision)
    st = _state(port, 5)
    if precision == "bfloat16":
        st = _bf16(st)
    state = convert.state_from_reference(st, port)
    src = port.step_sources("E", STEP)
    before = fused_kernels.LAUNCHES
    got = fused_kernels.fused_step(state, port.consts, port.meta, src,
                                   q_out=state["alt"]["Q"])
    torch.cuda.synchronize()
    assert fused_kernels.LAUNCHES == before + 1
    ref = fused_kernels.fused_step_reference(state, port.consts, port.meta,
                                             src)
    tol = TOL_XLA if precision == "float32" else TOL_BF16
    _check(f"{key} {precision} kernel vs plain",
           convert.state_to_reference(dict(zip(("E", "H", "psi", "Q"), ref))),
           convert.state_to_reference(dict(zip(("E", "H", "psi", "Q"), got))),
           tol)


@pytest.mark.gpu
@pytest.mark.parametrize("key", sorted(CASES))
def test_kernel_runner_q_matches_plain_runner(key, cuda):
    """40 whole steps on the kernel and on the plain versions, the pole
    currents included: 2e-5."""
    plan = _plan(key)
    finals = []
    for use_kernel in (True, False):
        runner = FDTDRunner(plan, device=cuda, kernel="fused",
                            use_kernel=use_kernel)
        state = runner.run_steps(0, 40, runner.init_state())
        finals.append(convert.state_to_reference(state))
    _check(f"{key} 40 steps kernel vs plain", finals[1], finals[0],
           TOL_STEPS)
