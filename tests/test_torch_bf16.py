"""bfloat16 storage in the port against the JAX package at the same storage
types.

The JAX package stores the fields in bf16 under ``precision="bfloat16"``
(every tier; psi and the pole currents at the fields' type on its one-step
tiers) and, on its k-step kernel, psi and the pole state under
``TIDY3D_TPU_PSI_DTYPE`` and ``TIDY3D_TPU_Q_DTYPE``. Each of its tiers
rounds at its own places, so each tier of the port is held against the same
tier of the JAX package, its Pallas kernels run in interpret mode, at the
same storage types; the XLA path rounds every bf16 operation and is not the
reference here. Inputs are random states made from a seed with numpy,
rounded to bf16 values, and carried across by ``convert``. The bar is
``TOL_BF16`` = 1e-2 of the largest magnitude; each test prints the error
it measured (``pytest -s``).

Where the port rounds elsewhere than the JAX tier, the test says so:

* ``pallas2``: the JAX tier adds the x-CPML term after its kernel, from a
  difference taken in bf16 and rounded into the stored field once more
  (``pallas_step.py:432-466``); the port's kernel takes all three axes
  inside. The cells of the x-PML slabs differ by about one bf16 rounding;
  the other cells are held to ``TOL_SAME``.
* ``fused``: the JAX tier adds the J terms and the x-CPML term after its
  kernel, rounded to bf16, and carries them into H' with one more rounding
  (``fdtd.py:1505-1605``); the port's kernel adds them to E' before its
  store. The same bar absorbs it.
* ``kstep``: the JAX kernel packs psi into its own layouts and stores the
  pole state as ``Gc Q`` (``pallas_kstep.py:184-206``), the port as ``Q``;
  so one group is held against the JAX package's float32 step taken k
  times with the kernel's rounding (fields and Q once at the group's end,
  x and y psi after each substep, z psi at the end), and the JAX kernel
  itself is held in whole runs (raw monitors, interpret mode).

Also here: bf16 shards against the unsharded run, a bf16 checkpoint's
exact resume and the refusal of a file of other storage types, the memory
gate at bf16 element sizes, ``convert`` both ways and the ``kernel tier:``
line. The kernel-against-plain tests at the end need a CUDA card and skip
without one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch import convert
from tidy3d_tpu_torch.exceptions import SetupError
from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.kernels import fused as fused_kernels
from tidy3d_tpu_torch.solver.kernels import kstep as kstep_kernels
from tidy3d_tpu_torch.solver.kernels import step as step_kernels
from tidy3d_tpu_torch.solver.sharding import ShardingPlan, make_mesh

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    DISPERSIVE, FREQ0, lower_reference as lower, max_rel_err, random_state,
)
from tests.test_torch_fused import _interp_sim
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

TOL_BF16 = 1e-2     # one bf16 rounding is 2^-9 of a value at most
TOL_SAME = 1e-3     # cells the two round at the same places
STEP = 40           # a step inside the source pulse
BF16, F32 = torch.bfloat16, torch.float32
# (fields, psi, Q) of the k-step tier: TIDY3D_TPU_PRECISION and the knobs
COMBOS = {
    "f32": ("float32", "", ""),
    "psi": ("float32", "bfloat16", ""),
    "q": ("float32", "", "bfloat16"),
    "psi_q": ("float32", "bfloat16", "bfloat16"),
    "bf16": ("bfloat16", "bfloat16", "bfloat16"),
}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    for key in ("TIDY3D_TPU_KERNEL", "TIDY3D_TPU_KSTEP", "TIDY3D_TPU_SHARD",
                "TIDY3D_TPU_PRECISION", "TIDY3D_TPU_PSI_DTYPE",
                "TIDY3D_TPU_Q_DTYPE", "TIDY3D_TPU_HBM_BYTES",
                "TIDY3D_TPU_MEM_CHECK", "TIDY3D_TPU_PAD_ALIGN"):
        monkeypatch.delenv(key, raising=False)


def _combo(monkeypatch, name):
    """Sets the knobs of storage combination ``name``; returns the
    precision."""
    prec, psi, q = COMBOS[name]
    for knob, value in (("TIDY3D_TPU_PSI_DTYPE", psi),
                        ("TIDY3D_TPU_Q_DTYPE", q)):
        if value:
            monkeypatch.setenv(knob, value)
        else:
            monkeypatch.delenv(knob, raising=False)
    return prec


def _bf16(tree):
    """Every float32 array of a numpy state rounded to a bf16 value (still
    float32)."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(BF16).float().numpy()
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_bf16(v) for v in tree)
    return tree


def _jnp(tree, dtype=jnp.bfloat16):
    """A numpy state as JAX arrays of ``dtype``."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _np(tree):
    """A JAX state as float32 numpy (bf16 widened exactly)."""
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _rounded(tree, dtype=jnp.bfloat16):
    """JAX arrays as they are stored: rounded to ``dtype``, as float32
    numpy."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(dtype), np.float32), tree)


def _flat(state: dict) -> dict:
    """E, H, psi and Q of a numpy state as one flat dict."""
    out = {}
    for fam in ("E", "H", "psi"):
        out.update({f"{fam}:{k}": np.asarray(v, np.float32)
                    for k, v in state.get(fam, {}).items()})
    for pi, Qp in enumerate(state.get("Q", [])):
        for c, (qr, qi) in Qp.items():
            out[f"Q{pi}:{c}:re"] = np.asarray(qr, np.float32)
            out[f"Q{pi}:{c}:im"] = np.asarray(qi, np.float32)
    return out


def _errors(ref: dict, got: dict) -> dict:
    """The largest difference of each group (E, H, psi, each pole's Q)
    relative to the group's largest magnitude."""
    assert set(ref) == set(got)
    out = {}
    for group in sorted({k.split(":")[0] for k in ref}):
        keys = [k for k in ref if k.split(":")[0] == group]
        out[group] = max_rel_err({k: ref[k] for k in keys},
                                 {k: got[k] for k in keys})
    return out


def _report(what: str, errs: dict, tol: float = TOL_BF16) -> None:
    print(f"[bf16] {what}: " + ", ".join(
        f"{g} {e:.2e}" for g, e in errs.items()))
    for group, err in errs.items():
        assert err <= tol, f"{what} {group}: rel err {err:.2e}"


def _raw_err(ref: dict, got: dict) -> float:
    """The largest difference of two raw monitor sets relative to each
    monitor's largest magnitude."""
    assert set(ref) == set(got)
    worst = 0.0
    for idx in ref:
        assert set(ref[idx]) == set(got[idx])
        if ref[idx]:
            worst = max(worst, max_rel_err(ref[idx], got[idx]))
    return worst


def _equal_share(ref: dict, got: dict) -> float:
    """The share of values that are equal."""
    same = sum(int(np.sum(np.asarray(ref[k]) == np.asarray(got[k])))
               for k in ref)
    return same / sum(np.asarray(v).size for v in ref.values())


# --------------------------------------------------------------------------- #
# pallas2: one family half-step
# --------------------------------------------------------------------------- #


def _z_t(psi: dict) -> dict:
    """psi slabs between the natural and the Pallas (x, z-slab, y) layout
    of the z slabs."""
    return {k: (np.ascontiguousarray(np.transpose(v, (0, 2, 1)))
                if k.split("|")[1] == "2" else v) for k, v in psi.items()}


@pytest.mark.parametrize("family", ["E", "H"])
def test_family_update_matches_pallas_interpret(family, monkeypatch):
    """One half-step of the Lorentz case (x-PML, PEC and PMC walls,
    per-cell coefficients, a pole): the port's plain family update in bf16
    against ``PallasStepper.family_update`` in interpret mode in bf16,
    with the x-CPML pass that follows it."""
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "pallas2_interpret")
    plan = lower(DISPERSIVE["lorentz_mixed"]())
    jr = JaxRunner(plan, precision="bfloat16")
    assert jr.pallas is not None and jr.dtype == jnp.bfloat16
    port = FDTDRunner(plan, device="cpu", precision="bfloat16",
                      kernel="pallas2")
    assert port.storage == (BF16, BF16, BF16)
    rng = np.random.default_rng(31)
    st = _bf16(random_state(rng, port.shape, port.psi_shapes(),
                            port.consts["pole_scalars"]))
    new_e = _bf16({c: rng.standard_normal(port.shape).astype(np.float32)
                   for c in ("Ex", "Ey", "Ez")})
    ref_st = _jnp(dict(st, psi=_z_t(st["psi"]), mon=[]))

    def fn(s, c, ne):
        return jr._update_field_family(0, s, c, family, newE=ne)

    fields, psi = jax.jit(fn)(ref_st, jax.device_put(jr.consts),
                              _jnp(new_e) if family == "H" else None)
    ref = _flat({"E": _rounded(fields), "psi": _z_t(_rounded(psi))})

    state = convert.state_from_reference(st, port)
    assert state["E"]["Ex"].dtype == BF16
    src = state["H"] if family == "E" else {
        c: torch.from_numpy(v).to(BF16) for c, v in new_e.items()}
    got_f, got_p = step_kernels.family_update_reference(
        family, state, port.consts, src, port.meta)
    assert {v.dtype for v in list(got_f.values()) + list(got_p.values())} \
        == {BF16}
    got = _flat(convert.state_to_reference(
        {"E": got_f, "H": {}, "psi": got_p}))
    _report(f"family {family} vs pallas2_interpret", _errors(ref, got))
    # away from the x-PML slabs both round once, at the store
    w_lo, w_hi = port.pml_meta[("dual" if family == "E" else "primal", 0)]
    inner = slice(w_lo, port.shape[0] - w_hi)
    _report(f"family {family} outside the x slabs", _errors(
        {k: v[inner] for k, v in ref.items() if k.startswith("E:")},
        {k: v[inner] for k, v in got.items() if k.startswith("E:")}),
        TOL_SAME)


# --------------------------------------------------------------------------- #
# fused: one whole step
# --------------------------------------------------------------------------- #


def test_fused_step_matches_fused_interpret(monkeypatch):
    """One step of the Lorentz case on the fused tier (the kernel's plain
    version, the H sources, the pole update) in bf16 against the JAX
    package's fused tier in interpret mode in bf16: fields, psi and pole
    currents as each stores them."""
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "fused_interpret")
    plan = lower(DISPERSIVE["lorentz_mixed"]())
    jr = JaxRunner(plan, precision="bfloat16")
    assert jr.fused is not None and not jr.fused.fixup_ok
    port = FDTDRunner(plan, device="cpu", precision="bfloat16",
                      kernel="fused")
    assert port._waveforms[:, STEP].any(), "source off at the test step"
    rng = np.random.default_rng(37)
    st = _bf16(random_state(rng, port.shape, port.psi_shapes(),
                            port.consts["pole_scalars"]))
    out = jax.jit(lambda s, c: jr._step(STEP, s, c))(
        _jnp(dict(st, psi=_z_t(st["psi"]), mon=[])),
        jax.device_put(jr.consts))
    assert out["E"]["Ex"].dtype == jnp.bfloat16
    ref = _flat(dict(_np(out), psi=_z_t(_np(out["psi"]))))
    before = fused_kernels.LAUNCHES
    got = port.step(STEP, convert.state_from_reference(st, port))
    assert fused_kernels.LAUNCHES == before
    assert got["Q"][0]["Ex"][0].dtype == BF16
    got = _flat(convert.state_to_reference(got))
    _report("fused step vs fused_interpret", _errors(ref, got))


# --------------------------------------------------------------------------- #
# kstep: one group in each storage combination
# --------------------------------------------------------------------------- #


def _round_psi(psi: dict, dtype, axes=("0", "1", "2")) -> dict:
    return {k: (np.asarray(jnp.asarray(v).astype(dtype), np.float32)
                if k.split("|")[1] in axes else np.asarray(v))
            for k, v in psi.items()}


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_kstep_group_storage_combinations(combo, monkeypatch):
    """One k = 2 group of the 3-pole all-PML case from a random state in
    each storage combination: the port's plain group against the JAX
    package's float32 step taken twice with the k-step kernel's rounding
    (x and y psi after the first substep, everything at the group's end);
    fields, psi and pole currents."""
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "xla")
    prec = _combo(monkeypatch, combo)
    plan = lower(DISPERSIVE["lorentz3_pml"]())
    port = FDTDRunner(plan, device="cpu", precision=prec, kernel="kstep")
    field, psi_dt, q_dt = port.storage
    want = {"f32": (F32, F32, F32), "psi": (F32, BF16, F32),
            "q": (F32, F32, BF16), "psi_q": (F32, BF16, BF16),
            "bf16": (BF16, BF16, BF16)}[combo]
    assert (field, psi_dt, q_dt) == want
    assert all(w for w in port.pml_meta.values())
    jdt = {F32: jnp.float32, BF16: jnp.bfloat16}
    rng = np.random.default_rng(41)
    raw = random_state(rng, port.shape, port.psi_shapes(),
                       port.consts["pole_scalars"])
    st = {"E": raw["E"], "H": raw["H"], "psi": raw["psi"], "Q": raw["Q"]}
    if field == BF16:
        st["E"], st["H"] = _bf16(raw["E"]), _bf16(raw["H"])
    if psi_dt == BF16:
        st["psi"] = _bf16(raw["psi"])
    if q_dt == BF16:
        st["Q"] = _bf16(raw["Q"])

    jr = JaxRunner(plan)
    step = jax.jit(lambda s, c, t: jr._step(t, s, c))
    consts = jax.device_put(jr.consts)
    cur = _jnp(dict(st, mon=[]), jnp.float32)
    for t in (STEP, STEP + 1):
        cur = _np(step(cur, consts, t))
        cur["psi"] = _round_psi(cur["psi"], jdt[psi_dt], axes=("0", "1"))
        cur = _jnp(dict(cur, mon=[]), jnp.float32)
    cur = _np(cur)
    ref = _flat({"E": _rounded(cur["E"], jdt[field]),
                 "H": _rounded(cur["H"], jdt[field]),
                 "psi": _round_psi(cur["psi"], jdt[psi_dt]),
                 "Q": _rounded(cur["Q"], jdt[q_dt])})

    state = convert.state_from_reference(st, port)
    got = kstep_kernels.kstep_group(state, port.consts, port.meta,
                                    port.tables, STEP, 2)
    assert step_kernels.storage_of(got) == want
    got = _flat(convert.state_to_reference(got))
    errs = _errors(ref, got)
    _report(f"kstep group {combo}, equal share "
            f"{_equal_share(ref, got):.4f}", errs, TOL_SAME)


# --------------------------------------------------------------------------- #
# whole runs against the JAX tiers in interpret mode
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("tier", ["fused", "pallas2"])
def test_lorentz_run_matches_interpret(tier, monkeypatch):
    """The Lorentz half-space of ``test_torch_fused._interp_sim`` (the JAX
    fused tier with its x-CPML pass), a whole bf16 run: raw monitors
    against the same JAX tier in interpret mode."""
    monkeypatch.delenv("TIDY3D_TPU_TILE_QUANTA", raising=False)
    monkeypatch.setenv("TIDY3D_TPU_PAD_ALIGN", "0")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", f"{tier}_interpret")
    plan = lower(_interp_sim())
    jr = JaxRunner(plan, precision="bfloat16")
    assert (jr.fused is not None) == (tier == "fused")
    ref = jr.run()
    port = FDTDRunner(plan, device="cpu", precision="bfloat16", kernel=tier)
    got = port.run()
    assert port.steps_run == jr.steps_run
    err = _raw_err(ref, got)
    print(f"[bf16] {tier} run vs {tier}_interpret, {port.steps_run} "
          f"steps: raw monitors {err:.2e}")
    assert err <= TOL_BF16


def _cube(case: str, run_time: float = 4e-15):
    """The 32-cell cubes of ``tests/test_solver/test_kstep.py::_build`` in
    the port's schema (an 8-layer PML outside them: 48^3 cells; a 1-pole
    Lorentz half-domain, or Bloch x and y with a dielectric box and 32 x 32
    x 48 cells), with a field-time monitor on a plane through the dipole
    sampled at the ends of 2-step groups."""
    dl, n = 0.05, 32
    structures = []
    bspec = tt.BoundarySpec.all_sides(tt.PML(num_layers=8))
    if case == "dispersive":
        structures = [tt.Structure(
            geometry=tt.Box(center=(0, 0, 0.4), size=(1.6, 1.6, 0.8)),
            medium=tt.Lorentz(eps_inf=2.0,
                              coeffs=[(8.0, FREQ0 * 1.8, FREQ0 / 10)]))]
    else:
        bspec = tt.BoundarySpec(
            x=tt.Boundary.bloch(bloch_vec=0.31),
            y=tt.Boundary.bloch(bloch_vec=-0.17),
            z=tt.Boundary.pml(num_layers=8))
        structures = [tt.Structure(
            geometry=tt.Box(center=(0.2, -0.1, 0), size=(0.7, 0.6, 0.5)),
            medium=tt.Medium(permittivity=4.0))]
    sim = tt.Simulation(
        center=(0, 0, 0), size=(n * dl,) * 3, run_time=run_time,
        sources=[tt.PointDipole(
            center=(0, 0, 0), polarization="Ez",
            source_time=tt.GaussianPulse(freq0=FREQ0, fwidth=FREQ0 / 5))],
        structures=structures, boundary_spec=bspec,
        grid_spec=tt.GridSpec.uniform(dl=dl), shutoff=0.0)
    dt = lower(sim).dt
    return sim.copy(update=dict(monitors=[tt.FieldTimeMonitor(
        center=(0, 0, 0), size=(tt.inf, tt.inf, 0), start=0.5 * dt,
        interval=2, name="time")]))


@pytest.mark.parametrize("case,combo", [("dispersive", "bf16"),
                                        ("dispersive", "q"),
                                        ("bloch", "bf16")])
def test_kstep_run_matches_kstep_interpret(case, combo, monkeypatch):
    """The dispersive and Bloch cubes, a whole run at k = 2 (about 40
    steps): raw monitors (E and H on a plane every group) of the port's
    kstep tier against the JAX k-step kernel in interpret mode, at the same
    storage types."""
    monkeypatch.delenv("TIDY3D_TPU_TILE_QUANTA", raising=False)
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "kstep_interpret")
    monkeypatch.setenv("TIDY3D_TPU_KSTEP", "2")
    prec = _combo(monkeypatch, combo)
    plan = lower(_cube(case))
    jr = JaxRunner(plan, precision=prec)
    assert jr.kstep is not None and jr.kstep.k == 2
    ref = jr.run()
    port = FDTDRunner(plan, device="cpu", precision=prec)
    assert port.tier == "kstep" and port.k == 2
    assert [str(d).removeprefix("torch.") for d in port.storage] == [
        jnp.dtype(d).name
        for d in (jr.dtype, jr.kstep.psi_dtype, jr.kstep.q_dtype)]
    got = port.run()
    assert port.steps_run == jr.steps_run
    err = _raw_err(ref, got)
    print(f"[bf16] kstep run {case} {combo} vs kstep_interpret, "
          f"{port.steps_run} steps: raw monitors {err:.2e}")
    assert err <= TOL_BF16


# --------------------------------------------------------------------------- #
# shards, checkpoints, memory, convert, the log line
# --------------------------------------------------------------------------- #


def _lorentz_24(monitors=None):
    """The Lorentz case grown to 24 x planes (2 shards of 12 hold its x-PML
    slabs)."""
    from tests.test_torch_checkpoint import _grown, _monitors

    return _grown(DISPERSIVE["lorentz_mixed"](
        monitors=monitors if monitors is not None else _monitors(),
        run_time=3e-15))


def test_sharded_bf16_matches_unsharded():
    """A whole bf16 run over 2 virtual x-shards of the CPU against the
    unsharded bf16 run: raw monitors."""
    from tidy3d_tpu_torch.solver.lowering import lower as port_lower

    plan = port_lower(_lorentz_24())
    ref = FDTDRunner(plan, device="cpu", precision="bfloat16",
                     kernel="kstep")
    mesh, _ = make_mesh(devices=["cpu"] * 2)
    run = FDTDRunner(plan, device="cpu", precision="bfloat16",
                     sharding_plan=ShardingPlan(mesh, plan.shape))
    assert run.tier_name == "kstep (k=2, 2 x-shards)"
    st = run.init_state()["shards"][0]
    assert {v.dtype for v in st["E"].values()} == {BF16}
    got, want = run.run(), ref.run()
    err = _raw_err(want, got)
    print(f"[bf16] 2 x-shards vs unsharded: raw monitors {err:.2e}")
    assert err <= TOL_BF16


def test_bf16_checkpoint_resumes_exactly_and_refuses_other_types(
        tmp_path, monkeypatch):
    """Half a bf16 run, saved; a fresh runner resumes it; the raw monitors
    equal the uninterrupted run's bit for bit. The file holds the bf16 bits
    and the storage types: a float32 run refuses it, and a bf16 run refuses
    a float32 file."""
    from tidy3d_tpu_torch.solver.lowering import lower as port_lower

    monkeypatch.setenv("TIDY3D_TPU_Q_DTYPE", "bfloat16")
    plan = port_lower(DISPERSIVE["lorentz_mixed"](
        monitors=_lorentz_24().monitors, run_time=3e-15))
    full = FDTDRunner(plan, device="cpu", precision="bfloat16",
                      kernel="kstep").run()
    half = FDTDRunner(plan, device="cpu", precision="bfloat16",
                      kernel="kstep")
    size, chunks = half.chunking()
    state = half.run_steps(0, size * (chunks // 2), half.init_state())
    path = str(tmp_path / "bf16.npz")
    half.save_checkpoint(path, state, chunks // 2, 1.0, 1.0)
    with np.load(path) as data:
        assert data["E.Ex"].dtype == np.int16
        assert list(data["__storage__"]) == ["bfloat16"] * 3
    resumed = FDTDRunner(plan, device="cpu", precision="bfloat16",
                         kernel="kstep").run_checkpointed(path)
    for idx in full:
        for comp, v in full[idx].items():
            assert np.array_equal(v, resumed[idx][comp]), (idx, comp)
    half.save_checkpoint(path, state, chunks // 2, 1.0, 1.0)
    with pytest.raises(SetupError, match="storage"):
        FDTDRunner(plan, device="cpu", kernel="kstep").load_checkpoint(path)
    f32 = FDTDRunner(plan, device="cpu", kernel="kstep")
    f32.save_checkpoint(path, f32.init_state(), 1, 1.0, 1.0)
    with pytest.raises(SetupError, match="storage"):
        half.load_checkpoint(path)


def test_memory_gate_admits_bf16_where_it_refuses_float32(monkeypatch):
    """``estimate_device_memory`` counts the state at its element sizes:
    under a limit between the bf16 and the float32 estimate the float32
    run is refused and the bf16 run admitted, on every tier."""
    from tidy3d_tpu_torch.solver.lowering import lower as port_lower

    plan = port_lower(DISPERSIVE["lorentz_mixed"]())
    for tier in ("kstep", "fused", "pallas2"):
        monkeypatch.delenv("TIDY3D_TPU_HBM_BYTES", raising=False)
        f32 = FDTDRunner(plan, device="cpu", kernel=tier)
        bf16 = FDTDRunner(plan, device="cpu", precision="bfloat16",
                          kernel=tier)
        e32, e16 = (r.estimate_device_memory() for r in (f32, bf16))
        # no monitor: the whole state halves
        assert 2 * e16["state"] == e32["state"], tier
        assert e16["total"] < e32["total"]
        monkeypatch.setenv("TIDY3D_TPU_HBM_BYTES",
                           str((e16["total"] + e32["total"]) // 2))
        with pytest.raises(SetupError, match="device limit"):
            f32.check_memory_budget()
        assert bf16.check_memory_budget()["total"] == e16["total"]


def test_convert_carries_bf16_exactly():
    """A JAX bf16 state carried to a bf16 runner and back is equal bit for
    bit, and so is a port bf16 state carried out and back in."""
    from tidy3d_tpu_torch.solver.lowering import lower as port_lower

    plan = port_lower(DISPERSIVE["lorentz_mixed"]())
    port = FDTDRunner(plan, device="cpu", precision="bfloat16",
                      kernel="kstep")
    st = random_state(np.random.default_rng(43), port.shape,
                      port.psi_shapes(), port.consts["pole_scalars"])
    jst = _jnp(st)
    state = convert.state_from_reference(_np(jst), port)
    assert step_kernels.storage_of(state) == (BF16, BF16, BF16)
    back = convert.state_to_reference(state)
    assert _equal_share(_flat(_np(jst)), _flat(back)) == 1.0
    again = convert.state_from_reference(back, port)
    for key, v in _flat(convert.state_to_reference(again)).items():
        assert np.array_equal(v, _flat(back)[key])
    mesh, _ = make_mesh(devices=["cpu"] * 2)
    plan24 = port_lower(_lorentz_24())
    sharded = FDTDRunner(plan24, device="cpu", precision="bfloat16",
                         sharding_plan=ShardingPlan(mesh, plan24.shape))
    gst = random_state(np.random.default_rng(44), sharded.shape,
                       sharded.psi_shapes(),
                       sharded.host_consts["pole_scalars"])
    shards = convert.shard_states_from_reference(_bf16(gst), sharded)
    assert {v.dtype for v in shards[0]["E"].values()} == {BF16}
    joined = convert.shard_states_to_reference(shards, sharded)
    assert _equal_share(_flat(_bf16(gst)), _flat(joined)) == 1.0


def test_kernel_tier_line_names_the_storage_types(monkeypatch):
    """``web.run``'s ``kernel tier:`` line names the storage types in use:
    bf16 fields, psi and Q on a one-step tier under
    ``TIDY3D_TPU_PRECISION``; on the kstep tier the knobs' types."""
    sim = DISPERSIVE["lorentz_mixed"](monitors=[tt.FluxMonitor(
        center=(0, 0, 0), size=(0.3, 0.25, 0.4), freqs=[FREQ0],
        name="flux")], run_time=3e-15)
    monkeypatch.setenv("TIDY3D_TPU_PRECISION", "bfloat16")
    data = tt.web.run(sim, device="cpu", verbose=False)
    assert data.log.splitlines()[-1] == (
        "kernel tier: fused [storage: fields bfloat16, psi bfloat16, "
        "Q bfloat16]")
    assert np.all(np.isfinite(data["flux"].flux.values))
    monkeypatch.setenv("TIDY3D_TPU_PRECISION", "float32")
    monkeypatch.setenv("TIDY3D_TPU_Q_DTYPE", "bfloat16")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "kstep")
    data = tt.web.run(sim, device="cpu", verbose=False)
    assert data.log.splitlines()[-1] == (
        "kernel tier: kstep (k=2) [storage: fields float32, psi float32, "
        "Q bfloat16]")


# --------------------------------------------------------------------------- #
# kernels against their plain versions in bf16, on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _card_state(port, seed):
    st = random_state(np.random.default_rng(seed), port.shape,
                      port.psi_shapes(), port.consts["pole_scalars"])
    return convert.state_from_reference(_bf16(st), port)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(DISPERSIVE))
def test_family_and_fused_kernels_match_plain(case, cuda):
    """The bf16 family and fused kernels against their plain versions on
    the same bf16 state."""
    from tidy3d_tpu_torch.solver.lowering import lower as port_lower

    plan = port_lower(DISPERSIVE[case]())
    port = FDTDRunner(plan, device=cuda, precision="bfloat16",
                      kernel="fused")
    state = _card_state(port, 5)
    for fam in ("E", "H"):
        src = state["H"] if fam == "E" else state["E"]
        outs = [fn(fam, state, port.consts, src, port.meta)
                for fn in (step_kernels.family_update,
                           step_kernels.family_update_reference)]
        got, ref = (_flat(convert.state_to_reference(
            {"E": f, "H": {}, "psi": p})) for f, p in outs)
        _report(f"{case} family {fam} kernel vs plain", _errors(ref, got))
    src = port.step_sources("E", STEP)
    outs = [fn(state, port.consts, port.meta, src)
            for fn in (fused_kernels.fused_step,
                       fused_kernels.fused_step_reference)]
    got, ref = (_flat(convert.state_to_reference(
        {"E": e, "H": h, "psi": p, "Q": q})) for e, h, p, q in outs)
    _report(f"{case} fused kernel vs plain", _errors(ref, got))


@pytest.mark.gpu
@pytest.mark.parametrize("combo", sorted(COMBOS))
@pytest.mark.parametrize("case", ["lorentz3_pml", "gold_halfspace"])
def test_kstep_kernel_matches_plain(case, combo, cuda, monkeypatch):
    """One bf16 k-step group, kernel against plain, in each storage
    combination."""
    from tidy3d_tpu_torch.solver.lowering import lower as port_lower

    prec = _combo(monkeypatch, combo)
    port = FDTDRunner(port_lower(DISPERSIVE[case]()), device=cuda,
                      precision=prec, kernel="kstep")
    state = _card_state(port, 7)
    outs = []
    for fn in (kstep_kernels.kstep_group,
               kstep_kernels.kstep_group_reference):
        before = kstep_kernels.LAUNCHES
        new = fn(state, port.consts, port.meta, port.tables, STEP, 2)
        torch.cuda.synchronize()
        assert kstep_kernels.LAUNCHES == before + (
            fn is kstep_kernels.kstep_group)
        assert step_kernels.storage_of(new) == port.storage
        outs.append(_flat(convert.state_to_reference(new)))
    _report(f"{case} {combo} kstep kernel vs plain, equal share "
            f"{_equal_share(outs[1], outs[0]):.4f}", _errors(outs[1],
                                                             outs[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["tiled_pec_pmc", "tiled_lorentz8",
                                  "tiled_bloch"])
def test_kstep_bulk_and_shell_blocks_match_plain(case, cuda):
    """One bf16 group on grids of 3 or more blocks per axis: the bulk
    blocks stage level 0 in bf16 pairs (by ``cp.async`` where nz is even,
    70 here; two values at a time where it is odd, 67 in
    ``tiled_lorentz8``; both copies of the Bloch case), the shell blocks
    value by value; kernel against plain."""
    from tidy3d_tpu_torch.solver.lowering import lower as port_lower

    from tests.torch_cases import TILED

    port = FDTDRunner(port_lower(TILED[case]()), device=cuda,
                      precision="bfloat16", kernel="kstep")
    ncopy = 2 if port.is_complex else 1
    bulk, shell = kstep_kernels.block_lists(port.meta, 2, ncopy, cuda)
    assert bulk.numel() > 0 and shell.numel() > 0
    assert (port.shape[2] % 2 == 1) == (case == "tiled_lorentz8")
    st = random_state(np.random.default_rng(9), port.shape,
                      port.psi_shapes(), port.consts["pole_scalars"])
    if port.is_complex:
        im = random_state(np.random.default_rng(10), port.shape,
                          port.psi_shapes())
        st.update(E1=im["E"], H1=im["H"], psi1=im["psi"])
    state = convert.state_from_reference(_bf16(st), port)
    outs = []
    for fn in (kstep_kernels.kstep_group,
               kstep_kernels.kstep_group_reference):
        new = fn(state, port.consts, port.meta, port.tables, STEP, 2)
        torch.cuda.synchronize()
        flat = _flat(convert.state_to_reference(new))
        for fam in ("E1", "H1", "psi1"):
            flat.update({f"{fam}:{k}": v.float().cpu().numpy()
                         for k, v in new.get(fam, {}).items()})
        outs.append(flat)
    _report(f"{case} bf16 kstep kernel vs plain, equal share "
            f"{_equal_share(outs[1], outs[0]):.4f}", _errors(outs[1],
                                                             outs[0]))
