"""Sharded runs of the port on bricks (the ``pallas2`` tier over any
``(dx, dy, dz)`` decomposition) against the JAX package and the port's
unsharded runs.

On the CPU every brick is a virtual one (the mesh names the CPU several
times) and steps with the plain version of the family update in its
brick-local halo mode. Held here: whole brick runs against the JAX
package (raw monitors to 2e-5 of the largest magnitude, bf16 to 1e-2):
against its own GSPMD run of the same decomposition on the eight host
devices of ``tests/conftest.py`` where its placement takes the grid (every
axis a multiple of its split), against its unsharded XLA run (the same
XLA step; its own ``test_sharding.py`` holds the two equal) where the
case is about the route rather than the layout, or the split is uneven
(its ``device_put`` refuses an axis that does not divide); and against the
port's unsharded ``pallas2`` run in every case. One family update per
brick, from one random global state, against the unsharded update on it
(1e-6); the halo exchange, Bloch mix included; the route choice; resume;
``web.run`` under ``TIDY3D_TPU_SHARD``; the memory estimate.

The kernel tests at the end need a CUDA card and skip without one.
"""

import numpy as np
import pytest
import torch

import tidy3d_tpu_torch as tt
from tidy3d_tpu_torch import convert
from tidy3d_tpu_torch.solver.fdtd import (
    FDTDRunner, count_sources, select_tier,
)
from tidy3d_tpu_torch.solver.kernels import fused as fused_kernels
from tidy3d_tpu_torch.solver.kernels import kstep as kstep_kernels
from tidy3d_tpu_torch.solver.kernels import post_e as post_e_kernels
from tidy3d_tpu_torch.solver.kernels import step as step_kernels
from tidy3d_tpu_torch.solver.lowering import lower
from tidy3d_tpu_torch.solver.sharding import (
    Bricks, ShardingPlan, make_mesh, split_sizes,
)

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    BLOCH, DISPERSIVE, SIMS, lower_reference, max_rel_err, monitors,
    random_state,
)
from tests.test_torch_fused import _interp_sim
from tests.test_torch_many_poles import stack_sim
from tests.test_torch_nonlinear import nl_sim
from tests.test_torch_sharded import _dft_monitors, _raw_err, sized
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner
from tidy3d_tpu.solver import sharding as ref_sharding

TOL_RUN = 2e-5      # raw monitors, the reference's bar for sharded runs
TOL_BF16 = 1e-2
TOL_UPDATE = 1e-6   # one family update from the same state
RUN_TIME = 4e-15    # 40-odd steps through the source pulse


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    for key in ("TIDY3D_TPU_KSTEP", "TIDY3D_TPU_SHARD",
                "TIDY3D_TPU_SHARDED_KSTEP", "TIDY3D_TPU_COORDINATOR",
                "TIDY3D_TPU_PRECISION", "TIDY3D_TPU_PAD_ALIGN"):
        monkeypatch.delenv(key, raising=False)


def bricks(plan, decomp, device="cpu", **kw) -> FDTDRunner:
    """A runner over virtual bricks of ``device`` (the tier from the
    environment unless ``kernel`` is given)."""
    mesh, _ = make_mesh(devices=[device] * int(np.prod(decomp)),
                        decomp=decomp)
    return FDTDRunner(plan, device=device,
                      sharding_plan=ShardingPlan(mesh, plan.shape), **kw)


def gspmd(plan, decomp, precision=None) -> dict:
    """The JAX package's GSPMD run of ``plan`` over ``decomp`` of its
    eight host devices."""
    mesh, _ = ref_sharding.make_mesh(int(np.prod(decomp)), decomp=decomp)
    return JaxRunner(plan, precision=precision,
                     sharding_plan=ref_sharding.ShardingPlan(
                         mesh, plan.shape)).run()


def _pml(nx=20, mons=None):
    return sized(SIMS["pml_all"](monitors=monitors() if mons is None
                                 else mons, run_time=RUN_TIME), nx)


def _bloch():
    return sized(BLOCH["bloch_dipole"](monitors=monitors(),
                                       run_time=RUN_TIME), 12)


# name: (simulation, decomposition, environment, JAX reference, the
# reason the x-slab route refuses it)
RUNS = {
    "pml_2x2x1": (_pml, (2, 2, 1), {}, "gspmd", "mixed 2D/3D"),
    "pml_1x2x2": (_pml, (1, 2, 2), {}, "gspmd", "mixed 2D/3D"),
    "pml_2x2x2": (_pml, (2, 2, 2), {}, "gspmd", "mixed 2D/3D"),
    "uneven_2x1x1": (lambda: _pml(19, _dft_monitors()), (2, 1, 1), {},
                     "xla", "do not split into 2 equal shards"),
    "cone_4x1x1": (lambda: _pml(20, _dft_monitors()), (4, 1, 1), {}, "xla",
                   "x-PML slab of 4 planes"),
    "thin_4x1x1": (lambda: sized(SIMS["periodic"](
        monitors=_dft_monitors(), run_time=RUN_TIME), 12), (4, 1, 1), {},
        "xla", "shards of 3 planes"),
    "kstep_off_4x1x1": (lambda: _pml(24, _dft_monitors()), (4, 1, 1),
                        {"TIDY3D_TPU_SHARDED_KSTEP": "0"}, "xla",
                        "SHARDED_KSTEP=0"),
    "time_monitor_4x1x1": (lambda: _pml(24), (4, 1, 1), {}, "xla",
                           "does not sample at the ends"),
    "kerr_tpa_2x1x1": (lambda: nl_sim("kerr_tpa_1"), (2, 1, 1), {}, "xla",
                       "nonlinear"),
    "modulated_1x2x1": (lambda: nl_sim("both_box"), (1, 2, 1), {}, "xla",
                        "modulated"),
    "13_slots_2x2x1": (lambda: stack_sim(13), (2, 2, 1), {}, "xla",
                       "mixed 2D/3D"),
    "bloch_2x1x1": (_bloch, (2, 1, 1), {}, "gspmd", "sharded Bloch"),
    "bloch_2x2x1": (_bloch, (2, 2, 1), {}, "gspmd", "sharded Bloch"),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_brick_run_matches_jax_and_unsharded(name, monkeypatch):
    make, decomp, env, ref_kind, why = RUNS[name]
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    sim = make()
    plan = lower(sim)
    run = bricks(plan, decomp)
    assert run.tier_name == f"pallas2 ({'x'.join(map(str, decomp))} bricks)"
    # the x-slab route refuses it for the reason the case is about
    with pytest.raises((ValueError, NotImplementedError), match=why):
        bricks(plan, decomp, kernel="kstep")
    got = run.run()
    ref_plan = lower_reference(sim)
    ref = gspmd(ref_plan, decomp) if ref_kind == "gspmd" \
        else JaxRunner(ref_plan).run()
    err = _raw_err(ref, got)
    own = FDTDRunner(plan, device="cpu", kernel="pallas2").run()
    err_own = _raw_err(own, got)
    print(f"{name}: bricks vs JAX {ref_kind} {err:.2e}, vs unsharded "
          f"pallas2 {err_own:.2e}")
    assert err <= TOL_RUN, f"{name}: vs JAX {ref_kind} rel err {err:.2e}"
    assert err_own <= TOL_RUN, f"{name}: vs unsharded rel err {err_own:.2e}"


def test_bf16_brick_run_matches_gspmd_and_unsharded():
    """bf16 storage in (2, 2, 1) bricks: on the Lorentz half-space of the
    bf16 tests (``test_torch_fused._interp_sim``) against the JAX
    package's GSPMD run at bf16 (1e-2), and bit-equal to the port's
    unsharded bf16 run (the same roundings, cell for cell), there and on
    ``pml_all``. (On ``pml_all`` the port's bf16 ``pallas2`` tier, bricks
    and unsharded alike, reads 1.4e-2 from the JAX XLA tier at bf16 and
    1.5e-2 from its ``pallas2`` tier in interpret mode: a spread of the
    tiers' roundings on that case, which CHANGES.md records.)"""
    sim = _interp_sim()
    plan = lower(sim)
    run = bricks(plan, (2, 2, 1), precision="bfloat16")
    assert run.dtype == torch.bfloat16
    got = run.run()
    ref = gspmd(lower_reference(sim), (2, 2, 1), precision="bfloat16")
    err = _raw_err(ref, got)
    print(f"bf16 bricks vs JAX gspmd {err:.2e}")
    assert err <= TOL_BF16
    for plan in (plan, lower(_pml(mons=_dft_monitors()))):
        own = FDTDRunner(plan, device="cpu", kernel="pallas2",
                         precision="bfloat16").run()
        got = bricks(plan, (2, 2, 1), precision="bfloat16").run()
        assert _raw_err(own, got) == 0.0


# --------------------------------------------------------------------------- #
# the layout, the exchange and one family update
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n,parts", [(19, 2), (20, 4), (12, 4), (7, 7),
                                     (22, 3)])
def test_splits_are_array_splits(n, parts):
    want = [len(a) for a in np.array_split(np.arange(n), parts)]
    assert split_sizes(n, parts) == want
    lay = Bricks((n, 3, 4), (parts, 1, 1), (False, False, False))
    starts = [lay.origin(s)[0] for s in range(parts)]
    assert starts == list(np.cumsum([0] + want[:-1]))


@pytest.mark.parametrize("side", [0, 1])
def test_exchange_fills_halos_with_the_bloch_mix(side):
    """Each halo plane takes its neighbour's core plane; across the wall of
    a decomposed axis with a Bloch phase it takes ``_wrap_col``'s mix of
    the two copies (copy 0 ``c F0 + s F1`` lo, ``c F0 - s F1`` hi; copy 1
    the opposite signs)."""
    shape, decomp = (5, 6, 4), (2, 3, 1)
    lay = Bricks(shape, decomp, (True, False, True))
    rng = np.random.default_rng(5)
    glob = [{"Ex": rng.standard_normal(shape).astype(np.float32)}
            for _ in range(2)]
    fields = [[{"Ex": torch.from_numpy(lay.take(g["Ex"], s))} for g in glob]
              for s in range(lay.n)]
    halos = [[{a: {"Ex": torch.full(lay.halo_shape(s, a), np.nan)}
               for a in range(3) if lay.halo(s)[a][side]} for _ in range(2)]
             for s in range(lay.n)]
    cs = (0.8, 0.6)
    lay.exchange(fields, halos, side, (cs, None, None))
    for s in range(lay.n):
        org, ext = lay.origin(s), lay.extent(s)
        for a in range(3):
            if not lay.halo(s)[a][side]:
                continue
            g = org[a] - 1 if side == 0 else org[a] + ext[a]
            wraps = not 0 <= g < shape[a]
            cut = list(lay.owned_slices(s))
            cut[a] = slice(g % shape[a], g % shape[a] + 1)
            for p in range(2):
                want = glob[p]["Ex"][tuple(cut)]
                if wraps and a == 0:
                    other = glob[1 - p]["Ex"][tuple(cut)]
                    sgn = (1 if p == 0 else -1) * (1 if side == 0 else -1)
                    want = cs[0] * want + sgn * cs[1] * other
                np.testing.assert_allclose(halos[s][p][a]["Ex"].numpy(),
                                           want, rtol=1e-6, atol=1e-6)
    # y is not periodic: its end bricks read no halo across the wall
    assert lay.halo(0)[1] == (False, True) and lay.halo(2)[1] == (True,
                                                                  False)


UPDATE_CASES = {"real": ("pml_all", (2, 2, 2)),
                "poles": ("lorentz_mixed", (1, 2, 2)),
                "bloch": ("bloch_dipole", (2, 2, 1))}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_brick_family_update_matches_unsharded(case):
    """Both families of every brick in halo mode (the plain version), from
    one random global state split into bricks, against the unsharded
    update on that state."""
    name, decomp = UPDATE_CASES[case]
    plan = lower({**SIMS, **DISPERSIVE, **BLOCH}[name]())
    ref = FDTDRunner(plan, device="cpu", kernel="pallas2")
    st = _random_global(ref, 3)
    run = bricks(plan, decomp)
    states = convert.shard_states_from_reference(st, run)
    back = convert.shard_states_to_reference(states, run)
    for key in ("E", "H", "psi"):
        for comp, arr in st[key].items():
            np.testing.assert_array_equal(back[key][comp], arr)
    worst = _update_errors(ref, run, convert.state_from_reference(st, ref),
                           states)
    assert worst <= TOL_UPDATE, f"{case}: rel err {worst:.2e}"


def _random_global(ref, seed):
    rng = np.random.default_rng(seed)
    st = random_state(rng, ref.shape, ref.psi_shapes(),
                      ref.consts["pole_scalars"])
    if ref.is_complex:
        st1 = random_state(rng, ref.shape, ref.psi_shapes(),
                           ref.consts["pole_scalars"])
        st.update(E1=st1["E"], H1=st1["H"], psi1=st1["psi"], Q1=st1["Q"])
    return st


def _update_errors(ref, run, state, states, kernel=False) -> float:
    """The E update and then the H update from its fields, of every brick
    against the unsharded one: the largest error over fields and psi,
    relative to the largest magnitude."""
    fn = step_kernels.family_update_copies if kernel \
        else step_kernels.family_update_copies_reference
    views = ref._views(state)
    wantE = fn("E", views, ref.consts, [v["H"] for v in views], ref.meta)
    wantH = fn("H", views, ref.consts, [e for e, _ in wantE], ref.meta)
    newE = []
    gotE = []
    for sh, st in zip(run.shards, states):
        vs = run._views(st)
        outs = fn("E", vs, sh.consts, [v["H"] for v in vs], sh.meta,
                  st["halo"]["H"])
        gotE.append(outs)
        newE.append([e for e, _ in outs])
    run.exchange_brick_halos(states, "H", newE)
    gotH = [fn("H", run._views(st), sh.consts, es, sh.meta,
               st["halo"]["E"])
            for sh, st, es in zip(run.shards, states, newE)]
    worst = 0.0
    for want, got in ((wantE, gotE), (wantH, gotH)):
        for s, outs in enumerate(got):
            cut = run.layout.owned_slices(s)
            for (nf, npsi), (wf, wpsi) in zip(outs, want):
                ref_f = {c: wf[c][cut].float() for c in nf}
                worst = max(worst, max_rel_err(
                    {c: v.cpu().numpy() for c, v in ref_f.items()},
                    {c: v.float().cpu().numpy() for c, v in nf.items()}))
                for key, v in npsi.items():
                    pcut = convert._psi_cut(run, s, key)
                    a = wpsi[key][pcut].float().cpu().numpy()
                    b = v.float().cpu().numpy()
                    scale = float(np.max(np.abs(a))) + 1e-30
                    worst = max(worst, float(np.max(np.abs(a - b))) / scale)
    return worst


# --------------------------------------------------------------------------- #
# the route, resume, web.run and the memory estimate
# --------------------------------------------------------------------------- #


def test_route_choice(monkeypatch):
    """x-slab plans keep the k-step route and its log line; the rest take
    bricks; a forced kstep that refuses raises, a forced fused raises, a
    forced pallas2 takes bricks."""
    plan = lower(_pml(24, _dft_monitors()))
    n = count_sources(plan)
    assert select_tier(plan, n, "cpu", sharded=(4, 1, 1)) == ("kstep", 2)
    assert bricks(plan, (4, 1, 1)).tier_name == "kstep (k=2, 4 x-shards)"
    run = bricks(plan, (1, 2, 1))
    assert run.tier_name == "kstep (k=2, 2 x-shards)" and run._plan_rot == 1
    assert select_tier(plan, n, "cpu", "pallas2", sharded=(4, 1, 1)) == \
        ("pallas2", 1)
    assert bricks(plan, (4, 1, 1), kernel="xla").tier_name == \
        "pallas2 (4x1x1 bricks)"
    assert select_tier(plan, n, "cpu", sharded=(2, 2, 1)) == ("pallas2", 1)
    with pytest.raises(ValueError, match="no shard-local mode"):
        bricks(plan, (2, 2, 1), kernel="fused")
    with pytest.raises(NotImplementedError, match="mixed 2D/3D"):
        bricks(plan, (2, 2, 1), kernel="kstep")
    monkeypatch.setenv("TIDY3D_TPU_SHARDED_KSTEP", "0")
    assert select_tier(plan, n, "cpu", sharded=(4, 1, 1)) == ("pallas2", 1)
    monkeypatch.setenv("TIDY3D_TPU_SHARDED_KSTEP", "1")
    monkeypatch.setenv("TIDY3D_TPU_KSTEP", "0")
    assert select_tier(plan, n, "cpu", sharded=(4, 1, 1)) == ("pallas2", 1)


def test_brick_state_and_memory():
    """A brick holds its own cells and the parts of the psi slabs inside
    it; its halo planes are the only extra bytes, counted apart."""
    plan = lower(_pml(20))
    run = bricks(plan, (2, 2, 1))
    states = run.init_state()["shards"]
    for sh, st in zip(run.shards, states):
        assert tuple(st["E"]["Ex"].shape) == run.layout.extent(sh.index)
        assert set(st["halo"]["H"][0]) == {a for a in range(3)
                                           if sh.meta.halo[a][0]}
        for a, planes in st["halo"]["H"][0].items():
            assert set(planes) == {c for m, c in enumerate(("Hx", "Hy",
                                                            "Hz")) if m != a}
    # x psi: the lo slab in the bricks at x = 0, the hi slab at the end
    x_sides = [{key.split("|")[2] for key in st["psi"]
                if key.split("|")[1] == "0"} for st in states]
    assert x_sides == [{"lo"}, {"lo"}, {"hi"}, {"hi"}]
    est = run.estimate_device_memory()
    halo = sum(t.numel() * t.element_size() for st in states
               for _, t in _named_halos(st))
    assert est["halo"] == halo > 0
    whole = FDTDRunner(plan, device="cpu", kernel="pallas2")
    assert est["state"] == whole.estimate_device_memory()["state"]


def _named_halos(st):
    for fam in st["halo"].values():
        for copy in fam:
            for planes in copy.values():
                for comp, t in planes.items():
                    yield comp, t


def test_brick_resume_is_bit_equal(tmp_path):
    """Half of the chunks by hand, saved (``shards.i`` names, no halo
    planes), then a fresh runner resumes and ends bit-equal to the
    uninterrupted run; a file of another decomposition is refused."""
    plan = lower(nl_sim("kerr_tpa_1", run_time=2e-15))
    ref = bricks(plan, (2, 2, 1)).run()
    r1 = bricks(plan, (2, 2, 1))
    chunk, num_chunks = r1.chunking()
    state, max_ever, cur = r1.init_state(), 0.0, 0.0
    for ci in range(num_chunks // 2):
        state = r1.run_steps(ci * chunk, chunk, state)
        cur = float(r1._max_field(state))
        max_ever = max(max_ever, cur)
    ckpt = str(tmp_path / "bricks.npz")
    r1.save_checkpoint(ckpt, state, num_chunks // 2, max_ever, cur)
    with np.load(ckpt) as data:
        assert "shards.3.E.Ez" in data.files
        assert not any("halo" in name for name in data.files)
    with pytest.raises(tt.exceptions.SetupError, match="decomp"):
        bricks(plan, (1, 2, 2)).run_checkpointed(ckpt)
    out = bricks(plan, (2, 2, 1)).run_checkpointed(ckpt)
    for idx in ref:
        for comp, arr in ref[idx].items():
            np.testing.assert_array_equal(out[idx][comp], arr)


def test_web_run_on_bricks_matches_unsharded(monkeypatch):
    """``TIDY3D_TPU_SHARD=2,2`` through ``web.run`` on the CPU's repeated
    devices: the brick route, and the data of the unsharded run."""
    sim = _pml(mons=_dft_monitors())
    ref = tt.web.run(sim, device="cpu", verbose=False)
    monkeypatch.setenv("TIDY3D_TPU_SHARD", "2,2")
    got = tt.web.run(sim, device="cpu", verbose=False)
    assert "kernel tier: pallas2 (2x2x1 bricks)" in got.log
    for name, comps in (("flux", ("flux",)), ("field", ("Ex", "Ez", "Hy"))):
        for comp in comps:
            r = getattr(ref[name], comp).values
            g = getattr(got[name], comp).values
            assert r.shape == g.shape and np.any(r != 0)
            err = np.max(np.abs(g - r)) / np.max(np.abs(r))
            assert err <= TOL_RUN, f"{name}.{comp}: rel err {err:.2e}"


# --------------------------------------------------------------------------- #
# the halo mode of the family kernel on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


KERNEL_CASES = {
    "real": ("pml_all", (2, 2, 2), None),
    "poles": ("lorentz_mixed", (1, 2, 2), None),
    "bloch": ("bloch_dipole", (2, 2, 1), None),
    "many": ("many", (2, 2, 1), None),
    "bf16": ("pml_all", (2, 2, 2), "bfloat16"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_halo_kernel_matches_plain_and_unsharded(case, cuda):
    """Both families of every brick: the kernel's halo mode against its
    plain version on the same bricks and against the unsharded kernel."""
    name, decomp, precision = KERNEL_CASES[case]
    plan = lower(stack_sim(13) if name == "many" else
                 {**SIMS, **DISPERSIVE, **BLOCH}[name]())
    ref = FDTDRunner(plan, device=cuda, kernel="pallas2",
                     precision=precision)
    st = _random_global(ref, 7)
    run = bricks(plan, decomp, device=cuda, precision=precision)
    tol = TOL_BF16 if precision else TOL_UPDATE
    before = step_kernels.BRICK_LAUNCHES
    err_kernel = _update_errors(ref, run, convert.state_from_reference(
        st, ref), convert.shard_states_from_reference(st, run), kernel=True)
    torch.cuda.synchronize()
    assert step_kernels.BRICK_LAUNCHES - before == 2 * len(run.shards)
    run_p = bricks(plan, decomp, device=cuda, precision=precision,
                   use_kernel=False)
    states = convert.shard_states_from_reference(st, run_p)
    err_plain = 0.0
    for family in ("E", "H"):
        for sh, s in zip(run_p.shards, states):
            vs = run_p._views(s)
            srcs = [v["H" if family == "E" else "E"] for v in vs]
            halos = s["halo"]["H" if family == "E" else "E"]
            k = step_kernels.family_update_copies(family, vs, sh.consts,
                                                  srcs, sh.meta, halos)
            p = step_kernels.family_update_copies_reference(
                family, vs, sh.consts, srcs, sh.meta, halos)
            for (kf, kpsi), (pf, ppsi) in zip(k, p):
                err_plain = max(err_plain, max_rel_err(
                    {c: v.float().cpu().numpy() for c, v in pf.items()},
                    {c: v.float().cpu().numpy() for c, v in kf.items()}))
    print(f"{case}: halo kernel vs unsharded {err_kernel:.2e}, vs plain "
          f"{err_plain:.2e}")
    assert err_kernel <= tol and err_plain <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["kerr_tpa_2x1x1", "bloch_2x2x1",
                                  "13_slots_2x2x1", "pml_1x2x2"])
def test_brick_runner_on_the_card_matches_unsharded(name, cuda):
    make, decomp, _, _, _ = RUNS[name]
    plan = lower(make())
    ref = FDTDRunner(plan, device=cuda, kernel="pallas2").run()
    counts = (step_kernels.BRICK_LAUNCHES, kstep_kernels.LAUNCHES,
              fused_kernels.LAUNCHES, post_e_kernels.LAUNCHES)
    run = bricks(plan, decomp, device=cuda)
    got = run.run()
    torch.cuda.synchronize()
    brick, ks, fu, pe = (now - then for now, then in zip(
        (step_kernels.BRICK_LAUNCHES, kstep_kernels.LAUNCHES,
         fused_kernels.LAUNCHES, post_e_kernels.LAUNCHES), counts))
    assert brick == 2 * len(run.shards) * run.steps_run
    assert ks == fu == 0
    if plan.nonlinear is not None:
        assert pe == len(run.shards) * run.steps_run
    assert _raw_err(ref, got) <= TOL_RUN
