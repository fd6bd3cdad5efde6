"""The family kernel's halo mode over every brick of a device in one call.

A sharded ``pallas2`` run updates a family of all its bricks (each brick's
copies too) in one call of ``t3d_family_update_bricks`` per device, from a
table that ``step.plan_bricks`` plans from the bricks' ``StepMeta`` alone:
each entry's tile grid, its bulk box and its first block in the bulk and
the shell launch. A brick's halo sides are no walls there, so the bulk box
reaches them. Held here on the CPU: the plan against a brute-force
classification of every tile (the layouts of the 13-slot Au-on-Cr stack
cut in depth and at full depth, Kerr + TPA, the Bloch metal grating with
its two copies and the dispersive case on 5 uneven x-bricks, with a
12-cell PML on every PML side), and the regrouped brick step against the
port's unsharded run (bit-equal) and the JAX package (GSPMD where its
placement takes the split, else its XLA run; 2e-5).

The kernel tests at the end need a CUDA card and skip without one: the
batched call against its plain version per brick (1e-6; bf16 1e-2) and
bit-equal to batched calls of one brick each, and a runner whose bricks
sit on one card.
"""

import numpy as np
import pytest
import torch

from tidy3d_tpu_torch import convert
from tidy3d_tpu_torch.solver.fdtd import (
    FDTDRunner, brick_psi_cut, count_sources, select_tier,
)
from tidy3d_tpu_torch.solver.kernels import step as step_kernels
from tidy3d_tpu_torch.solver.kernels.step import (
    TILE, StepMeta, bulk_box, plan_bricks, tile_grid,
)
from tidy3d_tpu_torch.solver.lowering import lower
from tidy3d_tpu_torch.solver.sharding import Bricks, ShardingPlan, make_mesh

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    BLOCH, DISPERSIVE, DL, DIELECTRIC, LORENTZ2, max_rel_err, monitors,
    _sim,
)
from tests.test_torch_sharded import _raw_err, sized
from tests.test_torch_sharded_bricks import _random_global, gspmd
import tidy3d_tpu_torch as tt
from tests.torch_cases import lower_reference
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

TOL_RUN = 2e-5
TOL_UPDATE = 1e-6
TOL_BF16 = 1e-2
PML = 12
PML_SIDES = ("pml", "pml")
PERIODIC = ("periodic", "periodic")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "auto")
    for key in ("TIDY3D_TPU_KSTEP", "TIDY3D_TPU_SHARD",
                "TIDY3D_TPU_SHARDED_KSTEP", "TIDY3D_TPU_COORDINATOR",
                "TIDY3D_TPU_PRECISION", "TIDY3D_TPU_PAD_ALIGN"):
        monkeypatch.delenv(key, raising=False)


# --------------------------------------------------------------------------- #
# the plan of a call, from the bricks' layouts alone
# --------------------------------------------------------------------------- #

# name: (grid, decomposition, per-axis sides (PML or periodic), copies)
LAYOUTS = {
    "13_slots_cut_2x2x1": ((280, 280, 96), (2, 2, 1), (PML_SIDES,) * 3, 1),
    "13_slots_2x2x1": ((280, 280, 280), (2, 2, 1), (PML_SIDES,) * 3, 1),
    "kerr_2x2x1": ((384, 384, 384), (2, 2, 1), (PML_SIDES,) * 3, 1),
    "bloch_metal_1x2x2": ((192, 192, 512), (1, 2, 2),
                          (PERIODIC, PERIODIC, PML_SIDES), 2),
    "dispersive_5x1x1": ((384, 384, 384), (5, 1, 1), (PML_SIDES,) * 3, 1),
}


def brick_metas(shape, decomp, sides) -> list:
    """The ``StepMeta`` of each brick of ``shape`` over ``decomp``: its
    extent, its halo sides and the parts of the global psi slabs (``PML``
    cells on each PML side, for E and H alike) inside it. PML sides take
    a PEC wall (the global walls the slabs end at)."""
    lay = Bricks(shape, decomp, [s[0] == "periodic" for s in sides])
    widths = {(fam, a): tuple(PML if k == "pml" else 0 for k in sides[a])
              for fam in ("dual", "primal") for a in range(3)}
    bounds = tuple(tuple("pec" if k == "pml" else k for k in s)
                   for s in sides)
    metas = []
    for s in range(lay.n):
        pml_meta = {}
        for key, w in widths.items():
            cuts = [brick_psi_cut(lay, w, s, key[1], side) for side in (0, 1)]
            pml_meta[key] = tuple(c.stop - c.start for c in cuts)
        metas.append(StepMeta(shape=lay.extent(s), boundaries=bounds,
                              pml_meta=pml_meta, halo=lay.halo(s)))
    return metas


def brute_force_bulk(family: str, meta: StepMeta) -> set:
    """Every tile that the bulk path takes, by the rule stated cell by
    cell: y and z tiles whole (an x chunk may end at the last plane), no
    cell in a psi slab of the family, and every cell's neighbour across
    the family's wall (x - 1 for E, x + 1 for H on each axis) inside the
    brick or behind a side with a halo plane; z even (pair-aligned
    arrays)."""
    is_e = family == "E"
    fam = "dual" if is_e else "primal"
    if meta.shape[2] % 2:
        return set()
    ok_cells = []
    for a, n in enumerate(meta.shape):
        w_lo, w_hi = meta.pml_meta[(fam, a)]
        halo = meta.halo_side(family, a)
        cells = np.arange(n)
        nb = cells - 1 if is_e else cells + 1
        ok_cells.append((cells >= w_lo) & (cells < n - w_hi)
                        & (((nb >= 0) & (nb < n)) | halo))
    out = set()
    tiles = tile_grid(meta.shape)
    for tx in range(tiles[0]):
        for ty in range(tiles[1]):
            for tz in range(tiles[2]):
                t = (tx, ty, tz)
                whole = all((t[a] + 1) * TILE[a] <= meta.shape[a]
                            for a in (1, 2))
                if whole and all(ok_cells[a][t[a] * TILE[a]:
                                             (t[a] + 1) * TILE[a]].all()
                                 for a in range(3)):
                    out.add(t)
    return out


def _box_tiles(lo, hi) -> set:
    return {(x, y, z) for x in range(lo[0], hi[0])
            for y in range(lo[1], hi[1]) for z in range(lo[2], hi[2])}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_plan_matches_brute_force(name):
    """Each entry's bulk box is exactly the set of tiles the cell-by-cell
    rule takes (so that set is a box), its tile grid covers the brick,
    and its first blocks are the running sums of the entries before it,
    copies in pairs; the halo sides carry bulk tiles that the unsharded
    rule keeps in the shell."""
    shape, decomp, sides, copies = LAYOUTS[name]
    metas = brick_metas(shape, decomp, sides)
    for family in "EH":
        plans, blocks = plan_bricks(family, metas, copies)
        assert len(plans) == copies * len(metas)
        run = [0, 0]
        bulk_cells = 0
        for i, plan in enumerate(plans):
            meta = metas[i // copies]
            assert plan.tiles == tuple(-(-n // t) for n, t in
                                       zip(meta.shape, TILE))
            assert plan.first == tuple(run)
            assert _box_tiles(plan.lo, plan.hi) == \
                brute_force_bulk(family, meta)
            run[0] += plan.bulk_blocks
            run[1] += plan.blocks
            bulk_cells += sum(min(TILE[0], meta.shape[0] - x * TILE[0])
                              for x in range(plan.lo[0], plan.hi[0])) \
                * (plan.hi[1] - plan.lo[1]) * TILE[1] \
                * (plan.hi[2] - plan.lo[2]) * TILE[2]
        assert blocks == tuple(run)
        share = bulk_cells / (copies * np.prod(shape))
        print(f"{name} {family}: bulk share {share:.1%} of the cells, "
              f"{blocks[0]} bulk and {blocks[1]} shell blocks")
        # a halo face is no wall: the halo sides reach the bulk
        assert any(any(plan.lo[a] == 0 and metas[i // copies].halo_side(
            family, a) for a in range(3)) or
            any(plan.hi[a] == plan.tiles[a] and plan.hi[a] > 0 and
                metas[i // copies].halo_side(family, a) for a in range(3))
            for i, plan in enumerate(plans))


def test_bulk_box_of_unaligned_and_tiny_bricks():
    """Odd z sizes (arrays not pair-aligned) and bricks smaller than a
    tile take no bulk box; a plan of no bulk tile has no bulk launch."""
    metas = brick_metas((19, 16, 22), (2, 2, 2), (PML_SIDES,) * 3)
    assert all(m.shape[2] == 11 for m in metas)
    for family in "EH":
        assert all(bulk_box(family, m) == ((0, 0, 0), (0, 0, 0))
                   for m in metas)
        plans, blocks = plan_bricks(family, metas)
        assert blocks[0] == 0 and blocks[1] == sum(p.blocks for p in plans)
    metas = brick_metas((64, 64, 128), (1, 2, 2), (PML_SIDES,) * 3)
    assert bulk_box("E", metas[0], vec=False) == ((0, 0, 0), (0, 0, 0))


# --------------------------------------------------------------------------- #
# the regrouped brick step on the CPU
# --------------------------------------------------------------------------- #


def bricks(plan, decomp, device="cpu", **kw) -> FDTDRunner:
    mesh, _ = make_mesh(devices=[device] * int(np.prod(decomp)),
                        decomp=decomp)
    return FDTDRunner(plan, device=device,
                      sharding_plan=ShardingPlan(mesh, plan.shape), **kw)


# name: (simulation, decomposition, JAX reference)
STEP_CASES = {
    "lorentz_2x2x1": (lambda: sized(DISPERSIVE["lorentz_mixed"](
        monitors=monitors(), run_time=4e-15), 20), (2, 2, 1), "gspmd"),
    "bloch_1x2x2": (lambda: sized(BLOCH["bloch_dipole"](
        monitors=monitors(), run_time=4e-15), 12), (1, 2, 2), "gspmd"),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_regrouped_brick_step(name):
    """The brick runner (every brick's family in one call, then per brick
    its sources, passes and poles) bit-equal to the port's unsharded
    ``pallas2`` run and within 2e-5 of the JAX package."""
    make, decomp, ref_kind = STEP_CASES[name]
    sim = make()
    plan = lower(sim)
    run = bricks(plan, decomp)
    assert run.bricks
    got = run.run()
    own = FDTDRunner(plan, device="cpu", kernel="pallas2").run()
    assert _raw_err(own, got) == 0.0
    ref_plan = lower_reference(sim)
    ref = gspmd(ref_plan, decomp) if ref_kind == "gspmd" \
        else JaxRunner(ref_plan).run()
    err = _raw_err(ref, got)
    print(f"{name}: bricks vs JAX {ref_kind} {err:.2e}")
    assert err <= TOL_RUN


# --------------------------------------------------------------------------- #
# the kernel on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def wide(bspec, structures=()):
    """A 40 x 96 x 128 grid (3-layer PML sides included): bricks of it
    hold whole bulk tiles at their halo faces, short x chunks and tiles
    cut by the psi slabs."""
    return _sim(bspec, structures, run_time=2e-15).copy(
        update=dict(size=(34 * DL, 90 * DL, 122 * DL)))


PML3 = tt.PML(num_layers=3)
WIDE = {
    "real": (lambda: wide(tt.BoundarySpec.all_sides(PML3), [DIELECTRIC]),
             (2, 2, 2), None),
    "poles": (lambda: wide(tt.BoundarySpec.all_sides(PML3), [tt.Structure(
        geometry=tt.Box(center=(0, 0, 1.0), size=(tt.inf, tt.inf, 2.0)),
        medium=LORENTZ2)]), (2, 2, 2), None),
    "bloch": (lambda: wide(tt.BoundarySpec(
        x=tt.Boundary.bloch(bloch_vec=0.27),
        y=tt.Boundary.bloch(bloch_vec=-0.13), z=tt.Boundary.pml(
            num_layers=3)), [DIELECTRIC]), (1, 2, 2), None),
    "pec_x": (lambda: wide(tt.BoundarySpec(
        x=tt.Boundary(minus=tt.PECBoundary(), plus=tt.PMCBoundary()),
        y=tt.Boundary.periodic(), z=tt.Boundary.pml(num_layers=3)),
        [DIELECTRIC]), (2, 2, 2), None),
    "bf16": (lambda: wide(tt.BoundarySpec.all_sides(PML3), [DIELECTRIC]),
             (2, 2, 2), "bfloat16"),
}


def _outs(fn, run, states, family, views=None):
    views = views or [run._views(st) for st in states]
    src = "H" if family == "E" else "E"
    return fn(family, views, [[v[src] for v in vs] for vs in views],
              [st["halo"][src] for st in states])


def _err(got, want) -> float:
    worst = 0.0
    for g_b, w_b in zip(got, want):
        for (gf, gp), (wf, wp) in zip(g_b, w_b):
            for g, w in ((gf, wf), (gp, wp)):
                if g:
                    worst = max(worst, max_rel_err(
                        {k: v.float().cpu().numpy() for k, v in w.items()},
                        {k: v.float().cpu().numpy() for k, v in g.items()}))
    return worst


def _bit_equal(got, want) -> bool:
    return all(torch.equal(g[k], w[k])
               for g_b, w_b in zip(got, want)
               for (gf, gp), (wf, wp) in zip(g_b, w_b)
               for g, w in ((gf, wf), (gp, wp)) for k in g)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(WIDE))
def test_batched_call_matches_plain_and_single_bricks(case, cuda):
    """Both families of every brick in one call a family against the
    plain version brick by brick, and bit-equal to one call per brick
    (the same entries, each alone in its table); the call's counts."""
    make, decomp, precision = WIDE[case]
    plan = lower(make())
    run = bricks(plan, decomp, device=cuda, precision=precision)
    st = _random_global(FDTDRunner(plan, device="cpu", kernel="pallas2"), 9)
    states = convert.shard_states_from_reference(st, run)
    run.exchange_brick_halos(states, "E")
    run.exchange_brick_halos(states, "H")
    tol = TOL_BF16 if precision else TOL_UPDATE
    for family in "EH":
        before = (step_kernels.BRICK_CALLS, step_kernels.BRICK_LAUNCHES)
        got = _outs(run._family_update_bricks, run, states, family)
        torch.cuda.synchronize()
        assert step_kernels.BRICK_CALLS - before[0] == 1
        assert step_kernels.BRICK_LAUNCHES - before[1] == len(run.shards)
        assert step_kernels.LAST_BLOCKS[2] == 2

        def plain(fam, views, srcs, halos):
            return [step_kernels.family_update_copies_reference(fam, *b)
                    for b in zip(views, [sh.consts for sh in run.shards],
                                 srcs, [sh.meta for sh in run.shards],
                                 halos)]

        want = _outs(plain, run, states, family)
        err = _err(got, want)
        one = [step_kernels.family_update_copies(
            family, run._views(s), sh.consts,
            [v["H" if family == "E" else "E"] for v in run._views(s)],
            sh.meta, s["halo"]["H" if family == "E" else "E"])
            for sh, s in zip(run.shards, states)]
        print(f"{case} {family}: batched vs plain {err:.2e}")
        assert err <= tol, (case, family, err)
        assert _bit_equal(got, one), (case, family)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["poles", "bloch"])
def test_bricks_on_one_card_run(case, cuda):
    """A runner over (2, 2, 2) or (1, 2, 2) bricks of one card: one call
    a family and step, every brick in it, and the raw monitors of the
    unsharded ``pallas2`` run (2e-5)."""
    make, decomp, _ = WIDE[case]
    sim = make().copy(update=dict(monitors=monitors()))
    plan = lower(sim)
    ref = FDTDRunner(plan, device=cuda, kernel="pallas2").run()
    run = bricks(plan, decomp, device=cuda)
    before = (step_kernels.BRICK_CALLS, step_kernels.BRICK_LAUNCHES)
    got = run.run()
    torch.cuda.synchronize()
    assert step_kernels.BRICK_CALLS - before[0] == 2 * run.steps_run
    assert step_kernels.BRICK_LAUNCHES - before[1] == \
        2 * len(run.shards) * run.steps_run
    assert _raw_err(ref, got) <= TOL_RUN


def test_chip_smoke_brick_pieces_on_the_cpu():
    """``chip_smoke.py``'s phase 41 pieces on CPU bricks (where every call
    takes the plain version): the call over every brick, single-brick
    calls and the plain version brick by brick give the same bits; its
    pole-split cases lower to 241 and 2 x 121 slot records on
    ``pallas2``."""
    import chip_smoke

    plan = lower(sized(DISPERSIVE["lorentz_mixed"](), 20))
    run = bricks(plan, (2, 2, 1))
    st = _random_global(FDTDRunner(plan, device="cpu", kernel="pallas2"), 4)
    outs = {}
    for name, fn in (("bricks", step_kernels.family_update_bricks),
                     ("single", chip_smoke.single_bricks),
                     ("plain", chip_smoke.plain_bricks)):
        states = convert.shard_states_from_reference(st, run)
        run.exchange_brick_halos(states, "E")
        outs[name] = chip_smoke.brick_updates(fn, run, states)
    assert chip_smoke.brick_bit_equal(outs["bricks"], outs["single"])
    assert chip_smoke.brick_bit_equal(outs["bricks"], outs["plain"])
    for n, bloch in ((241, False), (121, True)):
        p = lower(chip_smoke.pole_split_case(tt, n, bloch))
        assert len(p.poles) == n and p.shape == (64, 64, 64)
        assert select_tier(p, count_sources(p), "cuda", "auto") == \
            ("pallas2", 1)
