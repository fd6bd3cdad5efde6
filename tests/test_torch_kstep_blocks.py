"""The k-step kernel's bulk and shell blocks (``kstep.classify_blocks``).

The kernel runs the blocks whose dependency cone meets no psi slab, no
wall and no wrap (virtual cell) in an instantiation without that code, so
the host's classification must never call a block bulk whose cone meets
one. Held here against a brute-force check of every block's cone, cell by
cell, on every case of ``tests/torch_cases.py``, on the larger ``TILED``
grids (several blocks per axis, no size a multiple of the tile), on the
shard-local metas of 2 and 4 x-shards (both halo sides, the edge shards
with their x-PML) and on the Bloch metas: each block lands in exactly one
list, no bulk cone holds a cell the kernel would need a wall rule, a psi
slab or a virtual cell for, and every shell cone holds one. The cones
the brute force walks are derived here from the stencil and the tile,
not taken from ``kstep.block_cones``, which is held to them. The 384^3
broadband layout gives the bulk share that ``PERF.md`` quotes.
"""

import numpy as np
import pytest
import torch

from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.kernels import kstep
from tidy3d_tpu_torch.solver.kernels.step import StepMeta
from tidy3d_tpu_torch.solver.lowering import lower
from tidy3d_tpu_torch.solver.sharding import ShardingPlan, make_mesh

from tests.torch_cases import BLOCH, DISPERSIVE, SIMS, TILED

K = 2
CASES = {**SIMS, **DISPERSIVE, **BLOCH, **TILED}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for key in ("TIDY3D_TPU_KERNEL", "TIDY3D_TPU_KSTEP", "TIDY3D_TPU_SHARD"):
        monkeypatch.delenv(key, raising=False)


def _runner(case, ndev=1):
    plan = lower(CASES[case]())
    if ndev == 1:
        return FDTDRunner(plan, device="cpu", kernel="kstep")
    mesh, _ = make_mesh(devices=["cpu"] * ndev)
    return FDTDRunner(plan, device="cpu", kernel="kstep",
                      sharding_plan=ShardingPlan(mesh, plan.shape))


def stencil_cone(lo: int, hi: int):
    """On one axis, the cells whose updates a block computes so that its
    owned cells ``[lo, hi)`` come out exact after K levels, level by level
    from the stencil: H at level j of a cell reads E at level j there and
    one cell higher, E at level j reads H at level j - 1 there and one cell
    lower. The union of every level's updates, ``[lo', hi')``."""
    h = (lo, hi)                     # H at level K: the owned cells
    cells = [h]
    for level in range(K, 0, -1):
        e = (h[0], h[1] + 1)         # E at this level
        h = (e[0] - 1, e[1])         # H at the level before
        cells += [e, h] if level > 1 else [e]
    return min(c[0] for c in cells), max(c[1] for c in cells)


def derived_cones(shape):
    """Each block's cone per axis, ``[lo, hi)`` arrays over its slab, row
    and column index, from the stencil (``stencil_cone``) and the kernel's
    tile alone: a block owns ``SLAB_X`` planes (the last slab ends at the
    domain) and the rows and columns of the tile less what the cone adds;
    in y and z it computes its whole tile, past the domain's hi end too."""
    lo0, hi0 = stencil_cone(0, 1)
    grow = (hi0 - lo0) - 1
    owned = (kstep.SLAB_X, kstep.TILE_Y - grow, kstep.TILE_Z - grow)
    cones = []
    for a, (n, o) in enumerate(zip(shape, owned)):
        lo = np.arange(-(-n // o)) * o
        hi = np.minimum(lo + o, n) if a == 0 else lo + o
        cone = [stencil_cone(int(l), int(h)) for l, h in zip(lo, hi)]
        cones.append(tuple(np.array(c) for c in zip(*cone)))
    return cones


def bad_cells(meta: StepMeta, origin, extent) -> np.ndarray:
    """Over the box of unwrapped cells ``origin + [0, extent)``: True where
    a cell cannot be part of a bulk cone. That is a cell outside the
    domain (a virtual cell of a wrap, or past a wall; a side that reads its
    halo extends x by k planes), a cell whose E update crosses a lo wall or
    whose H update crosses a hi wall (the wall rules, the wrap), or a cell
    inside a psi slab of either family."""
    axes = []
    for a in range(3):
        n = meta.shape[a]
        u = origin[a] + np.arange(extent[a])
        halo = meta.x_halo if a == 0 else (False, False)
        w_e, w_h = meta.pml_meta[("dual", a)], meta.pml_meta[("primal", a)]
        if halo[0]:
            assert w_e[0] == w_h[0] == 0, "psi slab on a halo side"
        if halo[1]:
            assert w_e[1] == w_h[1] == 0, "psi slab on a halo side"
        bad = (u < (-K if halo[0] else 0)) | (u >= n + (K if halo[1] else 0))
        if not halo[0]:
            bad |= u == 0
        if not halo[1]:
            bad |= u == n - 1
        w_lo, w_hi = max(w_e[0], w_h[0]), max(w_e[1], w_h[1])
        if w_lo:
            bad |= (u >= 0) & (u < w_lo)
        if w_hi:
            bad |= (u >= n - w_hi) & (u < n)
        axes.append(bad)
    return axes[0][:, None, None] | axes[1][None, :, None] \
        | axes[2][None, None, :]


def check_blocks(meta: StepMeta, ncopy: int):
    """The classification against the brute force; returns the counts."""
    bulk, shell = kstep.classify_blocks(meta, K, ncopy)
    cones = derived_cones(meta.shape)
    gx, gy, gz = (len(lo) for lo, _ in cones)
    gx *= ncopy
    assert kstep.grid_blocks(meta.shape, K, ncopy) == (gx, gy, gz)
    total = gx * gy * gz
    assert bulk.dtype == shell.dtype == np.int32
    assert np.array_equal(np.sort(np.concatenate([bulk, shell])),
                          np.arange(total)), "every block in one list"
    origin = [int(lo.min()) for lo, _ in cones]
    extent = [int(hi.max()) - o for (_, hi), o in zip(cones, origin)]
    bad = bad_cells(meta, origin, extent)
    is_bulk = np.zeros(total, bool)
    is_bulk[bulk] = True
    for bid in range(total):
        s, rest = divmod(bid, gy * gz)
        by, bz = divmod(rest, gz)
        s %= gx // ncopy          # the copy folded into the slabs
        box = tuple(slice(int(lo[i]) - o, int(hi[i]) - o)
                    for (lo, hi), i, o in zip(cones, (s, by, bz), origin))
        assert bad[box].any() != is_bulk[bid], (
            f"block {bid} (slab {s}, row {by}, column {bz}): "
            f"{'bulk' if is_bulk[bid] else 'shell'}")
    return len(bulk), len(shell)


@pytest.mark.parametrize("case", sorted(CASES))
def test_blocks_match_the_brute_force(case):
    runner = _runner(case)
    nb, ns = check_blocks(runner.meta, 2 if runner.is_complex else 1)
    if case in TILED:
        assert nb > 0 and ns > 0, (nb, ns)


@pytest.mark.parametrize("case,ndev", [
    ("tiled_lorentz2", 2), ("tiled_lorentz2", 4), ("tiled_gold", 4),
    ("tiled_lorentz_periodic", 2)])
def test_shard_blocks_match_the_brute_force(case, ndev):
    runner = _runner(case, ndev)
    halos = set()
    for sh in runner.shards:
        assert sh.meta.xpad == K
        halos.add(tuple(sh.meta.x_halo))
        nb, ns = check_blocks(sh.meta, 1)
        if all(sh.meta.x_halo):
            # an interior shard: its x cone never meets a wall
            assert nb > 0, (case, sh.index)
    periodic = runner.meta.boundaries[0][0] == "periodic"
    assert halos == ({(True, True)} if periodic else
                     {(False, True), (True, False), (True, True)}
                     if ndev > 2 else {(False, True), (True, False)})


@pytest.mark.parametrize("shape", [(64, 26, 58), (65, 27, 59), (97, 40, 88),
                                   (33, 13, 29), (31, 12, 28)])
@pytest.mark.parametrize("walls", ["pml", "pec_pmc", "periodic", "halo"])
def test_synthetic_layouts_match_the_brute_force(shape, walls):
    """Sizes at, just past and between multiples of the tile."""
    w = {"pml": (5, 5), "pec_pmc": (0, 3), "periodic": (0, 0),
         "halo": (0, 0)}[walls]
    kinds = {"pml": ("pec", "pec"), "pec_pmc": ("pmc", "pec"),
             "periodic": ("periodic", "periodic"),
             "halo": ("pec", "pec")}[walls]
    meta = StepMeta(
        shape=shape, boundaries=(kinds,) * 3,
        pml_meta={(f, a): w for f in ("dual", "primal") for a in range(3)},
        xpad=K if walls == "halo" else 0,
        x_halo=(True, True) if walls == "halo" else (False, False))
    if walls == "halo":
        meta = StepMeta(shape=shape, boundaries=meta.boundaries,
                        pml_meta={**meta.pml_meta, ("dual", 0): (0, 0),
                                  ("primal", 0): (0, 0)},
                        xpad=K, x_halo=(True, True))
    check_blocks(meta, 1)
    check_blocks(meta, 2)


@pytest.mark.parametrize("shape", [(384, 384, 384), (280, 280, 280),
                                   (65, 27, 59), (31, 12, 28)])
def test_block_cones_follow_the_stencil(shape):
    """The host's cones are the stencil's: the owned box grown by K - 1
    cells on the lo side and K on the hi side of every axis."""
    assert kstep.cone_halo(K) == (-stencil_cone(0, 1)[0],
                                  stencil_cone(0, 1)[1] - 1)
    for (lo, hi), (d_lo, d_hi) in zip(kstep.block_cones(shape, K),
                                      derived_cones(shape)):
        assert np.array_equal(lo, d_lo) and np.array_equal(hi, d_hi)


def test_broadband_384_bulk_share():
    """The 384^3 broadband layout (a 12-layer CPML: psi slabs 13 cells
    wide): 2860 of 5040 blocks are bulk, 56.7 % (PERF.md section 5)."""
    runner = _runner("pml_all")
    w = runner.meta.pml_meta[("dual", 0)]
    assert w == (4, 4)
    meta = StepMeta(shape=(384, 384, 384),
                    boundaries=(("pec", "pec"),) * 3,
                    pml_meta={(f, a): (13, 13) for f in ("dual", "primal")
                              for a in range(3)})
    bulk, shell = kstep.classify_blocks(meta, K)
    assert kstep.grid_blocks(meta.shape, K) == (12, 30, 14)
    assert (len(bulk), len(shell)) == (2860, 2180)
    assert (10, 26, 11) == tuple(
        int(((lo >= 13) & (hi <= 371)).sum())
        for lo, hi in kstep.block_cones(meta.shape, K))


def test_block_lists_are_cached_per_layout():
    runner = _runner("tiled_lorentz2")
    first = kstep.block_lists(runner.meta, K, 1, "cpu")
    again = kstep.block_lists(runner.meta, K, 1, torch.device("cpu"))
    assert all(a is b for a, b in zip(first, again))
    assert all(t.dtype == torch.int32 for t in first)
    bulk, shell = kstep.classify_blocks(runner.meta, K)
    assert np.array_equal(first[0].numpy(), bulk)
    assert np.array_equal(first[1].numpy(), shell)
    other = _runner("tiled_gold")
    assert kstep.block_lists(other.meta, K, 1, "cpu") is not None


def test_cpu_group_counts_no_device_launch():
    runner = _runner("tiled_lorentz2")
    before = (kstep.LAUNCHES, kstep.DEVICE_LAUNCHES)
    runner.step_group(0, runner.init_state())
    assert (kstep.LAUNCHES, kstep.DEVICE_LAUNCHES) == before
