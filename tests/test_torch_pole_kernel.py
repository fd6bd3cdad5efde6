"""The pole kernel of the ``pallas2`` tier (``kernels/poles.py``,
``csrc/poles.cu``) against the JAX package.

The wrapper packs a list of Python slot records (``slot_records``: per slot
and copy its currents, A, Gc, and per component the residue's kind, maps
and B0) into a table of ``PoleSlot``. Held here, on one Lorentz slot (mask
kind), the 7-slot Au fit, Au on Cr (13 slots, two metals), the Lorentz and
Au slots with dense residue maps, and a two-copy Bloch run with three
Lorentz slots:

* the packed table against its records: the slot count, one entry per
  slot and copy, the kinds, A, Gc and B0 at float32, every pointer, and
  the device table's bytes, slot ranges and read components;
* a plain walker that decodes the records with the kernel's arithmetic and
  rounding points (``csrc/poles.cu``): in float32 within 1e-6 of the
  largest |Q'| of the JAX runner's ``_update_poles`` (XLA on the CPU, as
  the JAX package's own tests run it) and of the plain ``update_poles``;
  with bfloat16 storage bit-equal to ``_update_poles_stored``;
* the runner's wiring: one call a step for every copy, one a brick, the
  table built once per runner and anew for a state at other addresses;
  CPU tensors take the plain version and launch nothing.

The kernel-against-plain tests at the end need a CUDA card and skip
without one.
"""

import jax
import numpy as np
import pytest
import torch

from tidy3d_tpu_torch.solver.fdtd import FDTDRunner
from tidy3d_tpu_torch.solver.kernels import poles as poles_kernels
from tidy3d_tpu_torch.solver.kernels.poles import (
    MAX_COPIES, PoleTable, pack, slot_records, table_key, update_poles,
    update_poles_copies,
)
from tidy3d_tpu_torch.solver.kernels.step import POLE_KIND
from tidy3d_tpu_torch.solver.lowering import E_COMPS
from tidy3d_tpu_torch.solver.sharding import ShardingPlan, make_mesh

# first: where h5py is missing it makes the JAX package importable
from tests.torch_cases import (
    BLOCH, DISPERSIVE, lower_reference as lower, max_rel_err, random_state,
)
from tests.test_torch_bloch_onestep import BOX, LORENTZ3
from tests.test_torch_many_poles import stack_sim
from tests.test_torch_poles import _dense
import tidy3d_tpu_torch as tt
from tidy3d_tpu.solver.fdtd import FDTDRunner as JaxRunner

TOL = 1e-6          # float32 rounding of the same expression tree
MASK, DENSE = POLE_KIND["mask"], POLE_KIND["dense"]


def _bloch_lorentz(**kw):
    return BLOCH["bloch_dipole"](**kw).copy(update=dict(structures=[
        tt.Structure(geometry=BOX, medium=LORENTZ3)]))


CASES = {
    "lorentz": lambda: lower(DISPERSIVE["lorentz_mixed"]()),
    "au7": lambda: lower(DISPERSIVE["gold_halfspace"]()),
    "au_cr13": lambda: lower(stack_sim(13, monitors=False)),
    "lorentz_dense": lambda: _dense(lower(DISPERSIVE["lorentz_mixed"]())),
    "au7_dense": lambda: _dense(lower(DISPERSIVE["gold_halfspace"]())),
    "bloch_lorentz3": lambda: lower(_bloch_lorentz()),
}
SLOTS = {"lorentz": 1, "au7": 7, "au_cr13": 13, "lorentz_dense": 1,
         "au7_dense": 7, "bloch_lorentz3": 3}
_PLANS = {}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("TIDY3D_TPU_TILE_QUANTA", "1,1,1")
    monkeypatch.setenv("TIDY3D_TPU_KERNEL", "xla")


def _plan(case):
    if case not in _PLANS:
        _PLANS[case] = CASES[case]()
    return _PLANS[case]


def _inputs(case, seed, precision="float32", q_dtype=None):
    """``(port, new_es, old_es, Qs)`` of a random state of every copy (numpy
    seeded), at the storage of ``precision`` (the currents at ``q_dtype``
    where given)."""
    port = FDTDRunner(_plan(case), device="cpu", kernel="pallas2",
                      precision=precision)
    rng = np.random.default_rng(seed)
    copies = 1 + port.is_complex
    sts = [random_state(rng, port.shape, {}, port.consts["pole_scalars"])
           for _ in range(copies)]
    new_np = [{c: rng.standard_normal(port.shape).astype(np.float32)
               for c in E_COMPS} for _ in range(copies)]
    field, q = port.dtype, q_dtype or port.q_dtype

    def t(a, dt):
        return torch.from_numpy(a).to(dt)

    return (port, [{c: t(v, field) for c, v in ne.items()} for ne in new_np],
            [{c: t(v, field) for c, v in st["E"].items()} for st in sts],
            [[{c: (t(qr, q), t(qi, q)) for c, (qr, qi) in Qp.items()}
              for Qp in st["Q"]] for st in sts])


def _clone(Qs):
    return [[{c: (qr.clone(), qi.clone()) for c, (qr, qi) in Qp.items()}
             for Qp in Q] for Q in Qs]


def walk(records, new_es, old_es, round_products=True):
    """The kernel's arithmetic on the records, in whole-array operations:
    ``{(copy, slot of the copy, comp): (qr', qi')}`` at the currents' type.
    Each product ``A q`` and their sum round to the currents' type (with
    ``round_products``), E' + E to the fields'; the residue term and its
    sum are float32."""
    out, index = {}, {}
    for rec in records:
        pi = index[rec.copy] = index.get(rec.copy, -1) + 1
        for ci, comp in enumerate(E_COMPS):
            q_dt, f_dt = rec.q[0].dtype, new_es[rec.copy][comp].dtype

            def rq(x):
                return x.to(q_dt).float() if round_products else x

            esum = (new_es[rec.copy][comp].float()
                    + old_es[rec.copy][comp].float()).to(f_dt).float()
            qr, qi = rec.q[2 * ci].float(), rec.q[2 * ci + 1].float()
            are, aim = (float(np.float32(v)) for v in rec.a)
            r = rq(rq(qr * are) - rq(qi * aim))
            m = rq(rq(qr * aim) + rq(qi * are))
            if rec.kind[ci] == MASK:
                mes = rec.b[2 * ci] * esum
                b_re, b_im = rec.b0[2 * ci:2 * ci + 2]
                if b_re:
                    r = r + float(np.float32(b_re)) * mes
                if b_im:
                    m = m + float(np.float32(b_im)) * mes
            elif rec.kind[ci] == DENSE:
                r = r + rec.b[2 * ci] * esum
                m = m + rec.b[2 * ci + 1] * esum
            out[(rec.copy, pi, comp)] = (r.to(q_dt), m.to(q_dt))
    return out


def _flat(Qs):
    return {(c, pi, comp): pair for c, Q in enumerate(Qs)
            for pi, Qp in enumerate(Q) for comp, pair in Qp.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_table_matches_its_records(case):
    port, new_es, old_es, Qs = _inputs(case, 1)
    consts = port.consts
    records = slot_records(Qs, consts)
    npoles = SLOTS[case]
    assert len(port.plan.poles) == npoles and len(Qs) == 1 + port.is_complex
    assert len(records) == npoles * len(Qs)
    slots = pack(records)
    assert len(slots) == len(records)
    f32 = np.float32
    for i, (slot, rec) in enumerate(zip(slots, records)):
        copy, pi = divmod(i, npoles)
        (A, Gc), metas = consts["pole_scalars"][pi], consts["pole_B_meta"][pi]
        assert rec.copy == slot.copy == copy
        assert (slot.a_re, slot.a_im) == (f32(A.real), f32(A.imag))
        assert (slot.gc_re, slot.gc_im) == (f32(Gc.real), f32(Gc.imag))
        for ci, comp in enumerate(E_COMPS):
            m = metas[ci]
            assert slot.kind[ci] == rec.kind[ci] == POLE_KIND[m["kind"]]
            for part in range(2):
                ptr = Qs[copy][pi][comp][part].data_ptr()
                assert slot.q[2 * ci + part] == slot.q_out[2 * ci + part] \
                    == ptr
            b = [slot.b[2 * ci] or 0, slot.b[2 * ci + 1] or 0]
            b0 = list(slot.b0[2 * ci:2 * ci + 2])
            if m["kind"] == "mask":
                mask = consts["pole_masks"][m["mask_id"]]
                assert b == [mask.data_ptr(), 0]
                assert b0 == [f32(v) for v in m["B0"]]
            elif m["kind"] == "dense":
                assert b == [t.data_ptr() for t in
                             consts["pole_B_dense"][f"{pi}_{ci}"]]
            else:
                assert b == [0, 0] and b0 == [0, 0]
    want = {"lorentz": {MASK}, "au7": {MASK}, "au_cr13": {MASK},
            "lorentz_dense": {DENSE}, "au7_dense": {DENSE},
            "bloch_lorentz3": {MASK}}[case]
    assert {k for s in slots for k in s.kind} - {POLE_KIND["zero"]} == want
    if case == "au_cr13":
        # two metals: two supports
        assert len({s.b[0] for s in slots}) == 2
    # the device table of the same records (here on the CPU)
    table = PoleTable(table_key(Qs, consts), Qs, consts, port.shape,
                      port.q_dtype, "cpu")
    assert bytes(table.tensor.numpy()) == bytes(slots)
    assert table.first[:len(Qs) + 1] == [npoles * c for c in
                                         range(len(Qs) + 1)]
    assert table.need == [[any(r.kind[ci] for r in records if r.copy == c)
                           for ci in range(3)] for c in range(len(Qs))]


@pytest.mark.parametrize("case", list(CASES))
def test_walker_matches_the_jax_update(case):
    """float32: the records' walk within 1e-6 of the JAX runner's
    ``_update_poles`` on each copy, and of the plain ``update_poles``."""
    port, new_es, old_es, Qs = _inputs(case, 2)
    jr = JaxRunner(port.plan)
    consts = jax.device_put(jr.consts)
    fn = jax.jit(lambda ne, v, c: jr._update_poles(ne, v, c))
    got = walk(slot_records(Qs, port.consts), new_es, old_es)
    plain = _flat(update_poles_copies(new_es, old_es, _clone(Qs),
                                      port.consts))
    for c, (ne, oe, Q) in enumerate(zip(new_es, old_es, Qs)):
        ref = jax.device_get(fn(
            {k: v.numpy() for k, v in ne.items()},
            {"E": {k: v.numpy() for k, v in oe.items()},
             "Q": [{k: (qr.numpy(), qi.numpy()) for k, (qr, qi) in
                    Qp.items()} for Qp in Q]}, consts))
        for pi, rq in enumerate(ref):
            r = {f"{k}{p}": np.asarray(v[p]) for k, v in rq.items()
                 for p in range(2)}
            for what, src in (("walker", got), ("plain", plain)):
                g = {f"{k}{p}": src[(c, pi, k)][p].numpy() for k in rq
                     for p in range(2)}
                err = max_rel_err(r, g)
                assert err <= TOL, f"{what} copy {c} slot {pi}: {err:.2e}"


@pytest.mark.parametrize("storage", [("bfloat16", None),
                                     ("float32", torch.bfloat16)])
@pytest.mark.parametrize("case", list(CASES))
def test_walker_bit_equal_to_the_stored_plain_update(case, storage):
    """bfloat16 storage: the walk equals ``_update_poles_stored`` bit for
    bit (the currents in bf16, with the fields in bf16 or float32)."""
    precision, q_dtype = storage
    port, new_es, old_es, Qs = _inputs(case, 3, precision, q_dtype)
    assert Qs[0][0]["Ex"][0].dtype == torch.bfloat16
    got = walk(slot_records(Qs, port.consts), new_es, old_es)
    plain = _flat([update_poles(ne, oe, Q, port.consts) for ne, oe, Q in
                   zip(new_es, old_es, _clone(Qs))])
    assert set(got) == set(plain)
    for key, (r, m) in got.items():
        assert torch.equal(r, plain[key][0]), key
        assert torch.equal(m, plain[key][1]), key
    # the rounding points matter: A Q kept in float32 until the store
    # differs
    wide = walk(slot_records(Qs, port.consts), new_es, old_es,
                round_products=False)
    assert any(not torch.equal(wide[key][p], plain[key][p])
               for key in plain for p in range(2))


def test_runner_calls_once_a_step_for_every_copy(monkeypatch):
    calls = []
    real = poles_kernels.update_poles_copies

    def counted(new_es, old_es, Qs, consts, cache=None):
        calls.append((len(Qs), cache))
        return real(new_es, old_es, Qs, consts, cache)

    monkeypatch.setattr(poles_kernels, "update_poles_copies", counted)
    port = FDTDRunner(_plan("bloch_lorentz3"), device="cpu",
                      kernel="pallas2")
    assert port.is_complex and port.tier == "pallas2"
    launches = poles_kernels.LAUNCHES
    port.run_steps(0, 3, port.init_state())
    assert [n for n, _ in calls] == [2, 2, 2]
    assert all(cache is calls[0][1] for _, cache in calls)
    # CPU tensors take the plain version
    assert poles_kernels.LAUNCHES == launches


def test_runner_calls_once_a_brick(monkeypatch):
    calls = []
    real = poles_kernels.update_poles_copies

    def counted(new_es, old_es, Qs, consts, cache=None):
        calls.append(id(cache))
        return real(new_es, old_es, Qs, consts, cache)

    monkeypatch.setattr(poles_kernels, "update_poles_copies", counted)
    plan = _plan("lorentz")
    mesh, _ = make_mesh(devices=["cpu"] * 2, decomp=(1, 2, 1))
    port = FDTDRunner(plan, device="cpu",
                      sharding_plan=ShardingPlan(mesh, plan.shape))
    assert port.bricks and len(port.shards) == 2
    port.run_steps(0, 2, port.init_state())
    assert len(calls) == 4 and len(set(calls)) == 2


def test_table_built_once_and_anew_for_other_addresses():
    port, new_es, old_es, Qs = _inputs("au_cr13", 4)
    cache, builds = {}, poles_kernels.TABLE_BUILDS
    shape, q_dt = port.shape, port.q_dtype
    first = poles_kernels._table(Qs, port.consts, shape, q_dt, "cpu", cache)
    assert poles_kernels._table(Qs, port.consts, shape, q_dt, "cpu",
                                cache) is first
    assert poles_kernels.TABLE_BUILDS == builds + 1
    # a re-cast or resumed state: new tensors, a new table
    moved = _clone(Qs)
    again = poles_kernels._table(moved, port.consts, shape, q_dt, "cpu",
                                 cache)
    assert again is not first and cache["table"] is again
    assert poles_kernels.TABLE_BUILDS == builds + 2
    assert first.tensor.data_ptr() != again.tensor.data_ptr()
    with pytest.raises(ValueError, match="expected"):
        PoleTable(table_key(Qs, port.consts), Qs, port.consts, (1, 2, 3),
                  q_dt, "cpu")
    with pytest.raises(ValueError, match="copies"):
        poles_kernels._update_poles_cuda(new_es * 3, old_es * 3,
                                         Qs * (MAX_COPIES + 1),
                                         port.consts, {})


# --------------------------------------------------------------------------
# on a CUDA card: the kernel against its plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(case, precision, cuda):
    """One launch for every slot and copy: float32 within 1e-6 of the
    plain update's largest |Q'|, bfloat16 bit-equal to it."""
    port, new_es, old_es, Qs = _inputs(case, 5, precision)
    port = FDTDRunner(port.plan, device=cuda, kernel="pallas2",
                      precision=precision)

    def dev(Qs_):
        return [[{c: (qr.to(cuda), qi.to(cuda)) for c, (qr, qi) in
                  Qp.items()} for Qp in Q] for Q in Qs_]

    ne = [{c: v.to(cuda) for c, v in d.items()} for d in new_es]
    oe = [{c: v.to(cuda) for c, v in d.items()} for d in old_es]
    got, ref = dev(Qs), dev(Qs)
    launches = poles_kernels.LAUNCHES
    update_poles_copies(ne, oe, got, port.consts, {})
    torch.cuda.synchronize()
    assert poles_kernels.LAUNCHES == launches + 1
    ref = [update_poles(a, b, Q, port.consts) for a, b, Q in zip(ne, oe, ref)]
    g, r = _flat(got), _flat(ref)
    scale = max(float(v.float().abs().max()) for pair in r.values()
                for v in pair)
    diff = max(float((a.float() - b.float()).abs().max())
               for key in r for a, b in zip(g[key], r[key]))
    if precision == "float32":
        assert diff <= TOL * scale, diff / scale
    else:
        assert diff == 0.0, diff / scale


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_kernel_cell_by_cell_matches_plain(precision, cuda):
    """Currents one value off the kernel's 4-value alignment take its
    cell-by-cell instantiation: the same values as the aligned launch."""
    port, new_es, old_es, Qs = _inputs("au7", 6, precision)
    port = FDTDRunner(port.plan, device=cuda, kernel="pallas2",
                      precision=precision)

    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        return buf[1:].view(t.shape).copy_(t)

    ne = [{c: v.to(cuda) for c, v in d.items()} for d in new_es]
    oe = [{c: v.to(cuda) for c, v in d.items()} for d in old_es]
    odd = [[{c: (offset(qr), offset(qi)) for c, (qr, qi) in Qp.items()}
            for Qp in Q] for Q in Qs]
    aligned = [[{c: (qr.to(cuda), qi.to(cuda)) for c, (qr, qi) in
                 Qp.items()} for Qp in Q] for Q in Qs]
    cache = {}
    update_poles_copies(ne, oe, odd, port.consts, cache)
    assert not cache["table"].aligned
    update_poles_copies(ne, oe, aligned, port.consts, {})
    torch.cuda.synchronize()
    g, r = _flat(odd), _flat(aligned)
    assert all(torch.equal(a, b) for key in r for a, b in zip(g[key], r[key]))
