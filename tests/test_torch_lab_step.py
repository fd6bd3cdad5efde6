"""The port's kernel lab (``tidy3d_tpu_torch.labs.kernel_lab``) against the
JAX lab ``scripts/kernel_lab.py``.

``make_step`` runs in Pallas interpret mode on the CPU, built and called
inside ``force_tpu_interpret_mode``; ``lab_step`` on CPU tensors is the
plain version. Both get the same seeded numpy fields. Tolerances, relative
to the largest magnitude: 1e-6 in f32 (rounding of the same expression
tree), 1e-2 in bf16 (bf16's epsilon is 7.8e-3; XLA on the CPU may keep
excess precision between the bf16 operations the port rounds).

The kernel-against-plain tests at the end need a CUDA card and skip
without one.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tidy3d_tpu_torch.labs import kernel_lab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16
TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@functools.lru_cache(maxsize=None)
def jax_lab(name: str):
    """The JAX package's lab script ``scripts/<name>.py``, loaded under a
    private module name."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_lab_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def random_fields(seed: int, n: int = N) -> dict:
    rng = np.random.default_rng(seed)
    return {c: rng.standard_normal((n, n, n)).astype(np.float32)
            for c in kernel_lab.E + kernel_lab.H}


def to_torch(fields: dict, dtype, device="cpu") -> dict:
    return {c: torch.from_numpy(v).to(device=device, dtype=dtype)
            for c, v in fields.items()}


def rel_err(ref: dict, got: dict) -> float:
    """Largest difference over all fields, relative to the largest
    magnitude; both as float64 numpy."""
    assert set(ref) == set(got)
    scale = max(float(np.abs(v).max()) for v in ref.values())
    return max(float(np.abs(got[c] - ref[c]).max()) for c in ref) / scale


def as_np(fields: dict) -> dict:
    return {c: v.double().cpu().numpy() for c, v in fields.items()}


def jax_step(fields_np: dict, variant: str, bx: int, dtype) -> dict:
    lab = jax_lab("kernel_lab")
    with pltpu.force_tpu_interpret_mode():
        step = lab.make_step(N, bx, variant, JNP[dtype])
        out = step({c: jnp.asarray(v, dtype=JNP[dtype])
                    for c, v in fields_np.items()})
        return {c: np.asarray(v.astype(jnp.float32), dtype=np.float64)
                for c, v in out.items()}


@pytest.mark.parametrize("bx", [4, 8])
@pytest.mark.parametrize("variant", kernel_lab.VARIANTS)
def test_step_matches_the_jax_lab(variant, bx):
    f = random_fields(1)
    ref = jax_step(f, variant, bx, torch.float32)
    got = as_np(kernel_lab.lab_step(to_torch(f, torch.float32), variant, bx))
    err = rel_err(ref, got)
    assert err <= TOL[torch.float32], f"{variant} bx={bx}: {err:.2e}"


@pytest.mark.parametrize("bx", [4, 8])
def test_bf16_curl_matches_the_jax_lab(bx):
    f = random_fields(2)
    ref = jax_step(f, "curl", bx, torch.bfloat16)
    got = kernel_lab.lab_step(to_torch(f, torch.bfloat16), "curl", bx)
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    err = rel_err(ref, as_np(got))
    assert err <= TOL[torch.bfloat16], f"bf16 curl bx={bx}: {err:.2e}"


def test_cpu_dispatch_counts_no_launch():
    before = dict(kernel_lab.LAUNCHES)
    kernel_lab.lab_step(to_torch(random_fields(4), torch.float32), "copy")
    assert kernel_lab.LAUNCHES == before


def test_step_bound_at_384():
    """12 f32 fields of 384^3 once: 2.72 GB, 0.811 ms at 3.35 TB/s."""
    from tidy3d_tpu_torch.labs import _common

    ms, by = _common.bound(kernel_lab.step_bytes(384, torch.float32),
                           kernel_lab.FLOPS_PER_CELL * 384 ** 3)
    assert by == "bytes" and abs(ms - 0.811) < 1e-3


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_lab.main(["16"]) == 2


# --------------------------------------------------------------------------- #
# kernel against plain version, on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bx", [4, 8])
@pytest.mark.parametrize("variant", kernel_lab.VARIANTS)
def test_kernel_matches_plain(variant, bx, dtype, cuda):
    f = to_torch(random_fields(5), dtype, cuda)
    key = kernel_lab.launch_key(variant, dtype)
    before = kernel_lab.LAUNCHES.get(key, 0)
    got = kernel_lab.lab_step(f, variant, bx)
    torch.cuda.synchronize()
    assert kernel_lab.LAUNCHES[key] == before + 1
    ref = kernel_lab.lab_step_reference(f, variant)
    err = rel_err(as_np(ref), as_np(got))
    assert err <= TOL[dtype], f"{variant} bx={bx} {dtype}: {err:.2e}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,bx", [(16, 8), (15, 5)])
def test_copy_is_bit_identical(n, bx, dtype, cuda):
    """The copy variant's 16-byte vectors and its scalar tail: 15^3 values
    leave 7 (bf16) or 3 (f32) past the last whole vector of each field."""
    f = to_torch(random_fields(6, n), dtype, cuda)
    got = kernel_lab.lab_step(f, "copy", bx)
    torch.cuda.synchronize()
    ref = kernel_lab.lab_step_reference(f, "copy")
    for c in kernel_lab.E + kernel_lab.H:
        assert torch.equal(got[c].view(torch.int16 if dtype == torch.bfloat16
                                       else torch.int32),
                           ref[c].view(torch.int16 if dtype == torch.bfloat16
                                       else torch.int32)), c
