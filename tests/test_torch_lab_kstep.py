"""The port's temporal-blocking lab (``tidy3d_tpu_torch.labs.kernel_lab2``)
against the JAX lab ``scripts/kernel_lab2.py``.

``make_kstep`` runs in Pallas interpret mode on the CPU, built and called
inside ``force_tpu_interpret_mode``; ``lab_kstep`` on CPU tensors is the
plain version. Both get the same seeded numpy fields, stored in f32 or
bf16 and stepped in f32. Every plane is compared, the x-edge planes of the
clamped first and last windows included. Tolerances, relative to the
largest magnitude: 1e-6 in f32, 1e-2 in bf16 (one rounding at the store,
bf16's epsilon is 7.8e-3).

Without JAX: the planes ``[k, n-k)`` equal k curl steps of
``kernel_lab.lab_step``. The kernel-against-plain tests at the end need a
CUDA card and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tidy3d_tpu_torch.labs import kernel_lab, kernel_lab2

from tests.test_torch_lab_step import (
    JNP, N, TOL, as_np, jax_lab, random_fields, rel_err, to_torch,
)


def jax_kstep(fields_np: dict, k: int, bx: int, dtype) -> dict:
    lab = jax_lab("kernel_lab2")
    with pltpu.force_tpu_interpret_mode():
        group = lab.make_kstep(N, bx, k, JNP[dtype])
        out = group({c: jnp.asarray(v, dtype=JNP[dtype])
                     for c, v in fields_np.items()})
        return {c: np.asarray(v.astype(jnp.float32), dtype=np.float64)
                for c, v in out.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bx", [4, 8])
@pytest.mark.parametrize("k", kernel_lab2.KS)
def test_kstep_matches_the_jax_lab(k, bx, dtype):
    f = random_fields(10 + k)
    ref = jax_kstep(f, k, bx, dtype)
    got = kernel_lab2.lab_kstep(to_torch(f, dtype), k, bx)
    assert all(v.dtype == dtype for v in got.values())
    err = rel_err(ref, as_np(got))
    assert err <= TOL[dtype], f"k={k} bx={bx} {dtype}: {err:.2e}"


@pytest.mark.parametrize("k", kernel_lab2.KS)
def test_interior_planes_are_k_curl_steps(k):
    f = to_torch(random_fields(20 + k), torch.float32)
    got = kernel_lab2.lab_kstep(f, k, 8)
    ref = f
    for _ in range(k):
        ref = kernel_lab.lab_step(ref, "curl")
    inner = slice(k, N - k)
    err = rel_err(as_np({c: v[inner] for c, v in ref.items()}),
                  as_np({c: v[inner] for c, v in got.items()}))
    assert err <= 1e-6, f"k={k}: {err:.2e}"
    # from k = 2 on, the clamped edge windows (planes [0, hw) below the
    # first block, [n - hw, n) above the last) make planes 0 and n-1 differ
    edge = max(float((got[c][[0, -1]] - ref[c][[0, -1]]).abs().max())
               for c in got)
    assert (edge > 1e-3) == (k > 1), edge


def test_window_rows_clamp_at_the_ends():
    rows = kernel_lab2.window_rows(16, 8, 3).tolist()  # hw = 4
    assert rows[0] == [0, 1, 2, 3] + list(range(8)) + [8, 9, 10, 11]
    assert rows[1] == [4, 5, 6, 7] + list(range(8, 16)) + [12, 13, 14, 15]
    assert kernel_lab2.halo_width(3, 8) == 4
    assert kernel_lab2.halo_width(2, 8) == 2


def test_cpu_dispatch_counts_no_launch():
    before = dict(kernel_lab2.LAUNCHES)
    kernel_lab2.lab_kstep(to_torch(random_fields(4), torch.float32), 2, 8)
    assert kernel_lab2.LAUNCHES == before


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_lab2.main(["16"]) == 2


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
@pytest.mark.parametrize("k", kernel_lab2.KS)
def test_kernel_matches_plain(k, bx, dtype, cuda):
    f = to_torch(random_fields(30 + k), dtype, cuda)
    key = kernel_lab2.launch_key(k, dtype)
    before = kernel_lab2.LAUNCHES.get(key, 0)
    got = kernel_lab2.lab_kstep(f, k, bx)
    torch.cuda.synchronize()
    assert kernel_lab2.LAUNCHES[key] == before + 1
    ref = kernel_lab2.lab_kstep_reference(f, k, bx)
    err = rel_err(as_np(ref), as_np(got))
    assert err <= TOL[dtype], f"k={k} bx={bx} {dtype}: {err:.2e}"
