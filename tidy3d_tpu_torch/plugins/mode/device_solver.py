"""Matrix-free device eigensolver for the 2D Yee waveguide-mode problem.

The counterpart of ``tidy3d_tpu/plugins/mode/tpu_solver.py``: the same
Chebyshev-filtered subspace iteration (Zhou & Saad 2006 style), with the
device work in PyTorch on the device the caller names instead of XLA.

* The guided modes are the **algebraically largest** eigenvalues of the
  transverse-E operator ``M = -A @ B`` (beta^2 eigenproblem): the discrete
  spectrum is approximately real in ``[-k_t,max^2, (n_max k0)^2]`` and the
  wanted modes sit at the top, so a polynomial filter that damps the
  interval ``[lo, cut]`` and amplifies everything above ``cut`` converges
  to them without any shift-invert solve.
* The device filter runs in **pure float32 real arithmetic** on a REAL
  PROXY operator (real parts of the PML-stretched derivative matrices and
  material diagonals): CPML eigenvalues sit far off the real axis and a
  real-interval polynomial amplifies them ~1e6x faster than the guided
  modes, while the proxy has a near-real spectrum with nearly identical
  guided eigenvectors. For lossless no-PML sections the proxy IS the true
  operator. Matmuls run in full float32, never TF32 (``full_f32_matmul``):
  the filter's noise floor is set by the float32 arithmetic.
* One filter step = eight dense 1D-derivative matmuls plus diagonal
  multiplies, batched over the whole subspace block (21 device launches,
  and 3 for the recurrence). On a CUDA device each degree bucket of the
  filter is one captured ``torch.cuda.CUDAGraph``, replayed per pass, so
  the host does not issue the ~20 launches of each step. Block
  orthonormalization is CholeskyQR2 with the k x k Cholesky on the host:
  the device does only matmuls.
* PEC is handled by **pinning** (hard-zero masks on E DOFs inside/against
  conductors) instead of the CPU path's ``eps = -1e8`` penalty diagonal,
  which would blow the spectral radius up by 1e8 and make polynomial
  filtering hopeless.
* A host float64 polish, a trusted float64 re-check and a refined-Ritz
  (or rational block-Krylov) refinement against the TRUE operator recover
  ARPACK-grade accuracy, including the small imaginary parts of n_eff from
  PML leakage or material loss, from the float32 subspace.

Routing (``use_filter_path``): ``TIDY3D_TPU_MODE_SOLVER`` = ``auto``
(the filter for planes with 2N >= 20000 when the solve's device is CUDA)
| ``filter`` (always, on the solve's device; the CPU runs it only when
forced) | ``arpack`` (never). The solve's device is the one the caller
names, else the one of the innermost ``solve_on`` scope (``web.run``
enters one with its own device), else CUDA. ``SOLVES`` counts filter
solves, ``FALLBACKS`` those that returned None (the caller then runs
ARPACK, with a warning); ``RECORDS`` holds each solve's outer iterations,
final degree and seconds (device loop, basis fetch, host polish,
refinement).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ...log import log

# subspace buffer beyond the requested modes (guards against continuum
# crowding at the filter edge and conjugate-pair splitting)
SUBSPACE_BUFFER = 8
# polynomial degree per filter application
FILTER_DEGREE = 50
# max outer (filter + Rayleigh-Ritz) iterations before falling back
MAX_OUTER = 60
# relative residual target on the wanted Ritz pairs (f32 iteration; the
# float64 refinement then squares down the remaining subspace error)
RESIDUAL_TOL = 2e-4
# the filter is compiled (here: captured) once per degree bucket
DEGREE_BUCKETS = (50, 74, 120, 200, 320, 500, 600)

SOLVES = 0
FALLBACKS = 0
RECORDS: list = []

_DEVICE = contextvars.ContextVar("tidy3d_tpu_torch_mode_device",
                                 default=None)


@contextlib.contextmanager
def solve_on(device):
    """Every mode solve inside the block that names no device of its own
    runs its device stage on ``device``."""
    token = _DEVICE.set(torch.device(device))
    try:
        yield
    finally:
        _DEVICE.reset(token)


def solve_device(device=None) -> torch.device:
    """``device`` when given, else the innermost ``solve_on`` scope's,
    else CUDA (as ``web.run``)."""
    if device is not None:
        return torch.device(device)
    scoped = _DEVICE.get()
    return scoped if scoped is not None else torch.device("cuda")


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matmuls in full precision inside the block (no TF32),
    whatever the process set outside it."""
    prev_flag = torch.backends.cuda.matmul.allow_tf32
    prev_prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev_prec)
        torch.backends.cuda.matmul.allow_tf32 = prev_flag


def make_apply_real(
    dxf: np.ndarray,
    dxb: np.ndarray,
    dyf: np.ndarray,
    dyb: np.ndarray,
    eps_x: np.ndarray,
    eps_y: np.ndarray,
    inv_eps_z: np.ndarray,
    mu_x: np.ndarray,
    mu_y: np.ndarray,
    inv_mu_z: np.ndarray,
    mask_x: np.ndarray,
    mask_y: np.ndarray,
    k0: float,
    device="cuda",
) -> Callable:
    """Real-proxy action of ``M = Pt (-(A @ B)) Pt`` on an (2, nx, ny, k)
    float32 block on ``device`` (real parts of all operator ingredients).

    The 2D kron-product operators of the CPU path factor exactly into 1D
    dense derivative matrices applied along one grid axis each::

        (Dxf kron Iy) u  ==  einsum('ij,jyk->iyk', dxf, U)
        (Ix kron Dyf) u  ==  einsum('ij,xjk->xik', dyf, U)

    With real ingredients the i-factors of the complex formulation cancel
    pairwise; the real form is::

        G  = inv_mu_z * (Dxf ey - Dyf ex)
        Hx = Dxb G / k0 + k0 eps_y * ey        (= i * hx)
        Hy = Dyb G / k0 - k0 eps_x * ex        (= i * hy)
        F  = -inv_eps_z * (Dyb Hx - Dxb Hy) / k0
        ex' = Dxf F + k0 mu_y * Hy
        ey' = Dyf F - k0 mu_x * Hx
        M(e) = (-ex', -ey')   (PEC masks applied on input and output)

    Each difference and sum rides in a matmul's accumulate (``addmm``) or
    an ``addcmul``, and the scalings by k0 are folded into the constants:
    21 device launches an application on a CUDA device (8 GEMMs, 9
    elementwise kernels, and a device-to-device copy of the accumulate
    input each ``addmm`` makes).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mode solver: the filter route runs on a CUDA device and none "
            "is available; solve with device='cpu' (forced filter) or "
            "TIDY3D_TPU_MODE_SOLVER=arpack")
    mats64 = dict(
        dxf=np.real(np.asarray(dxf)).astype(np.float64),
        dxb=np.real(np.asarray(dxb)).astype(np.float64),
        dyf=np.real(np.asarray(dyf)).astype(np.float64),
        dyb=np.real(np.asarray(dyb)).astype(np.float64),
    )
    diags64 = {
        name: np.real(np.asarray(a)).astype(np.float64)[..., None]
        for name, a in (("eps_x", eps_x), ("eps_y", eps_y),
                        ("inv_eps_z", inv_eps_z), ("mu_x", mu_x),
                        ("mu_y", mu_y), ("inv_mu_z", inv_mu_z),
                        ("mask_x", mask_x), ("mask_y", mask_y))
    }
    k0 = float(k0)
    nx, ny = diags64["eps_x"].shape[:2]
    c = diags64

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)

    dxf_t, dxb_t, dyf_t, dyb_t = (dev(mats64[n])
                                  for n in ("dxf", "dxb", "dyf", "dyb"))
    dxb_k0, dyb_k0 = dev(mats64["dxb"] / k0), dev(mats64["dyb"] / k0)
    mask = dev(np.stack([c["mask_x"], c["mask_y"]]))
    neg_mask_x, neg_mask_y = dev(-c["mask_x"]), dev(-c["mask_y"])
    inv_mu_z = dev(c["inv_mu_z"])
    k0_eps_y, neg_k0_eps_x = dev(k0 * c["eps_y"]), dev(-k0 * c["eps_x"])
    neg_inv_eps_z_k0 = dev(-c["inv_eps_z"] / k0)
    k0_mu_y, neg_k0_mu_x = dev(k0 * c["mu_y"]), dev(-k0 * c["mu_x"])

    def dy(mat, u):  # einsum('ij,xjk->xik')
        return torch.matmul(mat, u)

    def apply_m(x):
        k = x.shape[-1]
        xm = x * mask
        ex, ey = xm[0], xm[1]
        # G = inv_mu_z * (Dxf ey - Dyf ex)
        g = torch.addmm(dy(dyf_t, ex).view(nx, -1), dxf_t,
                        ey.reshape(nx, -1), beta=-1)
        g = inv_mu_z * g.view(nx, ny, k)
        hx = torch.addmm((k0_eps_y * ey).view(nx, -1), dxb_k0,
                         g.view(nx, -1)).view(nx, ny, k)
        hy = torch.addcmul(dy(dyb_k0, g), neg_k0_eps_x, ex)
        f = torch.addmm(dy(dyb_t, hx).view(nx, -1), dxb_t, hy.view(nx, -1),
                        alpha=-1).view(nx, ny, k) * neg_inv_eps_z_k0
        ex2 = torch.addmm((k0_mu_y * hy).view(nx, -1), dxf_t,
                          f.view(nx, -1)).view(nx, ny, k)
        ey2 = torch.addcmul(dy(dyf_t, f), neg_k0_mu_x, hx)
        out = torch.empty_like(x)
        torch.mul(ex2, neg_mask_x, out=out[0])
        torch.mul(ey2, neg_mask_y, out=out[1])
        return out

    def apply_np64(x):
        """Trusted host float64 evaluation of the same operator (used to
        validate device results: immune to a miscompiled device kernel)."""
        m = mats64

        def ndx(mat, u):
            return np.einsum("ij,jyk->iyk", mat, u)

        def ndy(mat, u):
            return np.einsum("ij,xjk->xik", mat, u)

        ex = x[0] * c["mask_x"]
        ey = x[1] * c["mask_y"]
        g = c["inv_mu_z"] * (ndx(m["dxf"], ey) - ndy(m["dyf"], ex))
        hx = ndx(m["dxb"], g) / k0 + k0 * c["eps_y"] * ey
        hy = ndy(m["dyb"], g) / k0 - k0 * c["eps_x"] * ex
        f = -c["inv_eps_z"] * (ndy(m["dyb"], hx) - ndx(m["dxb"], hy)) / k0
        ex2 = ndx(m["dxf"], f) + k0 * c["mu_y"] * hy
        ey2 = ndy(m["dyf"], f) - k0 * c["mu_x"] * hx
        return np.stack([-ex2 * c["mask_x"], -ey2 * c["mask_y"]])

    apply_m.apply_np64 = apply_np64
    apply_m.device = device
    apply_m.shape2d = (nx, ny)
    return apply_m


def assemble_real_proxy(dxf, dxb, dyf, dyb, eps_x, eps_y, inv_eps_z,
                        mu_x, mu_y, inv_mu_z, mask_x, mask_y, k0):
    """Sparse float64 matrix of the SAME real-proxy operator as
    :func:`make_apply_real` (flattening: component-major, then x, y
    fastest — matching ``flat()``). Used by the host polish stage: sparse
    f64 block-matvecs are cheap enough to strip the f32 iteration's
    noise-floor contamination, and, being host arithmetic, are immune to
    miscompiled device kernels."""
    import scipy.sparse as sp

    nx, ny = np.asarray(eps_x).shape
    k0 = float(k0)

    def to1d(m):
        return sp.csr_matrix(np.real(np.asarray(m, dtype=complex))
                             .astype(np.float64))

    def d(a):
        return sp.diags(np.real(np.asarray(a, dtype=complex))
                        .astype(np.float64).ravel())

    Ix, Iy = sp.identity(nx), sp.identity(ny)
    DXF = sp.kron(to1d(dxf), Iy).tocsr()
    DXB = sp.kron(to1d(dxb), Iy).tocsr()
    DYF = sp.kron(Ix, to1d(dyf)).tocsr()
    DYB = sp.kron(Ix, to1d(dyb)).tocsr()
    imz, iez = d(inv_mu_z), d(inv_eps_z)
    gx = -imz @ DYF
    gy = imz @ DXF
    hx_x = DXB @ gx / k0
    hx_y = DXB @ gy / k0 + k0 * d(eps_y)
    hy_x = DYB @ gx / k0 - k0 * d(eps_x)
    hy_y = DYB @ gy / k0
    f_x = -iez @ (DYB @ hx_x - DXB @ hy_x) / k0
    f_y = -iez @ (DYB @ hx_y - DXB @ hy_y) / k0
    ex2_x = DXF @ f_x + k0 * d(mu_y) @ hy_x
    ex2_y = DXF @ f_y + k0 * d(mu_y) @ hy_y
    ey2_x = DYF @ f_x - k0 * d(mu_x) @ hx_x
    ey2_y = DYF @ f_y - k0 * d(mu_x) @ hx_y
    m = -sp.bmat([[ex2_x, ex2_y], [ey2_x, ey2_y]])
    p = sp.bmat([[d(mask_x), None], [None, d(mask_y)]])
    return (p @ m @ p).tocsr()


def _ordered_real_eig(hp):
    """Descending-order eigendecomposition of a real near-symmetric
    matrix, returning a REAL basis. The projected operator is only
    near-symmetric (diagonal material scalings break symmetry), so
    clustered continuum columns can produce complex-conjugate eigenpairs;
    naively taking ``eigvecs.real`` DUPLICATES the pair's real part and
    DROPS a direction — the whole basis shifts by one and the top mode is
    lost (observed as order-dependent test flakiness). Conjugate pairs
    contribute their real 2D invariant-plane basis [Re v, Im v] instead.
    """
    theta, s = np.linalg.eig(hp)
    order = np.argsort(-theta.real)
    theta, s = theta[order], s[:, order]
    n = len(theta)
    s_real = np.zeros(s.shape, dtype=np.float64)
    j = 0
    while j < n:
        if theta[j].imag == 0.0:
            s_real[:, j] = s[:, j].real
            j += 1
        elif (j + 1 < n and abs(theta[j + 1] - np.conj(theta[j]))
              <= 1e-8 * max(abs(theta[j]), 1.0)):
            a, b = s[:, j].real, s[:, j].imag
            s_real[:, j] = a / max(np.linalg.norm(a), 1e-300)
            s_real[:, j + 1] = b / max(np.linalg.norm(b), 1e-300)
            j += 2
        else:  # unpaired complex eigenvalue: keep the real part
            s_real[:, j] = s[:, j].real
            j += 1
    return theta.real.copy(), s_real


def _cholqr2_host(v):
    """Column orthonormalization via CholeskyQR2: two gram+triangular-solve
    passes (BLAS3 zherk/ztrsm) instead of LAPACK Householder QR — several
    times faster on slow hosts for tall-skinny blocks, with f64 grams
    reaching ~1e-12 orthogonality after the second pass. Falls back to
    np.linalg.qr if the gram loses positive-definiteness (rank-deficient
    input)."""
    for _ in range(2):
        g = v.conj().T @ v
        g = g + (1e-14 * np.trace(g).real) * np.eye(g.shape[0])
        try:
            el = np.linalg.cholesky(g)
        except np.linalg.LinAlgError:
            q, _ = np.linalg.qr(v)
            return q
        v = np.linalg.solve(el.conj(), v.T).T
    return v


def _extend_orthonormal(w, b):
    """Orthonormal basis of span([w, b]) given orthonormal ``w``: block
    Gram-Schmidt (two projection passes) + CholeskyQR2 of the remainder,
    dropping near-dependent columns. Avoids a tall Householder QR of the
    concatenated block, which is both slow on weak hosts and numerically
    poisoned when ``b`` is nearly inside span(w) (converged eigenpairs:
    M v ~ theta v)."""
    for _ in range(2):
        b = b - w @ (w.conj().T @ b)
    norms = np.linalg.norm(b, axis=0)
    scale = max(float(norms.max()), 1e-300)
    keep = norms > 1e-10 * scale
    if not np.any(keep):
        return w
    b = _cholqr2_host(b[:, keep] / norms[keep])
    return np.concatenate([w, b], axis=1)


def _host_cheb_filter(m, x, lo, cut, lam_amp, degree):
    """Float64 scaled Chebyshev filter (same recurrence as the device
    version) with a scipy sparse operator."""
    e = (cut - lo) / 2.0
    c = (cut + lo) / 2.0
    sigma1 = e / (lam_amp - c)
    xp = x
    y = (m @ x - c * x) * (sigma1 / e)
    sig = sigma1
    for _ in range(degree - 1):
        sig_new = 1.0 / (2.0 / sigma1 - sig)
        yn = (m @ y - c * y) * (2.0 * sig_new / e) - (sig * sig_new) * xp
        xp, y, sig = y, yn, sig_new
    return y


def filter_coefs(lo, cut, lam_amp, degree) -> np.ndarray:
    """The scalars of the scaled Chebyshev recurrence of ``degree`` steps:
    ``[-c, sigma1 / e]`` then, for each later step, ``[2 sig' / e,
    -sig sig']`` (the sigma recurrence in float64 on the host)."""
    e = (cut - lo) / 2.0
    c = (cut + lo) / 2.0
    sigma1 = e / (lam_amp - c)
    coefs = np.empty(2 * degree, dtype=np.float64)
    coefs[0], coefs[1] = -c, sigma1 / e
    sig = sigma1
    for j in range(1, degree):
        sig_new = 1.0 / (2.0 / sigma1 - sig)
        coefs[2 * j], coefs[2 * j + 1] = 2.0 * sig_new / e, -sig * sig_new
        sig = sig_new
    return coefs


def _filter_steps(apply_m2, x, coefs, degree):
    """The recurrence on the device: ``coefs`` is a float32 tensor of
    :func:`filter_coefs` (3 launches a step beside the operator's)."""
    neg_c = coefs[0]
    y = torch.addcmul(apply_m2(x), x, neg_c) * coefs[1]
    for j in range(1, degree):
        yn = torch.addcmul(
            torch.addcmul(apply_m2(y), y, neg_c) * coefs[2 * j],
            x, coefs[2 * j + 1])
        x, y = y, yn
    return y


def _chebyshev_filter(apply_m2, x, lo, cut, lam_amp, degree):
    """Scaled Chebyshev filter (Zhou-Saad): damp eigvals in [lo, cut],
    amplify above, normalized so the component at ``lam_amp`` stays O(1)."""
    coefs = torch.as_tensor(filter_coefs(lo, cut, lam_amp, degree),
                            dtype=x.dtype, device=x.device)
    return _filter_steps(apply_m2, x, coefs, degree)


_CAPTURE_STREAMS = {}
# one capture at a time in the process: captures share their device's side
# stream, and a solve on another thread (a ``Batch`` job) may capture too
_CAPTURE_LOCK = threading.Lock()


def _capture_stream(device) -> "torch.cuda.Stream":
    """The one side stream of ``device`` on which every filter graph warms
    up and is captured: the GEMM library keeps a workspace per stream for
    the life of the process, so a stream per graph would hold one each."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


class _GraphFilter:
    """One ``torch.cuda.CUDAGraph`` of the whole filter pass per degree
    bucket (the counterpart of the reference's one jit per bucket): the
    block and the recurrence's scalars are copied into static buffers, the
    graph replays, the result is copied out."""

    def __init__(self, apply_m2, shape, device):
        self.apply = apply_m2
        self.x = torch.zeros(shape, dtype=torch.float32, device=device)
        self.graphs = {}

    def __call__(self, x, lo, cut, lam_amp, degree):
        entry = self.graphs.get(degree)
        if entry is None:
            coefs = torch.zeros(2 * degree, dtype=torch.float32,
                                device=self.x.device)
            with _CAPTURE_LOCK:
                # warm-up on the capture stream (library handles,
                # workspaces)
                side = _capture_stream(self.x.device)
                side.wait_stream(torch.cuda.current_stream(self.x.device))
                with torch.cuda.stream(side):
                    _filter_steps(self.apply, self.x, coefs, 2)
                torch.cuda.current_stream(self.x.device).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                # thread-local: what other threads run on the card meanwhile
                # (another job's time loop) leaves the capture valid
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    out = _filter_steps(self.apply, self.x, coefs, degree)
            entry = self.graphs[degree] = (graph, coefs, out)
        graph, coefs, out = entry
        coefs.copy_(torch.as_tensor(filter_coefs(lo, cut, lam_amp, degree),
                                    dtype=torch.float32))
        self.x.copy_(x)
        graph.replay()
        return out.clone()


def _rational_refine(m_host, sigma, v_start, theta0, num_modes, lam_hi,
                     lam_edge, tol, debug):
    """Refine proxy eigenpairs against the TRUE (PML-stretched / lossy)
    operator with ONE sparse factorization + a few rational block-Krylov
    sweeps.

    The real-proxy subspace cannot represent the complex-stretched PML
    tail of the true eigenvectors (measured: best in-span residual
    saturates at the percent level — the mode amplitude entering the
    PML). The correction requires resolvent directions. One complex LU at
    the user's target shift plus m sweeps V <- (M - sigma)^-1 V gives a
    rational Krylov space over which per-anchor REFINED Ritz extraction
    (residual-minimizing, immune to non-normal RR mixing) converges the
    guided pairs; the device filter's role is the high-quality start that
    cuts the solve count from ARPACK's hundreds to ~tens.
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    n = m_host.shape[0]
    nsel = v_start.shape[1]
    t_lu0 = time.time()
    # place the factorization shift at the centroid of the WANTED proxy
    # Ritz values, not the user's target ((n_target k0)^2, typically at
    # the top of the window): per-sweep contraction of pair theta_j is
    # ~|theta_j - sigma| / |theta_unwanted - sigma|, and the user shift
    # was measured at ~0.8/sweep for the second mode vs ~0.1-0.3 from the
    # centroid. The proxy anchors are already accurate to ~1e-2 relative,
    # plenty for shift placement.
    anchors = np.real(np.asarray(theta0[:num_modes], dtype=complex))
    if anchors.size and np.all(np.isfinite(anchors)):
        sigma = complex(np.mean(anchors))
    a_shift = (m_host - sigma * sp.identity(n, dtype=complex,
                                            format="csr")).tocsc()
    # TIDY3D_TPU_MODE_LU64=0 opts into a COMPLEX64 factorization: ~2x
    # faster per factor/solve, but it FLOORS the c64 Krylov span quality
    # so the sweep loop stalls below tol and runs to its cap — double
    # precision stays the default.
    _lu64 = os.environ.get("TIDY3D_TPU_MODE_LU64", "1") == "1"
    lu = spl.splu(a_shift if _lu64 else a_shift.astype(np.complex64))
    if debug:
        print(f"rational refine: LU {time.time() - t_lu0:.1f}s "
              f"(shift {sigma:.4g}, "
              f"{'c128' if _lu64 else 'c64'})")
    scale_floor = 0.05 * abs(float(lam_hi))
    v = v_start
    theta = np.asarray(theta0, dtype=complex).copy()
    vals = np.zeros(nsel, dtype=complex)
    rel = np.full(nsel, np.inf)
    coefs = None
    w_basis = _cholqr2_host(np.asarray(v_start, dtype=complex))
    mw = m_host @ w_basis
    for sweep in range(6):
        t_sw = time.time()
        v_in = np.ascontiguousarray(v)
        if not _lu64:
            v_in = v_in.astype(np.complex64)
        v = lu.solve(v_in).astype(complex)
        v = v / np.maximum(np.linalg.norm(v, axis=0, keepdims=True), 1e-300)
        n_old = w_basis.shape[1]
        w_basis = _extend_orthonormal(w_basis, v)
        if w_basis.shape[1] > n_old:  # M only on the newly-added columns
            mw = np.concatenate(
                [mw, m_host @ w_basis[:, n_old:]], axis=1)
        z = _extend_orthonormal(w_basis, mw)
        zw = z.conj().T @ w_basis
        zmw = z.conj().T @ mw
        coefs = np.zeros((w_basis.shape[1], nsel), dtype=complex)
        for j in range(nsel):
            th = complex(theta[j])
            for _ in range(3):
                _, _, vh = np.linalg.svd(zmw - th * zw,
                                         full_matrices=False)
                coef = vh[-1].conj()
                v_z = zw @ coef
                th = complex((v_z.conj() @ (zmw @ coef))
                             / max(float((v_z.conj() @ v_z).real), 1e-300))
            vals[j] = th
            v_norm = max(float(np.linalg.norm(zw @ coef)), 1e-300)
            rel[j] = (np.linalg.norm(zmw @ coef - th * (zw @ coef))
                      / v_norm / max(abs(th), scale_floor))
            coefs[:, j] = coef
            theta[j] = th
        if debug:
            print(f"rational refine sweep {sweep} ({time.time() - t_sw:.1f}s)"
                  f": vals={np.round(vals, 4)} rel={np.round(rel, 8)}")
        # every pair the caller will RETURN (the first num_modes anchors,
        # descending) converges to full tol — including below-edge leaky
        # pairs, whose n_eff the user still reads; only the extra buffer
        # anchors get the loose gate (their job is just span enrichment)
        tol_j = np.where(np.arange(nsel) < num_modes, tol, 50.0 * tol)
        if np.all(rel < tol_j):
            break
    cand = w_basis @ coefs
    cand /= np.maximum(np.linalg.norm(cand, axis=0, keepdims=True), 1e-300)
    return vals, cand, rel


def chebyshev_eigs(
    apply_real: Callable,
    shape2d: Tuple[int, int],
    num_modes: int,
    lam_hi: float,
    m_host,
    degree: int = FILTER_DEGREE,
    tol: float = None,
    seed: int = 0,
    lam_edge: float = 0.0,
    m_proxy=None,
    sigma: float = None,
    true_is_real: bool = True,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Top-of-spectrum eigenpairs of the mode operator, matrix-free.

    Parameters
    ----------
    apply_real : real-proxy block operator from :func:`make_apply_real`
        (its ``device`` is where the filter runs).
    shape2d : (nx, ny) plane shape.
    num_modes : wanted eigenpair count.
    lam_hi : upper bound of the physical spectrum ((n_max k0)^2).
    m_host : scipy sparse TRUE operator (complex ok) for Rayleigh-Ritz,
        residual control, and the float64 refinement.
    lam_edge : radiation-continuum edge ((n_clad k0)^2). Ritz pairs ABOVE
        the edge are truly guided (isolated eigenvalues) and must converge
        to ``tol``; pairs below it sample the discretized radiation
        continuum, which clusters so densely that driving each column to
        ``tol`` can take unbounded filter work at large planes — they only
        need loose convergence, and the final Rayleigh-Ritz refinement
        against the true operator recovers their values quadratically.

    tol : relative residual target (None: ``RESIDUAL_TOL`` at the call).

    Returns ``(vals, vecs)`` with vecs (2N, k) numpy complex128, or ``None``
    if the iteration failed to converge (caller falls back to ARPACK);
    ``SOLVES`` and ``FALLBACKS`` count both, ``RECORDS`` gets the solve's
    iterations, degree and seconds, and for a fallback its ``reason``.
    """
    global SOLVES, FALLBACKS
    SOLVES += 1
    tol = RESIDUAL_TOL if tol is None else tol
    record = {"shape": tuple(shape2d), "num_modes": int(num_modes),
              "device": str(apply_real.device), "fallback": False}
    t0 = time.perf_counter()
    with full_f32_matmul():
        out = _chebyshev_eigs(apply_real, shape2d, num_modes, lam_hi,
                              m_host, degree, tol, seed, lam_edge, m_proxy,
                              sigma, true_is_real, record)
    record["total_s"] = time.perf_counter() - t0
    if out is None:
        FALLBACKS += 1
        record["fallback"] = True
    RECORDS.append(record)
    return out


def _chebyshev_eigs(apply_real, shape2d, num_modes, lam_hi, m_host, degree,
                    tol, seed, lam_edge, m_proxy, sigma, true_is_real,
                    record):
    nx, ny = shape2d
    n2 = 2 * nx * ny
    device = apply_real.device
    f32 = torch.float32
    # the subspace must (nearly) contain every continuum state above the
    # lowest kept Ritz value, or the below-edge columns keep leaking into
    # un-basised neighbors and their residuals never fall (the radiation
    # continuum densifies with plane size). Block-matvec cost is almost
    # flat in column count, so buy invariance with width.
    k_sub = min(num_modes + SUBSPACE_BUFFER + int(0.1 * np.sqrt(n2)),
                64, n2 - 2)
    record["k_sub"] = k_sub

    def flat(xb):  # (2, nx, ny, k) -> (2N, k)
        return xb.reshape(n2, -1)

    def unflat(xm):  # (2N, k) -> (2, nx, ny, k)
        return xm.reshape(2, nx, ny, -1)

    def apply_block(q):
        return flat(apply_real(unflat(q)))

    # the filter degree adapts as the cut rises (pass-band shrinks); one
    # filter per degree BUCKET (a captured graph on a CUDA device)
    graph = _GraphFilter(apply_block, (n2, k_sub), device) \
        if device.type == "cuda" else None

    def filt(x, lo_, cut_, amp_, deg):
        deg_q = next((b for b in DEGREE_BUCKETS if b >= deg),
                     DEGREE_BUCKETS[-1])
        record["passes"] = record.get("passes", 0) + 1
        record["steps"] = record.get("steps", 0) + deg_q
        if graph is not None:
            return graph(x, lo_, cut_, amp_, deg_q)
        return _chebyshev_filter(apply_block, x, lo_, cut_, amp_, deg_q)

    def to_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=f32,
                               device=device)

    # --- spectral lower bound by power iteration (dominant = most negative)
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn((n2, 1), generator=gen, dtype=f32).to(device)
    lam = None
    for _ in range(25):
        w = apply_block(v)
        lam = (v.T @ w)[0, 0]
        v = w / torch.linalg.norm(w)
    lam_dom = float(lam)
    # SAFE lower bound: eigenvalues below ``lo`` get explosively amplified
    # by the filter (|T_m| blows up on BOTH sides of the interval), so an
    # under-estimate is fatal. The infinity-norm (max abs row sum) bounds
    # the spectral radius and covers the non-normal pseudospectral bulge;
    # the power iterate refines nothing below it but catches a pathological
    # norm bound. Bound the PROXY when available (it is the iterated
    # operator, and m_host may carry the 1e8 PEC penalty diagonal that
    # would blow the interval up 1e8x). Computed from raw data/indptr:
    # scipy's ``m.real`` shares a strided VIEW of the complex data and
    # canonicalization inside ``abs()``/``sum()`` would permute it in
    # place, CORRUPTING m_host (real parts reordered, imaginary parts not).
    m_csr = (m_proxy if m_proxy is not None else m_host).tocsr()
    rows = np.repeat(np.arange(m_csr.shape[0]), np.diff(m_csr.indptr))
    row_sums = np.bincount(rows, weights=np.abs(m_csr.data),
                           minlength=m_csr.shape[0])
    lo_gersh = -float(row_sums.max()) if m_csr.nnz else 0.0
    lo = min(lam_dom * 1.05, lo_gersh, -abs(lam_hi))
    if not np.isfinite(lo):
        record["reason"] = "non-finite spectral bound"
        return None
    # degree scales with the filter sharpness requirement: amplification per
    # pass goes as exp(2 m sqrt(2 d / span)) with d ~ O(lam_hi) the guided
    # gap and span ~ |lo|
    degree = max(degree, int(3.0 * np.sqrt(abs(lo) / abs(lam_hi))))
    record.update(lo=lo, lam_hi=float(lam_hi))
    debug = os.environ.get("TIDY3D_TPU_MODE_DEBUG") == "1"
    if debug:
        print(f"mode filter: lo={lo:.3e} (power {lam_dom:.3e}, "
              f"gershgorin {lo_gersh:.3e}), lam_hi={lam_hi:.3e}, "
              f"degree={degree}, k_sub={k_sub}, device={device}")

    def cholqr2(x):
        """Orthonormalize columns: device Gram matmuls + host k x k
        Cholesky (all heavy ops are matmuls; no device factorization).
        None where the float32 Gram is not positive definite (the filter
        collapsed the block's rank: a plane with fewer propagating states
        than the block), so that the solve falls back to ARPACK; the
        reference's ``cholqr2`` raises ``LinAlgError`` there."""
        for _ in range(2):
            g = (x.T @ x).cpu().numpy().astype(np.float64)
            g += 1e-10 * np.trace(g) * np.eye(g.shape[0])
            try:
                r = np.linalg.cholesky(g).T
            except np.linalg.LinAlgError:
                return None
            r_inv = np.linalg.inv(r)
            x = x @ to_dev(r_inv)
        return x

    def resid_dev(q, wq, s_sel, th):
        """Per-column residual norms of the selected Ritz pairs, computed
        on device — only ``num_modes`` scalars cross to the host instead
        of the two (2N, k_sub) blocks."""
        r = wq @ s_sel - (q @ s_sel) * th
        return torch.sqrt(torch.sum(r * r, dim=0))

    # --- filtered subspace iteration with adaptive cut
    x = torch.randn((n2, k_sub), generator=gen, dtype=f32).to(device)
    cut = 0.0  # initial: damp everything evanescent (beta^2 < 0)
    lam_amp = float(lam_hi)
    q = None
    theta = s = None
    resid = np.array([np.inf])
    best = np.inf
    stall = 0
    t_loop0 = time.perf_counter()
    n_outer = 0
    for _ in range(MAX_OUTER):
        n_outer += 1
        x = filt(x, lo, cut, lam_amp, degree)
        q = cholqr2(x)
        if q is None:
            record["reason"] = "rank-deficient block (cholqr2)"
            log.warning("device Chebyshev mode eigensolver: the filtered "
                        "block lost rank (fewer propagating states than "
                        "its %d columns); falling back to ARPACK." % k_sub)
            return None
        # Rayleigh-Ritz against the DEVICE operator itself: the f32 iterate
        # can only converge in the device operator's own geometry — Ritz
        # values/residuals measured against the exact host operator are
        # polluted by sigma_max(M) * (f32 representation error) and never
        # pass a tight tolerance. The true operator enters in the final
        # float64 block-Krylov refinement below, which also recovers the
        # complex (PML/loss) parts the real proxy cannot carry.
        wq = apply_block(q)
        hp = (q.T @ wq).cpu().numpy().astype(np.float64)
        theta, s = _ordered_real_eig(hp)
        resid = resid_dev(q, wq, to_dev(s[:, :num_modes]),
                          to_dev(theta[:num_modes])
                          ).cpu().numpy().astype(np.float64)
        # per-pair relative residual; guided beta^2 ~ lam_hi sets the floor
        scale = np.maximum(np.abs(theta[:num_modes]),
                           0.05 * abs(float(lam_hi)))
        # strict tolerance only above the continuum edge (guided modes);
        # below-edge columns chase a dense cluster and need only enough
        # accuracy for the final true-operator refinement to lock them in
        guided = theta[:num_modes] > lam_edge
        tol_vec = np.where(guided, tol, 50.0 * tol)
        if debug:
            print(f"mode filter: ritz={np.round(theta[:num_modes], 3)} "
                  f"resid={np.round(resid / scale, 7)} cut={cut:.3e} "
                  f"guided={guided.astype(int)}")
        if np.all(resid < tol_vec * scale):
            break
        # plateau detection: stop burning filter passes when progress
        # stalls and hand off to the f64 refinement (gated by the trusted
        # re-check). Patience is deliberately generous: early iterations
        # legitimately stall while the adaptive cut is still rising out of
        # the continuum (aborting at the first plateau froze the basis at
        # O(1) residuals and pushed ALL convergence work onto the
        # 10-100x-slower host stages).
        worst = float(np.max(resid / (tol_vec * scale)))
        if worst < best / 1.05:
            best, stall = min(best, worst), 0
        else:
            stall += 1
            if stall >= 12:
                if debug:
                    print(f"mode filter: plateau at {worst:.2f}x tol; "
                          "handing off to f64 refinement")
                break
        # adapt the damping edge to the first UNWANTED Ritz value
        # (Zhou-Saad practice: cut at theta[nev]). Using the bottom of the
        # whole basis (theta[k_sub-1]) is wrong at large planes: the
        # discretized radiation continuum holds more states than k_sub, so
        # the basis bottom never climbs out of it and the cut stays pinned
        # at its initial value — zero selectivity among the top states.
        # MONOTONE: Cauchy interlacing (theta[j] <= lam_j(true)) makes a
        # rising cut always safe for modes above index j.
        j_cut = min(num_modes + 4, k_sub - 1)
        cut_new = float(min(theta[j_cut], 0.92 * theta[num_modes - 1]))
        cut = min(max(cut_new, cut), lam_hi * 0.95)
        lam_amp = float(max(theta[0], lam_hi))
        # filter sharpness must track the shrinking pass band: the
        # amplification of a mode at distance d above the cut goes as
        # exp(2 m sqrt(2 d / e)) with e ~ (cut - lo)/2 the damp half-width
        # — fix the per-pass gain instead of the degree
        d_gap = max(float(lam_hi) - max(cut, 0.0), 0.05 * abs(float(lam_hi)))
        degree = int(min(max(degree, 2.2 * np.sqrt(abs(lo) / d_gap)), 600))
        x = q
    record.update(outer=n_outer, degree=degree)
    if q is None or not np.all(np.isfinite(theta)):
        record["reason"] = "non-finite basis"
        log.warning("device Chebyshev mode eigensolver produced a "
                    "non-finite basis; falling back to ARPACK.")
        return None
    # ONE bulk device->host fetch of the final basis (the loop above keeps
    # every per-iteration block on the device)
    t0 = time.perf_counter()
    q_np = q.cpu().numpy().astype(np.float64)
    t_fetch = time.perf_counter() - t0
    record.update(device_s=t0 - t_loop0, fetch_s=t_fetch)
    if debug:
        print(f"mode filter: {n_outer} outer iters in "
              f"{record['device_s']:.1f}s; basis fetch {t_fetch:.1f}s")

    rational_path = not true_is_real and sigma is not None
    t_polish0 = time.perf_counter()
    # --- host f64 polish: the f32 device iteration bottoms out at a noise
    # floor ~eps32 * ||M|| per pass (re-injected into every eigendirection
    # each matvec), which at large planes leaves O(1e-2) contamination in
    # deep-negative directions — visible as O(1) relative residuals no
    # polynomial work in f32 can remove. A few float64 filter passes on the
    # sparse proxy (noise floor eps64 * ||M|| ~ 1e-11) strip it: content
    # below the basis floor is damped ~1e4x per pass while the in-basis
    # span is resolved exactly by the f64 Rayleigh-Ritz.
    # the rational-refinement (PML/lossy) path only consumes the leading
    # nsel anchor columns (the resolvent sweeps build the rest of the
    # search space), so the host polish runs on just those columns there,
    # with a lighter filter: its job is only to clean the anchors enough
    # that they stay DISTINCT (unpolished f32 anchors were observed
    # collapsing onto one continuum pair, starving the dedup).
    nsel = min(num_modes + 4, k_sub)
    if m_proxy is not None:
        ncols = min(nsel + 4, k_sub) if rational_path else k_sub
        n_pass = 3 if rational_path else 5
        deg_p = 50 if rational_path else 80
        xb = np.asarray(q_np @ s[:, :ncols], dtype=np.float64)
        lam_amp_p = float(max(theta[0], lam_hi))
        for it in range(n_pass):
            w = m_proxy @ xb
            hp = xb.T @ w
            theta_p, s_rot = _ordered_real_eig(hp)
            resid_blk = (w @ s_rot[:, :num_modes]
                         - (xb @ s_rot[:, :num_modes]) * theta_p[:num_modes])
            resid = np.linalg.norm(resid_blk, axis=0)
            scale = np.maximum(np.abs(theta_p[:num_modes]),
                               0.05 * abs(float(lam_hi)))
            guided_p = theta_p[:num_modes] > lam_edge
            tol_p = np.where(guided_p, tol, 50.0 * tol)
            if debug:
                print(f"mode polish: ritz={np.round(theta_p[:num_modes], 4)} "
                      f"resid={np.round(resid / scale, 8)}")
            xb = xb @ s_rot  # eigen-order the basis
            theta = np.concatenate([theta_p, theta[ncols:]]) \
                if ncols < len(theta) else theta_p
            if np.all(resid < tol_p * scale):
                break
            cut_p = float(theta_p[ncols - 1]) - 0.01 * abs(lo)
            xb = _host_cheb_filter(m_proxy, xb, lo, cut_p, lam_amp_p,
                                   degree=deg_p)
            xb = _cholqr2_host(xb)
        q_np = xb
        s = np.eye(ncols)
    record["polish_s"] = time.perf_counter() - t_polish0
    if debug:
        print(f"mode filter: host f64 polish {record['polish_s']:.1f}s")

    guided64 = theta[:num_modes] > lam_edge
    tol_vec = np.where(guided64, tol, 50.0 * tol)

    # --- float64 block-Krylov Rayleigh-Ritz refinement on the host operator:
    # the heavy iteration stayed on device.
    # trusted-arithmetic gate: re-verify the converged Ritz pairs with a
    # HOST float64 numpy evaluation of the same proxy operator. This is
    # immune to a miscompiled device kernel and to pseudospectral deception
    # of residuals measured with the same engine that produced the basis.
    # the pre-refinement gate only applies when the polish ran (real path):
    # on the rational path the basis intentionally skips the polish — its
    # ~1e-2 noise-floor contamination is damped by the resolvent sweeps
    # (components at theta_noise shrink by |theta_noise - sigma|^-1, a
    # ~1e3x suppression for the deep-negative bulk) and every residual the
    # refinement reports is computed in host float64 against the host
    # sparse operator, so the trusted-arithmetic property is preserved by
    # the per-pair `keep` gate below instead.
    t_ref0 = time.perf_counter()
    if not rational_path:
        v_sel = q_np @ s[:, :num_modes]
        w64 = apply_real.apply_np64(
            v_sel.reshape(2, nx, ny, -1)).reshape(n2, -1)
        res64 = np.linalg.norm(w64 - v_sel * theta[:num_modes], axis=0)
        scale64 = np.maximum(np.abs(theta[:num_modes]),
                             0.05 * abs(float(lam_hi)))
        if debug:
            print("mode filter: trusted f64 resid "
                  f"{np.round(res64 / scale64, 7)}")
        if not np.all(np.isfinite(res64)) or np.any(
                res64 > 50 * tol_vec * scale64):
            record["reason"] = "failed the float64 re-check"
            log.warning(
                "device mode eigensolver failed the trusted float64 "
                "re-check (max rel resid %.2e); falling back to ARPACK."
                % float((res64 / scale64).max()))
            return None

    # final extraction against the TRUE operator: REFINED Ritz vectors
    # over the span of the WHOLE polished proxy block. Two non-obvious
    # choices, both forced by observed failure modes:
    # * Ordinary Rayleigh-Ritz is unusable: M is non-normal and any space
    #   containing high-energy directions lets RR mix them into the
    #   wanted pairs. Instead, anchor at each converged proxy Ritz value
    #   theta_j and take v_j = argmin_{v in span(W)} ||M v - theta_j v||
    #   (one small SVD per pair after reducing to a basis of
    #   span([W, M W])), then re-center theta_j at its Rayleigh quotient.
    #   No spurious mixing by construction.
    # * The search space must be the FULL k_sub block, not just the
    #   wanted columns (+Krylov images): the true eigenvector differs
    #   from the proxy one by the complex-stretched PML tail, whose
    #   expansion needs many moderate-k_t continuum proxy modes — the
    #   buffer columns.
    if rational_path:
        # PML-stretched / lossy true operator: the proxy span cannot carry
        # the complex tail — rational refinement with one factorization
        v_start = (q_np @ s[:, :nsel]).astype(np.complex128)
        vals_b, cand, rel_b = _rational_refine(
            m_host, sigma, v_start, theta[:nsel], num_modes, lam_hi,
            lam_edge, tol, debug)
    else:
        # real true operator (no PML, lossless): proxy == truth up to the
        # PEC-penalty representation; per-anchor REFINED Ritz over the
        # whole polished block (ordinary RR would mix in high-energy
        # directions — M is still non-normal through the penalty rows)
        w_basis = _cholqr2_host((q_np @ s).astype(np.complex128))
        mw = m_host @ w_basis
        z = _extend_orthonormal(w_basis, mw)
        zw = z.conj().T @ w_basis
        zmw = z.conj().T @ mw
        vals_b = np.zeros(nsel, dtype=complex)
        rel_b = np.zeros(nsel)
        coefs = np.zeros((w_basis.shape[1], nsel), dtype=complex)
        for j in range(nsel):
            th = complex(theta[j])
            coef = None
            for _ in range(3):  # refined Ritz + Rayleigh-quotient recenter
                b_small = zmw - th * zw
                _, _, vh = np.linalg.svd(b_small, full_matrices=False)
                coef = vh[-1].conj()
                v_z = zw @ coef
                th = complex((v_z.conj() @ (zmw @ coef))
                             / max(float((v_z.conj() @ v_z).real), 1e-300))
            vals_b[j] = th
            # exact residual in the reduced basis (M v and v both live in
            # span(Z), so the small-norm equals the full-space norm);
            # normalize by ||v|| since w_basis is only near-orthonormal
            v_norm = max(float(np.linalg.norm(zw @ coef)), 1e-300)
            res_j = np.linalg.norm(zmw @ coef - th * (zw @ coef)) / v_norm
            rel_b[j] = res_j / max(abs(th), 0.05 * abs(lam_hi))
            coefs[:, j] = coef
        cand = w_basis @ coefs
        cand /= np.maximum(np.linalg.norm(cand, axis=0, keepdims=True),
                           1e-300)
    record["refine_s"] = time.perf_counter() - t_ref0
    if debug:
        top = np.argsort(rel_b)[:6]
        print(f"refine: best pairs vals={np.round(vals_b[top], 3)} "
              f"rel={np.round(rel_b[top], 6)} ({record['refine_s']:.1f}s)")
    order = np.argsort(-vals_b.real)
    # guided pairs (above the continuum edge) must be tight; below-edge
    # radiation samples are kept at a loose gate — their exact values are
    # discretization artifacts of the continuum in both solvers. Dedup:
    # refined-Ritz anchors can collapse onto the same eigenpair.
    keep = []
    for i in order:
        if vals_b[i].real > 1.2 * abs(lam_hi):
            continue
        if rel_b[i] >= (1e-3 if vals_b[i].real > lam_edge else 5e-2):
            continue
        dup = any(abs(vals_b[i] - vals_b[j])
                  < 1e-6 * max(abs(vals_b[j]), 1.0)
                  and abs(np.vdot(cand[:, i], cand[:, j])) > 0.9
                  for j in keep)
        if not dup:
            keep.append(i)
    keep = keep[:k_sub]
    if len(keep) < num_modes:
        record["reason"] = "refinement kept too few pairs"
        log.warning(
            "device mode eigensolver refinement kept only %d/%d pairs; "
            "falling back to ARPACK." % (len(keep), num_modes))
        return None
    vals = vals_b[keep]
    vecs = cand[:, keep]
    return vals, vecs


def solver_mode() -> str:
    """'filter' | 'arpack' | 'auto' from TIDY3D_TPU_MODE_SOLVER."""
    return os.environ.get("TIDY3D_TPU_MODE_SOLVER", "auto").lower()


def use_filter_path(n2: int, has_offaxis: bool, device=None) -> bool:
    """Route the diagonal-path eigensolve to the device filter?

    auto: only when the solve's device (:func:`solve_device`) is CUDA (the
    filter is the accelerator's route; on the CPU, ARPACK's LU wins) and
    the problem is big enough to amortize the set-up. filter: always, on
    the solve's device. arpack, or an off-axis plane: never.
    """
    mode = solver_mode()
    if mode == "arpack" or has_offaxis:
        return False
    if mode == "filter":
        return True
    return solve_device(device).type == "cuda" and n2 >= 20000
