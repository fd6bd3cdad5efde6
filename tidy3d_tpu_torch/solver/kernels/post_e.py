"""The modulation and nonlinear passes after the E update in one launch.

``post_e(new_e, old_e, consts, step)`` applies to one copy's E, after its
E family and J sources, what ``tidy3d_tpu/solver/fdtd.py:1632-1688`` does:
every time-modulation entry's semi-implicit solve, then the chi3 / Kerr /
TPA fixed point (``solver/nonlinear.py`` holds the constants and the plain
version ``post_e_reference``). In the JAX package these passes are XLA code
inside the jitted step, no ``pallas_call``; here they are one hand-written
kernel, ``csrc/post_e.cu``.

Dispatch is by device: CPU tensors go to ``post_e_reference`` (new
tensors); CUDA tensors launch the kernel, which writes E' over ``new_e``'s
tensors and returns ``new_e``, or raises. A plan with more than
``MAX_ENTRIES`` modulation entries takes one launch per ``MAX_ENTRIES`` of
them, the fixed point in the last. ``LAUNCHES`` counts the calls,
``DEVICE_LAUNCHES`` the launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..lowering import E_COMPS
from ..nonlinear import mod_times, post_e_reference
from .step import STORAGE, _check_field, launch_counted

LAUNCHES = 0
DEVICE_LAUNCHES = 0
MAX_ENTRIES = 8     # modulation entries a launch takes (csrc/post_e.cu)

_P3 = ctypes.c_void_p * 3
_I3 = ctypes.c_int32 * 3
_F3 = ctypes.c_float * 3


class ModTerm(ctypes.Structure):
    """Mirror of ``struct ModTerm`` in ``csrc/post_e.cu``."""

    _fields_ = [("b", ctypes.c_void_p * 4), ("bs", ctypes.c_float * 4),
                ("has_eps", ctypes.c_int32), ("has_sig", ctypes.c_int32)]


class PostEParams(ctypes.Structure):
    """Mirror of ``struct PostEParams`` in ``csrc/post_e.cu``."""

    _fields_ = [
        ("e", _P3), ("e_old", _P3), ("nl_b", _P3), ("nl_k", _P3),
        ("mod", (ModTerm * 3) * MAX_ENTRIES),
        ("t", (ctypes.c_float * 6) * MAX_ENTRIES),
        ("nl_bs", _F3), ("nl_ks", _F3),
        ("has_b", _I3), ("has_k", _I3), ("active", _I3),
        ("num_entries", ctypes.c_int32), ("num_iters", ctypes.c_int32),
        ("n", ctypes.c_int32), ("vec", ctypes.c_int32),
    ]


def _defines(field):
    if field not in STORAGE:
        raise ValueError(f"storage type {field}: the kernel stores "
                         f"{', '.join(map(str, STORAGE))}")
    return ("T3D_FIELD_BF16",) if field == torch.bfloat16 else ()


def _library(field=torch.float32):
    from ... import _build

    lib = _build.load("post_e", _defines(field))
    fn = lib.t3d_post_e
    if fn.argtypes is None:
        _build.check_struct(lib, "t3d_post_e_params_size", PostEParams)
        size = lib.t3d_post_e_field_bytes
        size.restype = ctypes.c_int
        want = torch.empty((), dtype=field).element_size()
        if size() != want:
            raise RuntimeError(f"post_e: the library stores {size()} bytes "
                               f"a value, the storage type {want}")
        fn.argtypes = [ctypes.POINTER(PostEParams), ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def prepare(device, field=torch.float32) -> None:
    """Build and load the kernel library of the field storage type for
    ``device`` (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        _library(field)


def resources(field=torch.float32, vec: bool = True) -> dict:
    """Threads, shared bytes, blocks per SM and registers of the
    pair-aligned (``vec``) or cell-by-cell instantiation; needs the
    card."""
    from ... import _build

    _library(field)
    fn = _build.load("post_e", _defines(field)).t3d_post_e_info
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int32 * 4)()
    err = fn(int(vec), out)
    if err:
        raise RuntimeError(f"post_e resources: CUDA error {err}")
    return dict(zip(("threads", "shared_bytes", "blocks_per_sm",
                     "registers"), out))


def _coef(v, shape, name):
    """``(pointer, scalar)`` of a coefficient: a float32 map or a scalar."""
    if isinstance(v, torch.Tensor):
        return _check_field(v, shape, name).data_ptr(), 0.0
    return None, float(v)


def _post_e_cuda(new_e, old_e, consts, step):
    global LAUNCHES, DEVICE_LAUNCHES
    field = new_e[E_COMPS[0]].dtype
    shape = tuple(new_e[E_COMPS[0]].shape)
    n = shape[0] * shape[1] * shape[2]
    if n >= 2 ** 31:
        raise ValueError(f"grid {shape}: the post_e kernel takes fewer than "
                         "2^31 cells")
    device = new_e[E_COMPS[0]].device
    entries = list(consts.get("mod", ()))
    chunks = [entries[i:i + MAX_ENTRIES]
              for i in range(0, len(entries), MAX_ENTRIES)] or [[]]
    fn = _library(field)
    for ci, chunk in enumerate(chunks):
        p = PostEParams()
        p.n = n
        p.num_entries = len(chunk)
        active = [False] * 3
        for en, ce in enumerate(chunk):
            times = mod_times(ce, step)
            for j in range(6):
                p.t[en][j] = float(times[j])
            for c, comp in enumerate(E_COMPS):
                m = p.mod[en][c]
                for slot, key, flag in ((0, "Beps", "has_eps"),
                                        (2, "Bsig", "has_sig")):
                    if comp not in ce.get(key, {}):
                        continue
                    setattr(m, flag, 1)
                    active[c] = True
                    for h, v in enumerate(ce[key][comp]):
                        m.b[slot + h], m.bs[slot + h] = _coef(
                            v, shape, f"{key}{h + 1}_{comp}")
        if ci == len(chunks) - 1 and "nl" in consts:
            p.num_iters = consts["nl_num_iters"]
            for c, comp in enumerate(E_COMPS):
                for kind, has, ptr, sc in (("B", p.has_b, p.nl_b, p.nl_bs),
                                           ("K", p.has_k, p.nl_k, p.nl_ks)):
                    v = consts["nl"][kind].get(comp)
                    if v is None:
                        continue
                    has[c] = 1
                    active[c] = True
                    ptr[c], sc[c] = _coef(v, shape, f"{kind}_{comp}")
        for c, comp in enumerate(E_COMPS):
            p.active[c] = int(active[c])
            if active[c]:
                p.e[c] = _check_field(new_e[comp], shape, comp,
                                      field).data_ptr()
                p.e_old[c] = _check_field(old_e[comp], shape,
                                          f"old {comp}", field).data_ptr()
        blocks = launch_counted(fn, p, device, "post_e")
        DEVICE_LAUNCHES += blocks[1]
    LAUNCHES += 1
    return new_e


def post_e(new_e: dict, old_e: dict, consts: dict, step: int) -> dict:
    """The passes on one copy: the kernel for CUDA tensors (E' over
    ``new_e``, which it returns), the plain version for CPU tensors (a new
    dict)."""
    device = new_e[E_COMPS[0]].device
    if device.type == "cpu":
        return post_e_reference(new_e, old_e, consts, step)
    if device.type != "cuda":
        raise ValueError(f"post_e: unsupported device '{device}'")
    return _post_e_cuda(new_e, old_e, consts, step)
