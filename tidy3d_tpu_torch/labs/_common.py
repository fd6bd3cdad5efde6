"""What the labs share: the card's name and power limit, CUDA-event timing,
the roofline bound, the ctypes binding of a lab library, ptxas's register
counts and the SASS instruction classes of a kernel's loop."""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

PEAK_BYTES = 3.35e12    # H100 SXM device memory, B/s (data sheet, 700 W)
PEAK_F32 = 67e12        # H100 SXM float32 outside the tensor cores, FLOP/s
# H100 SXM5 bf16 outside the tensor cores, FLOP/s (NVIDIA H100 Tensor Core
# GPU Architecture whitepaper: 133.8 TFLOPS, twice the float32 rate)
PEAK_BF16 = 133.8e12


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn`` (CUDA events, after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(nbytes: float, flops: float, peak: float = PEAK_F32):
    """``(bound_ms, bound_by)``: the least time the card could take to move
    ``nbytes`` and do ``flops`` operations at ``peak`` FLOP/s (float32 by
    default, ``PEAK_BF16`` for bf16 arithmetic)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def need_cuda(lab: str) -> bool:
    """Whether a CUDA device is there; says so on stderr when it is not."""
    if torch.cuda.is_available():
        return True
    print(f"{lab}: no CUDA device is available", file=sys.stderr)
    return False


def library(name: str, entry: str, struct, size_fn: str):
    """The C entry point ``entry`` of ``csrc/<name>.cu``, built and loaded
    at first use, its parameter struct checked against ``struct``."""
    from .. import _build

    lib = _build.load(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        _build.check_struct(lib, size_fn, struct)
        fn.argtypes = [ctypes.POINTER(struct), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def check_cuda(t, shape, dtypes, name: str):
    """Raises unless ``t`` is a contiguous CUDA tensor of ``shape`` and one
    of ``dtypes``."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: expected {dtypes}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t


def registers(name: str) -> dict:
    """``{mangled kernel name: (registers, spill stores, spill loads)}``
    from the ptxas report of ``csrc/<name>.cu`` (built in this process or
    loaded as built)."""
    from .. import _build

    out, current = {}, None
    for line in _build.BUILDS[name].ptxas.splitlines():
        m = re.search(r"[Ff]unction properties for (\S+)", line) or \
            re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1).rstrip(":'")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current:
            regs = out.get(current, (0, 0, 0))[0]
            out[current] = (regs, int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            _, st, ld = out.get(current, (0, 0, 0))
            out[current] = (int(m.group(1)), st, ld)
    return out


def registers_of(name: str, kernel: str) -> str:
    """One line of registers and spills per instantiation of ``kernel``."""
    rows = [f"{regs} registers, spill {st}/{ld} B"
            for mangled, (regs, st, ld) in sorted(registers(name).items())
            if kernel in mangled]
    return "; ".join(rows) if rows else "not reported"


_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_BRANCH = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")


def sass_functions(sass: str) -> dict:
    """``{function name: [(address, instruction text)]}`` of a
    ``cuobjdump -sass`` listing."""
    out, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            current = m.group(1)
            out[current] = []
            continue
        m = _INSTR.search(line)
        if m and current:
            out[current].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def loop_body(instrs: list) -> list:
    """The instructions of the longest backward-branch loop: from the
    target of a backward branch to that branch."""
    best = []
    for addr, text in instrs:
        m = _BRANCH.search(text)
        if not m:
            continue
        target = int(m.group(1), 16)
        if target < addr:
            body = [t for a, t in instrs if target <= a <= addr]
            if len(body) > len(best):
                best = body
    return best


def opcode(instr: str) -> str:
    """An instruction's opcode with its modifiers, the predicate dropped."""
    return instr.split()[1] if instr.startswith("@") else instr.split()[0]


_SASS: dict = {}   # library path -> sass_functions of its cuobjdump


def sass_loop(name: str, kernel: str) -> list:
    """The opcodes of the longest loop of the kernel whose mangled name
    holds ``kernel``, from ``cuobjdump -sass`` of ``csrc/<name>.cu``'s
    library (built in this process or loaded as built; one dump a library
    and process)."""
    from .. import _build

    path = _build.BUILDS[name].path
    if path not in _SASS:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        tool = shutil.which("cuobjdump") or os.path.join(home, "bin",
                                                         "cuobjdump")
        _SASS[path] = sass_functions(subprocess.run(
            [tool, "-sass", path], capture_output=True, text=True,
            check=True, timeout=300).stdout)
    sass = _SASS[path]
    names = [f for f in sass if kernel in f]
    if len(names) != 1:
        raise ValueError(f"{kernel}: {len(names)} functions match in {name}")
    return [opcode(instr) for instr in loop_body(sass[names[0]])]


def sass_classes(name: str, kernel: str) -> dict:
    """Instruction classes of ``sass_loop(name, kernel)``: ``bf16x2``
    arithmetic (HFMA2/HMUL2/HADD2 on BF16), ``f32`` arithmetic
    (FFMA/FMUL/FADD), ``convert`` (F2F, F2FP, I2F, F2I), shared-memory
    loads ``lds`` and stores ``sts``, warp shuffles ``shfl``, the rest as
    ``other``, and ``loop``, their sum; ``memory``: every load, store,
    shuffle and barrier opcode of the loop (modifiers dropped) with its
    count."""
    out = {"bf16x2": 0, "f32": 0, "convert": 0, "lds": 0, "sts": 0,
           "shfl": 0, "other": 0}
    memory: dict = {}
    body = sass_loop(name, kernel)
    for op in body:
        base = op.split(".")[0]
        if re.match(r"(LD|ST|SHFL|ATOM|RED|BAR|UCGABAR|MEMBAR)", base):
            memory[base] = memory.get(base, 0) + 1
        if re.match(r"H(FMA|MUL|ADD)2", op) and "BF16" in op:
            out["bf16x2"] += 1
        elif re.match(r"F(FMA|MUL|ADD)\b", op):
            out["f32"] += 1
        elif re.match(r"(F2F|F2FP|I2F|F2I)\b", op):
            out["convert"] += 1
        elif base in ("LDS", "STS", "SHFL"):
            out[base.lower()] += 1
        else:
            out["other"] += 1
    out["loop"] = len(body)
    out["memory"] = memory
    return out
