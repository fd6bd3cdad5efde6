"""Lab: SASS instruction counts of the k-step kernel's instantiations.

    python3 labs/kstep_sass.py [--root DIR]

Builds ``csrc/kstep.cu`` of the tree at DIR (default: the checkout that
holds this script), disassembles the library with ``cuobjdump -sass`` and
prints, per instantiation of ``kstep_kernel``, the number of SASS
instructions in the function and in its longest loop (the instructions
between the target of the last backward branch and that branch: the
march over x, with every level inlined), beside the global loads, shared
loads and barriers in that loop. Without ``ncu`` on the card's machine,
these static counts are the instruction-bound evidence. Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit), not a card.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
BRANCH = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")


def functions(sass: str) -> dict:
    """``{function name: [(address, instruction text)]}``."""
    out, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            current = m.group(1)
            out[current] = []
            continue
        m = INSTR.search(line)
        if m and current:
            out[current].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def loop_body(instrs: list) -> list:
    """The instructions of the longest backward-branch loop."""
    best = []
    for i, (addr, text) in enumerate(instrs):
        m = BRANCH.search(text)
        if not m:
            continue
        target = int(m.group(1), 16)
        if target < addr:
            body = [t for a, t in instrs if target <= a <= addr]
            if len(body) > len(best):
                best = body
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from tidy3d_tpu_torch import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = _build.load_all(["kstep"])
    path = _build.BUILDS["kstep"].path
    assert lib and os.path.dirname(path).startswith(root), path
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    for name, instrs in sorted(functions(sass).items()):
        if "kstep_kernel" not in name:
            continue
        body = loop_body(instrs)
        count = {kind: sum(bool(re.match(pat, t.split(" ", 1)[-1]
                                         if t.startswith("@") else t))
                           for t in body)
                 for kind, pat in (("LDG", r"LDG"), ("LDS", r"LDS"),
                                   ("BAR", r"BAR"), ("LDGSTS", r"LDGSTS"))}
        print(f"[sass] {name}: {len(instrs)} instructions, march loop "
              f"{len(body)} ({', '.join(f'{k} {v}' for k, v in count.items())})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
