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
import importlib.util
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shared():
    """This checkout's ``tidy3d_tpu_torch/labs/_common.py``, loaded by path
    so that ``--root`` still picks the tree whose kernel is built."""
    path = os.path.join(HERE, "tidy3d_tpu_torch", "labs", "_common.py")
    spec = importlib.util.spec_from_file_location("_lab_common", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    shared = _shared()
    for name, instrs in sorted(shared.sass_functions(sass).items()):
        if "kstep_kernel" not in name:
            continue
        body = shared.loop_body(instrs)
        count = {kind: sum(bool(re.match(pat, shared.opcode(t)))
                           for t in body)
                 for kind, pat in (("LDG", r"LDG"), ("LDS", r"LDS"),
                                   ("BAR", r"BAR"), ("LDGSTS", r"LDGSTS"))}
        print(f"[sass] {name}: {len(instrs)} instructions, march loop "
              f"{len(body)} ({', '.join(f'{k} {v}' for k, v in count.items())})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
