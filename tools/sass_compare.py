#!/usr/bin/env python3
"""Compare the machine code of the ladder's kernels in two trees.

    python3 tools/sass_compare.py PARENT [--repeats N] [--show N]

Compiles the ladder's sources (`csrc/clv.cu`, `clv_slots.cu`,
`clv_slots_stream.cu`, `edotp.cu`, `edotp_stream.cu`) of the tree at
PARENT (a `git archive` of another commit) and of this checkout to
cubins with the flags `ops/_build.py` builds with, each N times
(default 3), and compares each kernel's SASS (`cuobjdump -sass`): for
every kernel of PARENT it reports whether this tree's compiles give the
same code as PARENT's, and whether two compiles of one tree agree with
each other. A kernel whose compiles of one source differ shows that the
toolchain does not reproduce it; a kernel this tree no longer has (a
rung taken off the ladder) is reported as removed; any other
difference is a change of the code, and `--show N` prints the first N
lines of its diff. Needs `nvcc` and `cuobjdump` (the CUDA toolkit);
exits nonzero without them.
"""

from __future__ import annotations

import argparse
import difflib
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from phyml_tpu_torch.ops import _build  # noqa: E402

FILES = ["clv.cu", "clv_slots.cu", "clv_slots_stream.cu", "edotp.cu",
         "edotp_stream.cu"]
# -Xptxas -v only reports; the code is the same without it
FLAGS = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]


def sass(tag, tree, name, k, out):
    """{kernel: SASS text} of compile k of tree's csrc/name, each line's
    runs of blanks made one: cuobjdump pads its columns to the widest
    instruction of the whole file, so a kernel another rung no longer
    sits beside would differ in blanks alone."""
    cub = os.path.join(out, f"{tag}_{k}_{name}.cubin")
    src = os.path.join(tree, "phyml_tpu_torch", "csrc", name)
    subprocess.run([_build._nvcc(), *FLAGS, "-cubin", "-o", cub, src],
                   check=True)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    txt = subprocess.run([cuobjdump, "-sass", cub], capture_output=True,
                         text=True, check=True).stdout
    return {part.split("\n", 1)[0].strip():
            "\n".join(" ".join(line.split())
                      for line in part.split("\n", 1)[1].splitlines())
            for part in re.split(r"\n\s*Function : ", txt)[1:]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--show", type=int, default=0,
                    help="diff lines to print of each changed kernel")
    args = ap.parse_args()
    trees = {"parent": os.path.abspath(args.parent),
             "this": os.path.dirname(os.path.dirname(
                 os.path.abspath(__file__)))}
    jobs = [(t, f, k) for t in trees for f in FILES
            for k in range(args.repeats)]
    with tempfile.TemporaryDirectory() as out, \
            ThreadPoolExecutor(min(len(jobs), os.cpu_count() or 1)) as ex:
        res = dict(zip(jobs, ex.map(
            lambda j: sass(j[0], trees[j[0]], j[1], j[2], out), jobs)))
    same = changed = unstable = removed = 0
    for f in FILES:
        base = res[("parent", f, 0)]
        for name, code in base.items():
            versions = {t: {res[(t, f, k)].get(name)
                            for k in range(args.repeats)} for t in trees}
            if versions["this"] == {None}:
                removed += 1
                print(f"{f} {name}: removed")
            elif versions["this"] == {code} and \
                    len(versions["parent"]) == 1:
                same += 1
            elif len(versions["parent"]) > 1 or len(versions["this"]) > 1:
                unstable += 1
                print(f"{f} {name}: compiles of one source differ "
                      f"(parent {len(versions['parent'])}, this "
                      f"{len(versions['this'])} versions in "
                      f"{args.repeats} compiles)")
            else:
                changed += 1
                print(f"{f} {name}: CHANGED")
                new = res[("this", f, 0)][name]
                diff = difflib.unified_diff(code.splitlines(),
                                            new.splitlines(), lineterm="",
                                            n=0)
                for line in list(diff)[2:2 + args.show]:
                    print("   ", line)
    print(f"kernels with the parent's SASS: {same}; changed: {changed}; "
          f"not reproduced by the toolchain: {unstable}; removed: "
          f"{removed}")
    return 1 if changed else 0


if __name__ == "__main__":
    sys.exit(main())
