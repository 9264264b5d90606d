#!/usr/bin/env python3
"""The rounds of the port's fixed-topology fit on a bench problem.

    python3 tools/fit_rounds.py [--root DIR] [--platform gpu|cpu]
                                [--repeat N] [nt|aa]

Writes chip_smoke.py's bench problem (the same seed: 128 taxa x 4096
sites under GTR+G4 for nt, LG+G4 for aa), runs the CLI fit
that chip_smoke.py drives with the phyml_tpu_torch package of the tree
at DIR (default: this checkout), on the card in float32 or on the CPU in
float64, and prints each round's lnL, then one JSON line: the
alignment's SHA-256 (equal across trees when both wrote the same
problem), the rounds, each round's lnL, the final lnL and the
wall-clock (of the first run in the process; with --repeat N the fit
runs N times in the process and `walls_s` lists each run's). Run it
on two trees, or on both platforms, to compare the trajectories of one
problem, or its wall-clock (parent, change, change, parent in one
call).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib.util
import io
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="tree holding phyml_tpu_torch")
    ap.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    ap.add_argument("--repeat", type=int, default=1,
                    help="fits run in the process (walls of each)")
    ap.add_argument("problem", nargs="?", default="nt", choices=["nt", "aa"])
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import phyml_tpu_torch
    import torch

    if not phyml_tpu_torch.__file__.startswith(root):
        sys.exit(f"fit_rounds: imported {phyml_tpu_torch.__file__}, not "
                 f"the tree at {root}")
    if args.platform == "gpu" and not torch.cuda.is_available():
        sys.exit("fit_rounds: --platform gpu needs a CUDA device")
    # this checkout's chip_smoke.py writes the problem, whatever DIR is
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from phyml_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        aln, tree = smoke.write_problem(os.path.join(tmp, args.problem),
                                        args.problem, smoke.N_TAXA,
                                        smoke.N_SITES, smoke.SEED)
        with open(aln, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()
        walls = []
        for _ in range(max(1, args.repeat)):
            out = io.StringIO()
            t = time.time()
            with contextlib.redirect_stdout(out):
                rc = cli.main(smoke.cli_argv(args.problem, aln, tree,
                                             args.platform))
            if args.platform == "gpu":
                torch.cuda.synchronize()
            walls.append(time.time() - t)
            if rc != 0:
                sys.exit(f"fit_rounds: the fit returned {rc}")
        rounds = [float(line.split("lnL")[1])
                  for line in out.getvalue().splitlines()
                  if line.startswith("  round ")]
        final = smoke.stats_lnl(aln)
    for i, lnl in enumerate(rounds):
        print(f"  round {i}: lnL {lnl:.5f}")
    print(json.dumps(dict(root=root, platform=args.platform,
                          problem=args.problem, alignment_sha256=digest,
                          rounds=len(rounds), round_lnl=rounds,
                          final_lnl=final, wall_s=walls[0],
                          walls_s=walls)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
