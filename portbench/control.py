#!/usr/bin/env python3
"""Read a cell's compared numbers on several seeds in one process: the
program's, and the control's through the same judging and the same
limits (the reference computed with TF32 contractions, its outputs in
the program's place).  The limits in `portbench/limits/<cell>.json` are
set from these readings.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--data-seeds 20260818,20260819]

Each seed is one run of the cell without a warm-up and with a window of
one unit; one JSON line a seed.  `--data-seeds` reads the same on other
data sets than the configuration's (every seed on each).  Needs the
card, as the benchmark does.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--data-seeds", default="")
    args = ap.parse_args(argv)
    bench = harness.manifest()
    cell, _, config, traffic, limits = harness.cell_of(bench, args.workload)
    harness.card_check(int(cell["chips"]))
    data_seeds = [int(s) for s in args.data_seeds.split(",") if s] or [None]
    for data_seed in data_seeds:
        for seed in (int(s) for s in args.seeds.split(",")):
            r = harness.run_cell(cell, config, traffic, limits, bench, seed,
                                 0.0, False, "cuda", time.perf_counter(),
                                 control=True, warm=False,
                                 data_seed=data_seed)
            print(json.dumps(harness.finite(
                {"seed": seed, "data_seed": data_seed or
                 config["data"]["data_seed"], "correct": r["correct"],
                 "compared": r["compared"], "readings": r["readings"],
                 "control": r["control"], "seconds": r["seconds"]})),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
