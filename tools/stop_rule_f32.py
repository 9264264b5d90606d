#!/usr/bin/env python3
"""Does the fit's stopping rule read float32 noise in the reference too?

    python3 tools/stop_rule_f32.py [--taxa 32] [--sites 2000] [--seed S]

Writes one simulated DNA problem (chip_smoke.py's GTR+G4 simulation,
a random tree) and runs the fixed-topology fit (`-m GTR -c 4 -o lr`) on
the CPU four times: phyml_tpu's `round_optimize` with its engine in
float32 and in float64 (JAX on the CPU, its scan path), and the port's
CLI with `--float32` and in float64.  Each run is a child process (the
JAX one imports phyml_tpu, the port's imports phyml_tpu_torch; this
script imports neither).  It prints each run's per-round lnL and gain,
then one JSON line.  Both optimizers stop once a round gains less than
tol = 1e-3 (phyml_tpu/optim/round.py:296), so a float32 run whose late
gains wander around that size stops by chance.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# phyml_tpu's own CLI path (phyml_tpu/cli.py:387-509), with the rounds
# printed: model, parameters and engine as its CLI builds them
_JAX_FIT = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
f32 = sys.argv[3] == "float32"
if not f32:
    jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from phyml_tpu import cli, read_alignment
from phyml_tpu.ops.likelihood import LikelihoodEngine, tree_arrays
from phyml_tpu.optim.round import round_optimize
from phyml_tpu.topology import Topology
aln_path, tree_path = sys.argv[1], sys.argv[2]
args = cli.build_parser().parse_args(
    ["-i", aln_path, "-u", tree_path, "-m", "GTR", "-c", "4", "-o", "lr",
     "-b", "0"])
aln = read_alignment(aln_path, datatype="nt")
model = cli._build_model(args, aln)
params = cli._init_params(args, model, aln)
dtype = jnp.float32 if f32 else jnp.float64
engine = LikelihoodEngine(aln, model, dtype=dtype)
with open(tree_path) as fh:
    topo = Topology.from_newick(fh.read(), aln.names)
ta = tree_arrays(topo.rooted(), dtype=dtype)
print(f"  start: lnL {float(engine.loglik(params, ta)):.5f}")
round_optimize(engine, model, params, ta, verbose=True)
"""


def rounds_of(text: str) -> list[float]:
    return [float(line.split("lnL")[1]) for line in text.splitlines()
            if line.startswith("  round ")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--taxa", type=int, default=32)
    ap.add_argument("--sites", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke  # the simulation (numpy and the port's P(t))

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        aln, tree = chip_smoke.write_problem(os.path.join(tmp, "nt"), "nt",
                                             args.taxa, args.sites,
                                             args.seed)
        runs = {
            f"phyml_tpu {dt}": [sys.executable, "-c", _JAX_FIT, aln, tree,
                                dt] for dt in ("float32", "float64")}
        for dt, flag in (("float32", ["--float32"]), ("float64", [])):
            runs[f"port {dt}"] = [
                sys.executable, "-m", "phyml_tpu_torch.cli", "-i", aln, "-u",
                tree, "-m", "GTR", "-c", "4", "-o", "lr", "-b", "0",
                "--platform", "cpu", "--r_seed", "1", *flag]
        for name, cmd in runs.items():
            res = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                                 text=True)
            if res.returncode != 0:
                sys.exit(f"stop_rule_f32: {name} failed:\n"
                         f"{res.stderr[-3000:]}")
            lnl = rounds_of(res.stdout)
            out[name] = lnl
            gains = [b - a for a, b in zip(lnl, lnl[1:])]
            print(f". {name}: {len(lnl)} rounds, final lnL {lnl[-1]:.5f}")
            print("    gains after round 0: "
                  + " ".join(f"{g:.5f}" for g in gains), flush=True)
    print(json.dumps(dict(taxa=args.taxa, sites=args.sites, seed=args.seed,
                          round_lnl=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
