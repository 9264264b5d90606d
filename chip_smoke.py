#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (phyml_tpu_torch) once on one GPU.

    python3 chip_smoke.py          # from the repository root

1. checks for a CUDA device and prints its name and power limit;
2. builds the hand-written kernels from `phyml_tpu_torch/csrc`;
3. simulates the bench problem, 128 taxa x 4096 sites under GTR+G4
   (the widths of tools/gen_bench_problem.py), from a fixed seed;
4. runs each kernel (K1 slot, K2 edge dot products, K3 dense at the
   batch sizes the optimizer uses) against its plain PyTorch version
   on the same card tensors, and K1 against a float64 evaluation;
5. checks the fixed-topology fit end to end on a small problem
   (card float32 against CPU float64);
6. runs the main path, `phyml_tpu_torch.cli -u tree -m GTR -c 4 -o lr
   -b 0 --platform gpu`, with the kernels' launch counters reset just
   before and read just after.

It prints a JSON line of per-kernel results, the card line, and as the
last line {"ok": true, "device": {...}}.  Any failure exits nonzero
before that line; so does a machine without CUDA, or a directory
without the phyml_tpu_torch package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20260817
N_TAXA, N_SITES = 128, 4096
# GTR+G4 of tools/gen_bench_problem.py:39-45
FREQS = np.array([0.3, 0.2, 0.3, 0.2])
RATES = np.array([1.2, 3.0, 0.8, 1.1, 4.0, 1.0])
ALPHA = 0.7
# tolerances, all float32 on the card (tests/test_pallas.py):
K13_TOL = 5e-4    # per-site lnL, kernel vs plain (DNA, :44)
K2_TOL = 2e-3     # per-site edge lnL terms, kernel vs plain (:218)
F64_TOL = 0.5     # total lnL, K1 float32 vs float64 scan (:104)
E2E_TOL = 0.1     # final lnL of the small fit, card f32 vs CPU f64:
#                   the two optimizers stop at slightly different
#                   points of a flat optimum
REPS = 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def simulate(topo, model, params, n_sites, rng):
    """Sequences down the rooted tree under the model (the port's own
    P(t), float64 on the CPU); returns (names, seqs)."""
    from phyml_tpu_torch.models.eigen import pmat
    import torch

    lam, V, Vinv, pi, w, _ = model.class_system(params)
    rv = topo.rooted()
    n, C, ns = rv.n_otu, lam.shape[0], lam.shape[1]
    t = torch.as_tensor(rv.node_blen)[:, None].expand(rv.n_nodes, C)
    P = pmat(lam, V, Vinv, t).numpy()
    P = np.clip(P, 0.0, None)
    P /= P.sum(-1, keepdims=True)
    cls = rng.choice(C, size=n_sites, p=w.numpy() / float(w.sum()))
    root_pi = (pi.numpy() * w.numpy()[:, None]).sum(0)
    states = np.zeros((rv.n_nodes, n_sites), dtype=np.int64)
    states[-1] = rng.choice(ns, size=n_sites, p=root_pi / root_pi.sum())
    for i in range(rv.n_internal - 1, -1, -1):     # preorder
        for c in rv.child[i]:
            cum = P[int(c), cls, states[n + i], :].cumsum(axis=1)
            r = rng.random(n_sites)[:, None]
            states[int(c)] = np.clip((r > cum).sum(axis=1), 0, ns - 1)
    names = [f"T{i:04d}" for i in range(n)]
    return names, ["".join("ACGT"[s] for s in states[i])
                   for i in range(n)]


def write_problem(dirname, n_taxa, n_sites, seed):
    import torch
    from phyml_tpu_torch.models.substitution import SubstModel
    from phyml_tpu_torch.topology import Topology

    rng = np.random.default_rng(seed)
    topo = Topology.random(n_taxa, rng, mean_blen=0.08)
    model = SubstModel(datatype="nt", name="GTR", n_classes=4,
                       freqs_mode="fixed", fixed_freqs=FREQS)
    params = model.init_params()
    params["rr_val"] = torch.log(torch.as_tensor(RATES))
    params["alpha"] = torch.tensor(ALPHA, dtype=torch.float64)
    names, seqs = simulate(topo, model, params, n_sites, rng)
    aln_path = os.path.join(dirname, "aln.phy")
    tree_path = os.path.join(dirname, "tree.nwk")
    with open(aln_path, "w") as fh:
        fh.write(f" {len(names)} {n_sites}\n")
        for nm, sq in zip(names, seqs):
            fh.write(f"{nm:<10s}  {sq}\n")
    with open(tree_path, "w") as fh:
        fh.write(topo.to_newick(names) + "\n")
    return aln_path, tree_path


def timed(fn):
    """(result, median ms over REPS runs) with CUDA events."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return out, statistics.median(ms)


def cli_argv(aln_path, tree_path, platform):
    return ["-i", aln_path, "-u", tree_path, "-m", "GTR", "-c", "4",
            "-o", "lr", "-b", "0", "--platform", platform,
            "--r_seed", "1"]


def stats_lnl(aln_path) -> float:
    with open(f"{aln_path}_phyml_stats.txt") as fh:
        for line in fh:
            if line.startswith(". Log-likelihood:"):
                return float(line.split(":")[1])
    fail("no Log-likelihood line in the stats file")


def kernel_phases(aln_path, tree_path, cuda):
    """Each kernel against its plain version on the same card tensors
    at the main path's shapes; returns the kernels' JSON entries
    (launches filled in later)."""
    import torch
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.ops import clv, clv_slots, edotp
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.optim.round import _batched_params, free_scalar_slots
    from phyml_tpu_torch.topology import Topology

    aln = read_alignment(aln_path, datatype="nt")
    args = cli.build_parser().parse_args(cli_argv(aln_path, tree_path,
                                                  "gpu"))
    model = cli._build_model(args, aln)
    params = cli._init_params(args, model, aln)
    params["rr_val"] = torch.log(torch.as_tensor(RATES))
    params["alpha"] = torch.tensor(ALPHA, dtype=torch.float64)
    with open(tree_path) as fh:
        rv = Topology.from_newick(fh.read(), aln.names).rooted()
    eng = LikelihoodEngine(aln, model, dtype=torch.float32, device=cuda)
    tree = tree_arrays(rv, dtype=torch.float32, device=cuda)
    sys_ = eng.system_of(params)
    lam, V, Vinv, pi, w, pinv = sys_
    pm = eng._pmats(lam, V, Vinv, tree.blen)
    child, sched = eng._topology(tree.child)
    logw = eng._logw(w)
    k = aln.n_patterns
    print(f". problem: {aln.n_otu} taxa, {aln.n_sites} sites, {k} "
          f"patterns, C={eng.C}")
    rows = []

    def row(name, src, replaces, err, ms, plain_ms, tol):
        print(f". {name}: max|d|={err:.3e} (tol {tol:g})  kernel "
              f"{ms:.3f} ms  plain {plain_ms:.3f} ms")
        if not (err <= tol):
            fail(f"{name} disagrees with its plain version: {err} > {tol}")
        rows.append(dict(name=name, route="cuda",
                         source=f"phyml_tpu_torch/csrc/{src}",
                         replaces=replaces, launches=0,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms))

    # K1: every host lnL
    args1 = (sched, eng.tips, pm, pi, logw)
    got, ms = timed(lambda: clv_slots.uppass_site_lse_slots(
        *args1, n_slots=eng.slot_count))
    ref, pms = timed(lambda: clv_slots.uppass_site_lse_slots_plain(
        *args1, n_slots=eng.slot_count))
    row("K1 uppass_site_lse_slots", "clv_slots.cu",
        "phyml_tpu/ops/pallas_clv_slots.py:139",
        float((got - ref).abs().max()), ms, pms, K13_TOL)
    lnl32 = float(torch.sum(got.double() * eng.weights))
    eng64 = LikelihoodEngine(aln, model, dtype=torch.float64, device=cuda)
    tree64 = tree_arrays(rv, dtype=torch.float64, device=cuda)
    lnl64 = float(torch.sum(eng64.site_logliks_scan(
        eng64.system_of(params), tree64) * eng64.weights))
    print(f". K1 lnL {lnl32:.6f} vs float64 scan {lnl64:.6f}")
    if not abs(lnl32 - lnl64) <= F64_TOL:
        fail(f"K1 lnL off the float64 evaluation by {lnl32 - lnl64}")

    # K3: backtracking probes (one system) and the line-search grid
    # (n_slots x (grid + 1) systems in one launch)
    got, ms = timed(lambda: clv.uppass_site_lse(child, eng.tips, pm, pi,
                                                logw))
    ref, pms = timed(lambda: clv.uppass_site_lse_plain(
        child, eng.tips, pm[None], pi[None], logw[None])[0])
    row("K3 uppass_site_lse (B=1)", "clv.cu",
        "phyml_tpu/ops/pallas_clv.py:62",
        float((got - ref).abs().max()), ms, pms, K13_TOL)
    slots = free_scalar_slots(model, params)
    B = len(slots) * 13                        # optimize_scalars grid=12
    rng = np.random.default_rng(SEED)
    S = np.asarray([[rng.uniform(max(lo, -3.0), min(hi, 3.0))
                     for _, _, _, lo, hi in slots] for _ in range(B)])
    sysb = eng._system(_batched_params(params, slots, S))
    pmb = eng._pmats(sysb[0], sysb[1], sysb[2], tree.blen)
    argsb = (child, eng.tips, pmb, sysb[3], eng._logw(sysb[4]))
    got, ms = timed(lambda: clv.uppass_site_lse(*argsb))
    ref, pms = timed(lambda: clv.uppass_site_lse_plain(*argsb))
    row(f"K3 uppass_site_lse (B={B})", "clv.cu",
        "phyml_tpu/ops/pallas_clv.py:62",
        float((got - ref).abs().max()), ms, pms, K13_TOL)

    # K2: every branch-length Newton round; compared through the
    # per-edge site terms on the free edges, never raw d
    args2 = (child, eng.tips, pm, V, Vinv, pi)
    (dk, sk), ms = timed(lambda: edotp.edge_dotprods(*args2))
    (dp, sp), pms = timed(lambda: edotp.edge_dotprods_plain(*args2))
    aux = eng._aux(sys_, None)
    site_k = eng.edge_site_terms(dk, sk, aux, tree.blen)[0]
    site_p = eng.edge_site_terms(dp, sp, aux, tree.blen)[0]
    mask = torch.ones(eng.n_nodes, dtype=torch.bool)
    mask[-1] = False
    mask[int(tree.child[-1, 1])] = False
    row("K2 edge_dotprods", "edotp.cu",
        "phyml_tpu/ops/pallas_edotp.py:387",
        float((site_k[mask] - site_p[mask]).abs().max()), ms, pms,
        K2_TOL)
    return rows


def small_fit_check(tmp):
    """The whole fixed-topology fit on a small problem: card float32
    against CPU float64 (the port's reference dtype)."""
    from phyml_tpu_torch import cli

    finals = {}
    for platform in ("cpu", "gpu"):
        d = os.path.join(tmp, f"small_{platform}")
        os.makedirs(d)
        aln_path, tree_path = write_problem(d, 16, 500, SEED + 1)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(cli_argv(aln_path, tree_path, platform)
                          + ["--quiet"])
        if rc != 0:
            fail(f"small fit on {platform} returned {rc}")
        finals[platform] = stats_lnl(aln_path)
    gap = finals["gpu"] - finals["cpu"]
    print(f". small fit (16 x 500): gpu f32 {finals['gpu']:.5f}  cpu f64 "
          f"{finals['cpu']:.5f}  diff {gap:.2e} (tol {E2E_TOL})")
    if not abs(gap) <= E2E_TOL:
        fail("small fit disagrees between the card and the CPU")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs "
             "one CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f". torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f". card: {smi}")
    try:
        import phyml_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the phyml_tpu_torch package is not importable ({exc}); "
             "run from the repository root")
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.ops import _build, clv, clv_slots, edotp
    from phyml_tpu_torch.topology import Topology

    # full float32 everywhere: no TF32 matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")

    t0 = time.time()
    so = _build.build()
    _build.library()
    print(f". kernels built in {time.time() - t0:.1f} s: {so}")
    with open(os.path.join(os.path.dirname(so), "build.log")) as fh:
        for line in fh:
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

    with tempfile.TemporaryDirectory() as tmp:
        aln_path, tree_path = write_problem(tmp, N_TAXA, N_SITES, SEED)
        rows = kernel_phases(aln_path, tree_path, cuda)
        small_fit_check(tmp)

        # ---- main path: the CLI a user runs --------------------------
        from phyml_tpu_torch.io.alignment import read_alignment
        from phyml_tpu_torch.ops.likelihood import (
            LikelihoodEngine, tree_arrays,
        )
        argv = cli_argv(aln_path, tree_path, "gpu")
        args = cli.build_parser().parse_args(argv)
        aln = read_alignment(aln_path, datatype="nt")
        with open(tree_path) as fh:
            rv = Topology.from_newick(fh.read(), aln.names).rooted()
        model = cli._build_model(args, aln)
        eng = LikelihoodEngine(aln, model, dtype=torch.float32,
                               device=cuda)
        lnl_start = float(eng.loglik(cli._init_params(args, model, aln),
                                     tree_arrays(rv, device=cuda)))
        wrappers = [clv_slots.uppass_site_lse_slots, edotp.edge_dotprods,
                    clv.uppass_site_lse]
        for fn in wrappers:
            fn.launches = 0
        out = io.StringIO()
        torch.cuda.synchronize()
        t1 = time.time()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t1
        counts = {fn.__name__: fn.launches for fn in wrappers}
        print(out.getvalue().rstrip())
        if rc != 0:
            fail(f"main path returned {rc}")
        rounds = out.getvalue().count("  round ")
        lnl_final = stats_lnl(aln_path)
        print(f". main path: start lnL {lnl_start:.5f}  final lnL "
              f"{lnl_final:.5f}  rounds {rounds}  wall {wall:.2f} s  "
              f"launches {counts}")
        if not (math.isfinite(lnl_final) and lnl_final >= lnl_start):
            fail("final lnL is not finite or below the start lnL")
        with open(f"{aln_path}_phyml_tree.txt") as fh:
            topo = Topology.from_newick(fh.read(), aln.names)
        if topo.n_otu != N_TAXA or not np.all(np.isfinite(topo.blen)):
            fail("the output tree does not parse to a finite tree")
        for fn in wrappers:
            if counts[fn.__name__] <= 0:
                fail(f"{fn.__name__} never launched on the main path")
        by_src = {"clv_slots.cu": "uppass_site_lse_slots",
                  "edotp.cu": "edge_dotprods", "clv.cu": "uppass_site_lse"}
        for r in rows:
            r["launches"] = counts[by_src[os.path.basename(r["source"])]]

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
