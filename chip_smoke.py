#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (phyml_tpu_torch) once on one GPU.

    python3 chip_smoke.py          # from the repository root

1. checks for a CUDA device and prints its name and power limit;
2. builds the hand-written kernels from `phyml_tpu_torch/csrc`;
3. simulates the repo's two bench problems (tools/gen_bench_problem.py)
   from a fixed seed: 128 taxa x 4096 sites under GTR+G4 (DNA) and
   under LG+G4 (amino acids);
4. for each, runs the kernels against their plain PyTorch versions on
   the same card tensors: the host lnL kernel (K1 slot walk, or its
   streamed twin K4), the edge dot products (K2, or the streamed K5)
   and K3 (dense, at the optimizer's batch sizes); the pair off the
   problem's route runs beside the one on it, for the record.  The
   host lnL kernel is also held against a float64 evaluation;
5. checks the fixed-topology fit end to end on a small problem of each
   kind (card float32 against CPU float64);
6. runs each main path, `phyml_tpu_torch.cli -u tree -c 4 -o lr -b 0
   --platform gpu` with `-m GTR` and with `-d aa -m LG -a e`, with the
   kernels' launch counters reset just before and read just after.

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
# the bench problems of tools/gen_bench_problem.py:38-51
FREQS = np.array([0.3, 0.2, 0.3, 0.2])           # DNA: GTR+G4
RATES = np.array([1.2, 3.0, 0.8, 1.1, 4.0, 1.0])
ALPHA = {"nt": 0.7, "aa": 0.9}                   # amino acids: LG+G4
# tolerances, all float32 on the card (tests/test_pallas.py):
SITE_TOL = {"nt": 5e-4, "aa": 2e-3}  # per-site lnL, kernel vs plain
#                                      (K1/K3/K4; DNA :44, AA :287)
EDGE_TOL = 2e-3   # per-site edge lnL terms, kernel vs plain (K2/K5, :218)
F64_TOL = 0.5     # total lnL, host kernel float32 vs float64 scan (:104)
E2E_TOL = 0.1     # final lnL of the small fit, card f32 vs CPU f64:
#                   the two optimizers stop at slightly different
#                   points of a flat optimum
REPS = 5          # timing windows per measurement
LAUNCHES = 20     # kernel calls per window (plain versions: 1)
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): FP32 outside the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

TPU_KERNEL = {
    "K1": "phyml_tpu/ops/pallas_clv_slots.py:139",
    "K2": "phyml_tpu/ops/pallas_edotp.py:387",
    "K3": "phyml_tpu/ops/pallas_clv.py:62",
    "K4": "phyml_tpu/ops/pallas_clv_slots.py:298",
    "K5": "phyml_tpu/ops/pallas_edotp.py:89",
}
SOURCE = {"K1": "clv_slots.cu", "K2": "edotp.cu", "K3": "clv.cu",
          "K4": "clv_slots_stream.cu", "K5": "edotp_stream.cu"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def wrappers():
    """Kernel name -> its wrapper (each carries a launch counter)."""
    from phyml_tpu_torch.ops import clv, clv_slots, edotp
    return {"K1": clv_slots.uppass_site_lse_slots,
            "K2": edotp.edge_dotprods,
            "K3": clv.uppass_site_lse,
            "K4": clv_slots.uppass_site_lse_slots_stream,
            "K5": edotp.edge_dotprods_stream}


def simulate(topo, model, params, n_sites, rng):
    """Sequences down the rooted tree under the model (the port's own
    P(t), float64 on the CPU); returns (names, seqs)."""
    from phyml_tpu_torch.datatypes import AA_STATES, NT_STATES
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
    alphabet = NT_STATES if model.datatype == "nt" else AA_STATES
    names = [f"T{i:04d}" for i in range(n)]
    return names, ["".join(alphabet[s] for s in states[i])
                   for i in range(n)]


def true_params(dt, params):
    """The simulation's parameter values on top of a params dict."""
    import torch

    if dt == "nt":
        params["rr_val"] = torch.log(torch.as_tensor(RATES))
    params["alpha"] = torch.tensor(ALPHA[dt], dtype=torch.float64)
    return params


def write_problem(dirname, dt, n_taxa, n_sites, seed):
    from phyml_tpu_torch.models.substitution import SubstModel
    from phyml_tpu_torch.topology import Topology

    rng = np.random.default_rng(seed)
    topo = Topology.random(n_taxa, rng, mean_blen=0.08)
    if dt == "nt":
        model = SubstModel(datatype="nt", name="GTR", n_classes=4,
                           freqs_mode="fixed", fixed_freqs=FREQS)
    else:
        model = SubstModel(datatype="aa", name="LG", n_classes=4,
                           freqs_mode="model")
    params = true_params(dt, model.init_params())
    names, seqs = simulate(topo, model, params, n_sites, rng)
    os.makedirs(dirname, exist_ok=True)
    aln_path = os.path.join(dirname, "aln.phy")
    tree_path = os.path.join(dirname, "tree.nwk")
    with open(aln_path, "w") as fh:
        fh.write(f" {len(names)} {n_sites}\n")
        for nm, sq in zip(names, seqs):
            fh.write(f"{nm:<10s}  {sq}\n")
    with open(tree_path, "w") as fh:
        fh.write(topo.to_newick(names) + "\n")
    return aln_path, tree_path


def timed(fn, launches=LAUNCHES):
    """(result, ms per call): CUDA events around `launches` calls back
    to back, so the host's launch overhead overlaps the card's work;
    the median of REPS such windows, divided by `launches`."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / launches)
    return out, statistics.median(ms)


def bound(flops, nbytes):
    """(least ms on the card, what bounds it): the larger of the
    operations over the FP32 peak and the bytes over HBM bandwidth."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def pruning_flops(n_otu, C, ns, P, B=1):
    """Multiply-adds of one Felsenstein pass (K1, K3, K4): every node
    but the root pushed through its P-matrix once (2*ns^2 FLOPs per
    class and pattern), and one ns-product per internal node."""
    n_nodes, n_int = 2 * n_otu - 1, n_otu - 1
    return B * C * P * (2 * ns * ns * (n_nodes - 1) + ns * n_int)


def edotp_flops(n_otu, C, ns, P):
    """Multiply-adds the edge dot products need (K2, K5): the up sweep's
    pushes, the outside sweep's parent matvecs, and V^T O and V^-1 C
    for every non-root edge (2*ns^2 FLOPs each per class and pattern),
    plus the elementwise products.  A kernel that recomputes pushed
    partials instead of storing them does more."""
    n_nodes, n_int = 2 * n_otu - 1, n_otu - 1
    matvecs = (n_nodes - 1) + (n_int - 1) + 2 * (n_nodes - 1)
    return C * P * (2 * ns * ns * matvecs + ns * (n_int + 2 * n_int
                                                  + n_nodes - 1))


def cli_argv(dt, aln_path, tree_path, platform):
    model = ["-m", "GTR"] if dt == "nt" else ["-d", "aa", "-m", "LG",
                                              "-a", "e"]
    return ["-i", aln_path, "-u", tree_path, *model, "-c", "4",
            "-o", "lr", "-b", "0", "--platform", platform,
            "--r_seed", "1"]


def stats_lnl(aln_path) -> float:
    with open(f"{aln_path}_phyml_stats.txt") as fh:
        for line in fh:
            if line.startswith(". Log-likelihood:"):
                return float(line.split(":")[1])
    fail("no Log-likelihood line in the stats file")


def kernel_phases(dt, aln_path, tree_path, cuda):
    """Each kernel of the path against its plain version on the same
    card tensors at the main path's shapes; returns the kernels' JSON
    entries (launches filled in later)."""
    import torch
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.ops import clv, clv_slots, edotp
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.optim.round import _batched_params, free_scalar_slots
    from phyml_tpu_torch.topology import Topology

    aln = read_alignment(aln_path, datatype=dt)
    args = cli.build_parser().parse_args(cli_argv(dt, aln_path, tree_path,
                                                  "gpu"))
    model = cli._build_model(args, aln)
    params = true_params(dt, cli._init_params(args, model, aln))
    with open(tree_path) as fh:
        rv = Topology.from_newick(fh.read(), aln.names).rooted()
    eng = LikelihoodEngine(aln, model, dtype=torch.float32, device=cuda)
    tree = tree_arrays(rv, dtype=torch.float32, device=cuda)
    sys_ = eng.system_of(params)
    lam, V, Vinv, pi, w, pinv = sys_
    pm = eng._pmats(lam, V, Vinv, tree.blen)
    child, sched = eng._topology(tree.child)
    logw = eng._logw(w)
    n, C, ns, k = aln.n_otu, eng.C, eng.ns, aln.n_patterns
    lnl_k, edge_k = eng.lnl_route, eng.edotp_route
    want = ("K1", "K2") if dt == "nt" else ("K4", "K5")
    print(f". [{dt}] problem: {n} taxa, {aln.n_sites} sites, {k} "
          f"patterns, C={C}, ns={ns}; route {lnl_k}/{edge_k}")
    if (lnl_k, edge_k) != want:
        fail(f"[{dt}] route {lnl_k}/{edge_k}, expected {want}")
    W = wrappers()
    rows = []

    def row(kname, label, err, ms, plain_ms, tol, flops, nb, on_path=True):
        b_ms, b_by = bound(flops, nb)
        print(f". [{dt}] {kname} {label}: max|d|={err:.3e} (tol {tol:g})  "
              f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound "
              f"{b_ms:.4f} ms ({b_by})"
              + ("" if on_path else "  [not on this path]"))
        if not (err <= tol):
            fail(f"[{dt}] {kname} disagrees with its plain version: "
                 f"{err} > {tol}")
        if on_path:
            rows.append(dict(
                name=f"{kname} {label}", route="cuda",
                source=f"phyml_tpu_torch/csrc/{SOURCE[kname]}",
                replaces=TPU_KERNEL[kname], launches=0, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, ns=ns, path=dt, kernel=kname))

    # host lnL: K1 (DNA) or K4 (amino acids), against K1's plain version
    args1 = (sched, eng.tips, pm, pi, logw)
    ref, pms = timed(lambda: clv_slots.uppass_site_lse_slots_plain(
        *args1, n_slots=eng.slot_count), 1)
    slot_bytes = nbytes(*args1) + k * 4
    slot_flops = pruning_flops(n, C, ns, k)
    got = None
    for kname in ("K1", "K4"):
        out, ms = timed(lambda: W[kname](*args1, n_slots=eng.slot_count))
        row(kname, W[kname].__name__, float((out - ref).abs().max()), ms,
            pms, SITE_TOL[dt], slot_flops, slot_bytes,
            on_path=kname == lnl_k)
        if kname == lnl_k:
            got = out
    lnl32 = float(torch.sum(got.double() * eng.weights))
    eng64 = LikelihoodEngine(aln, model, dtype=torch.float64, device=cuda)
    tree64 = tree_arrays(rv, dtype=torch.float64, device=cuda)
    lnl64 = float(torch.sum(eng64.site_logliks_scan(
        eng64.system_of(params), tree64) * eng64.weights))
    print(f". [{dt}] {lnl_k} lnL {lnl32:.6f} vs float64 scan {lnl64:.6f}")
    if not abs(lnl32 - lnl64) <= F64_TOL:
        fail(f"[{dt}] {lnl_k} lnL off the float64 evaluation by "
             f"{lnl32 - lnl64}")
    del eng64, tree64

    # K3: backtracking probes (one system) and the line-search grid
    # (n_slots x (grid + 1) systems in one launch)
    got, ms = timed(lambda: clv.uppass_site_lse(child, eng.tips, pm, pi,
                                                logw))
    ref, pms = timed(lambda: clv.uppass_site_lse_plain(
        child, eng.tips, pm[None], pi[None], logw[None])[0], 1)
    row("K3", "uppass_site_lse (B=1)", float((got - ref).abs().max()), ms,
        pms, SITE_TOL[dt], pruning_flops(n, C, ns, k),
        nbytes(child, eng.tips, pm, pi, logw) + k * 4)
    slots = free_scalar_slots(model, params)
    B = len(slots) * 13                        # optimize_scalars grid=12
    rng = np.random.default_rng(SEED)
    S = np.asarray([[rng.uniform(max(lo, -3.0), min(hi, 3.0))
                     for _, _, _, lo, hi in slots] for _ in range(B)])
    sysb = eng._system(_batched_params(params, slots, S))
    pmb = eng._pmats(sysb[0], sysb[1], sysb[2], tree.blen)
    argsb = (child, eng.tips, pmb, sysb[3], eng._logw(sysb[4]))
    got, ms = timed(lambda: clv.uppass_site_lse(*argsb))
    ref, pms = timed(lambda: clv.uppass_site_lse_plain(*argsb), 1)
    row("K3", f"uppass_site_lse (B={B})", float((got - ref).abs().max()),
        ms, pms, SITE_TOL[dt], pruning_flops(n, C, ns, k, B),
        nbytes(*argsb) + B * k * 4)
    del sysb, pmb, argsb, got, ref

    # edge dot products: K2 (DNA) or K5 (amino acids), every
    # branch-length Newton round; compared through the per-edge site
    # terms on the free edges, never raw d
    args2 = (child, eng.tips, pm, V, Vinv, pi)
    aux = eng._aux(sys_, None)
    mask = torch.ones(eng.n_nodes, dtype=torch.bool)
    mask[-1] = False
    mask[int(tree.child[-1, 1])] = False
    (dp, sp), pms = timed(lambda: edotp.edge_dotprods_plain(*args2), 1)
    site_p = eng.edge_site_terms(dp, sp, aux, tree.blen)[0]
    edge_bytes = nbytes(*args2) + nbytes(dp, sp)
    del dp, sp
    for kname in ("K2", "K5"):
        (dk, sk), ms = timed(lambda: W[kname](*args2))
        site_k = eng.edge_site_terms(dk, sk, aux, tree.blen)[0]
        del dk, sk
        row(kname, W[kname].__name__,
            float((site_k[mask] - site_p[mask]).abs().max()), ms, pms,
            EDGE_TOL, edotp_flops(n, C, ns, k), edge_bytes,
            on_path=kname == edge_k)
    return rows


def small_fit_check(dt, tmp):
    """The whole fixed-topology fit on a small problem: card float32
    against CPU float64 (the port's reference dtype)."""
    from phyml_tpu_torch import cli

    finals = {}
    for platform in ("cpu", "gpu"):
        d = os.path.join(tmp, f"small_{dt}_{platform}")
        aln_path, tree_path = write_problem(d, dt, 16, 500, SEED + 1)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(cli_argv(dt, aln_path, tree_path, platform)
                          + ["--quiet"])
        if rc != 0:
            fail(f"[{dt}] small fit on {platform} returned {rc}")
        finals[platform] = stats_lnl(aln_path)
    gap = finals["gpu"] - finals["cpu"]
    print(f". [{dt}] small fit (16 x 500): gpu f32 {finals['gpu']:.5f}  "
          f"cpu f64 {finals['cpu']:.5f}  diff {gap:.2e} (tol {E2E_TOL})")
    if not abs(gap) <= E2E_TOL:
        fail(f"[{dt}] small fit disagrees between the card and the CPU")


def main_path(dt, aln_path, tree_path, cuda):
    """The CLI a user runs, with every launch counter set to 0 just
    before and read just after; then a second (warm) run, timed only.
    Returns the counts of the first run."""
    import torch
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.topology import Topology

    argv = cli_argv(dt, aln_path, tree_path, "gpu")
    args = cli.build_parser().parse_args(argv)
    aln = read_alignment(aln_path, datatype=dt)
    with open(tree_path) as fh:
        rv = Topology.from_newick(fh.read(), aln.names).rooted()
    model = cli._build_model(args, aln)
    eng = LikelihoodEngine(aln, model, dtype=torch.float32, device=cuda)
    lnl_start = float(eng.loglik(cli._init_params(args, model, aln),
                                 tree_arrays(rv, device=cuda)))
    path = ("K1", "K2", "K3") if dt == "nt" else ("K4", "K5", "K3")
    W = wrappers()
    walls = []
    for run in range(2):
        for fn in W.values():
            fn.launches = 0
        out = io.StringIO()
        torch.cuda.synchronize()
        t1 = time.time()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        walls.append(time.time() - t1)
        if run == 0:
            counts = {name: fn.launches for name, fn in W.items()}
            text = out.getvalue()
        if rc != 0:
            fail(f"[{dt}] main path returned {rc}")
    print(text.rstrip())
    rounds = text.count("  round ")
    lnl_final = stats_lnl(aln_path)
    print(f". [{dt}] main path: start lnL {lnl_start:.5f}  final lnL "
          f"{lnl_final:.5f}  rounds {rounds}  wall {walls[0]:.2f} s "
          f"(first run in the process), {walls[1]:.2f} s (second)  "
          f"launches {counts}")
    if not (math.isfinite(lnl_final) and lnl_final >= lnl_start):
        fail(f"[{dt}] final lnL is not finite or below the start lnL")
    with open(f"{aln_path}_phyml_tree.txt") as fh:
        topo = Topology.from_newick(fh.read(), aln.names)
    if topo.n_otu != N_TAXA or not np.all(np.isfinite(topo.blen)):
        fail(f"[{dt}] the output tree does not parse to a finite tree")
    for name, count in counts.items():
        if name in path and count <= 0:
            fail(f"[{dt}] {name} never launched on the main path")
        if name not in path and count != 0:
            fail(f"[{dt}] {name} launched {count} times off its route")
    return counts


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
    from phyml_tpu_torch.ops import _build

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
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"  ptxas: {line.strip()}")

    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for dt in ("nt", "aa"):
            aln_path, tree_path = write_problem(
                os.path.join(tmp, dt), dt, N_TAXA, N_SITES, SEED)
            dt_rows = kernel_phases(dt, aln_path, tree_path, cuda)
            torch.cuda.empty_cache()
            small_fit_check(dt, tmp)
            counts = main_path(dt, aln_path, tree_path, cuda)
            for r in dt_rows:
                r["launches"] = counts[r.pop("kernel")]
            rows += dt_rows
            torch.cuda.empty_cache()

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
