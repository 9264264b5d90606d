#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (phyml_tpu_torch) once on one GPU.

    python3 chip_smoke.py          # from the repository root

1. checks for a CUDA device and prints its name and power limit;
2. builds the hand-written kernels from `phyml_tpu_torch/csrc`;
3. simulates the repo's two bench problems (tools/gen_bench_problem.py)
   from a fixed seed: 128 taxa x 4096 sites under GTR+G4 (DNA) and
   under LG+G4 (amino acids);
4. for each, runs the kernels against their plain PyTorch versions on
   the same card tensors: the one-parameter-set pass behind the host
   lnL and the branch-length probes (K1, or its streamed twin K4; both
   one body, timed beside K3 at B = 1 on the same tensors), the edge
   dot products (K2, or the streamed K5) and K3 (slot schedule, batched
   over parameter sets) at the line search's batch sizes B = 2 (pair
   probe) and 13 per free scalar (its grid), and at B = 1 for the
   record, each with the peak device memory of its call, its registers
   and spills from the ptxas report (a spill fails the run) and the
   blocks per SM the runtime grants; the kernel off the problem's route
   runs beside the one on it, for the record (K1 refuses 128-taxon
   protein, whose matrices do not fit its shared memory).  The host lnL
   kernel is also held against a float64 evaluation;
5. checks the fixed-topology fit end to end on a small problem of each
   kind (card float32 against CPU float64);
6. runs the fixed-topology fit, `phyml_tpu_torch.cli -u tree -c 4 -o
   lr -b 0 --platform gpu` with `-m GTR` and with `-d aa -m LG -a e`,
   with the kernels' launch counters reset just before and read just
   after (K3's by batch size: no single-system pass may reach it);
7. holds the card's ML distances (float32) against the CPU's float64
   ones on the bench problem (max gap 1e-3), and runs the default run
   (no -u: BioNJ, then the NNI search) on a 16 x 500 problem on the
   card and on the CPU (the same tree, lnL within 0.1);
8. runs the main path, the default `phyml` run at 128 x 4096 (the same
   flags without -u and -o: BioNJ start tree, `-o tlr -s NNI`), with
   the launch counters reset just before and read just after and the
   search's own functions counted and timed: BioNJ time, search
   wall-clock, NNI rounds, SPR sweeps, scorer calls and ms per call,
   the SPR block size, start and final lnL, RF distance to the
   simulating tree; every kernel of the route must launch, none off it,
   and K3 never at B = 1;
9. the supports path: on a 16 x 500 DNA problem `-b 2` and `-b -5` on
   the card and on the CPU (the same final and replicate trees and
   counts, aBayes within ABAYES_TOL); on each default run's final tree
   (`-u final -o lr`) `-b -5` (aBayes) and `-b -4` (SH-aLRT), timed,
   supports in [0, 1], then the rapid bootstrap `-b R --rapid_boot` (R =
   REPLICATES) with the launch counters reset just before and read just
   after: wall, rounds, launches by stack size, peak memory, the NNI
   scorer's share; K3 and the edge kernel must run on stacks.  Step 4
   adds the stacked forms: K3 with a schedule per tree and the route's
   K2/K5 with a tree axis on R random trees, one launch each, against
   the plain version and beside R single launches.

It prints a JSON line of the default runs' numbers, a JSON line of the
supports' numbers, a JSON line of per-kernel results (`launches` from
the default run, `launches_fixed_fit` from step 6; the stacked forms'
from the rapid bootstrap, by stack size), the card line, and as the
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
D_TOL = 1e-3      # ML distances, card f32 vs CPU f64 (clipped to
#                   [1e-8, 2])
ABAYES_TOL = 5e-4  # aBayes supports of the 16 x 500 run, card f32 vs CPU
#                   f64 (measured 3.1e-4 on an H100, PERF.md)
# replicates of the rapid bootstrap on the final 128 x 4096 tree, and the
# stack of trees the tree-axis kernels are timed on
REPLICATES = {"nt": 8, "aa": 4}
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


def reset_counts():
    """Every kernel wrapper's launch counters to 0."""
    for fn in wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_trees"):
            fn.launches_by_trees = {}
    wrappers()["K3"].launches_by_batch = {}


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


# mangled-name fragment of the kernels whose ptxas report is checked
PTXAS_KERNEL = {"K1": "slot_site_lse_kernel",
                "K2": "edge_dotprods_kernel", "K3": "batched_uppass_kernel",
                "K4": "slot_site_lse_stream_kernel",
                "K5": "edge_dotprods_stream_kernel"}


def ptxas_report(log_path, fragment):
    """One kernel's ptxas report from the build log: state count ->
    (registers, spill bytes stored + loaded) of each instantiation."""
    import re

    out, ns = {}, None
    with open(log_path) as fh:
        for line in fh:
            m = re.search(r"(?:entry function|properties for) '?"
                          rf"\S*{fragment}ILi(\d+)E", line)
            if m:
                ns = int(m.group(1))
                continue
            if ns is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                regs = out.get(ns, (None, 0))[0]
                out[ns] = (regs, int(m.group(1)) + int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[ns] = (int(m.group(1)), out.get(ns, (None, 0))[1])
                ns = None
    return out


def peak_mib(fn):
    """Device memory one call allocates at its peak, beyond what was
    allocated before it (MiB)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


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


def kernel_phases(dt, aln_path, tree_path, cuda, regs):
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
    logw = eng._logw(w)
    n, C, ns, k = aln.n_otu, eng.C, eng.ns, aln.n_patterns
    lnl_k, edge_k = eng.lnl_route, eng.edotp_route
    child, sched, n_slots = eng._topology(tree.child)
    want = ("K1", "K2") if dt == "nt" else ("K4", "K5")
    print(f". [{dt}] problem: {n} taxa, {aln.n_sites} sites, {k} "
          f"patterns, C={C}, ns={ns}; route {lnl_k}/{edge_k}")
    if (lnl_k, edge_k) != want:
        fail(f"[{dt}] route {lnl_k}/{edge_k}, expected {want}")
    W = wrappers()
    rows = []

    def row(kname, label, err, ms, plain_ms, tol, flops, nb, on_path=True,
            **extra):
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
                library_ms=None, ns=ns, path=dt, kernel=kname, **extra))

    # one parameter set (the host lnL and the branch-length probes): K1
    # (DNA) or K4 (amino acids), against K1's plain version and beside
    # K3 at B=1 on the same tensors, each with its peak memory, registers,
    # spills and the blocks per SM the runtime grants
    args1 = (sched, eng.slot_tips, pm, pi, logw)
    ref, pms = timed(lambda: clv_slots.uppass_site_lse_slots_plain(
        *args1, n_slots=n_slots), 1)
    _, k3_ms = timed(lambda: clv.uppass_site_lse(
        child, eng.tips, pm, pi, logw, sched=sched, n_slots=n_slots))
    slot_bytes = nbytes(sched, eng.tips, pm, pi, logw) + k * 4
    slot_flops = pruning_flops(n, C, ns, k)
    got = None
    for kname in ("K1", "K4"):
        resident = kname == "K1"
        geo = clv_slots.geometry(ns, C, k, n, n_slots, resident)
        if geo["block_smem_bytes"] > clv_slots.MAX_BLOCK_SMEM:
            print(f". [{dt}] {kname}: refused at this shape (each class's "
                  f"P-matrices of the whole tree: a block would need "
                  f"{geo['block_smem_bytes'] / 1024:.1f} KB of shared "
                  "memory)  [not on this path]")
            if kname == lnl_k:
                fail(f"[{dt}] the route's {kname} refuses its shape")
            continue
        s_regs, spill = regs[kname][ns]
        blocks = clv_slots.blocks_per_sm(ns, C, n, n_slots, not resident)
        peak = peak_mib(lambda: W[kname](*args1, n_slots=n_slots))
        print(f". [{dt}] {kname}: {s_regs} registers, {spill} B spilled, "
              f"{geo['blocks']} blocks of {C} warps ({geo['tile']} "
              f"patterns, a warp per class, "
              f"{geo['block_smem_bytes'] / 1024:.1f} KB shared memory), "
              f"{blocks} per SM granted ({blocks * C} warps); peak "
              f"{peak:.3f} MiB beyond its inputs (out "
              f"{k * 4 / 2 ** 20:.3f} MiB)")
        if peak > k * 4 / 2 ** 20 + 1.0:
            fail(f"[{dt}] {kname} allocates more than its outputs")
        out, ms = timed(lambda: W[kname](*args1, n_slots=n_slots))
        print(f". [{dt}] {kname} {ms:.4f} ms beside K3 at B=1 {k3_ms:.4f} "
              "ms on the same tensors")
        row(kname, W[kname].__name__, float((out - ref).abs().max()), ms,
            pms, SITE_TOL[dt], slot_flops, slot_bytes,
            on_path=kname == lnl_k, registers=s_regs, spill_bytes=spill,
            blocks_per_sm=blocks, warps_per_sm=blocks * C, peak_mib=peak,
            k3_b1_ms=k3_ms)
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

    # K3: the line search's pair probe (B=2) and its grid (13 systems
    # per free scalar, optimize_scalars grid=12 plus the current value),
    # and one system (B=1, which the main path sends to K1/K4), one
    # launch each, through the topology's slot schedule
    slots = free_scalar_slots(model, params)
    rng = np.random.default_rng(SEED)
    tp = 32 * max(1, 4 // C)   # the pattern tile of a workspace kernel
    for B in (1, 2, 13 * len(slots)):
        blocks = clv.blocks_per_sm(ns, C, n_slots)
        k3_regs, spill = regs["K3"][ns]
        print(f". [{dt}] K3 B={B}: {n_slots} slots, {k3_regs} registers, "
              f"{spill} B spilled, {blocks} blocks of {32 * C} threads "
              f"per SM ({blocks * C} warps)")
        if B == 1:
            argsb = (child, eng.tips, pm, pi, logw)
        else:
            S = np.asarray([[rng.uniform(max(lo, -3.0), min(hi, 3.0))
                             for _, _, _, lo, hi in slots]
                            for _ in range(B)])
            sysb = eng._system(_batched_params(params, slots, S))
            pmb = eng._pmats(sysb[0], sysb[1], sysb[2], tree.blen)
            argsb = (child, eng.tips, pmb, sysb[3], eng._logw(sysb[4]))
        k3 = lambda: clv.uppass_site_lse(*argsb, sched=sched,
                                         n_slots=n_slots)
        peak = peak_mib(k3)
        old_ws = B * (n - 1) * C * (ns + 1) * (-(-k // tp) * tp) * 4
        print(f". [{dt}] K3 B={B}: peak {peak:.2f} MiB beyond its "
              f"inputs (output {B * k * 4 / 2 ** 20:.2f} MiB; a device-"
              f"memory workspace of every internal node's partial would "
              f"take {old_ws / 2 ** 20:.1f} MiB, computed)")
        got, ms = timed(k3)
        plain = (lambda: clv.uppass_site_lse_plain(
            child, eng.tips, pm[None], pi[None], logw[None])[0]) \
            if B == 1 else (lambda: clv.uppass_site_lse_plain(*argsb))
        ref, pms = timed(plain, 1)
        row("K3", f"uppass_site_lse (B={B})",
            float((got - ref).abs().max()), ms, pms, SITE_TOL[dt],
            pruning_flops(n, C, ns, k, B),
            nbytes(*argsb[1:], sched) + B * k * 4, B=B, peak_mib=peak,
            registers=k3_regs, spill_bytes=spill, blocks_per_sm=blocks,
            warps_per_sm=blocks * C)
        del argsb, got, ref

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
    # a call allocates d and sc_d and the two workspace tensors, nothing
    # more
    geo = edotp.geometry(ns, C, k)
    out_bytes = eng.n_nodes * C * (ns + 1) * k * 4
    ws_bytes = 2 * (n - 1) * geo["workspace_floats_per_node"] * 4
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for kname in ("K2", "K5"):
        blocks = edotp.blocks_per_sm(ns, kname == "K5")
        e_regs, spill = regs[kname][ns]
        peak = peak_mib(lambda: W[kname](*args2))
        print(f". [{dt}] {kname}: {e_regs} registers, {spill} B spilled, "
              f"{geo['blocks']} blocks of one warp ({geo['tile']} patterns "
              f"x 1 class), {blocks} per SM granted ({blocks} warps), "
              f"{geo['blocks'] / sms:.1f} per SM on {sms} SMs; peak "
              f"{peak:.2f} MiB beyond its inputs (outputs "
              f"{out_bytes / 2 ** 20:.2f} + workspace "
              f"{ws_bytes / 2 ** 20:.2f} MiB)")
        if peak > (out_bytes + ws_bytes) / 2 ** 20 + 1.0:
            fail(f"[{dt}] {kname} allocates more than its outputs and "
                 "workspace")
        (dk, sk), ms = timed(lambda: W[kname](*args2))
        site_k = eng.edge_site_terms(dk, sk, aux, tree.blen)[0]
        del dk, sk
        row(kname, W[kname].__name__,
            float((site_k[mask] - site_p[mask]).abs().max()), ms, pms,
            EDGE_TOL, edotp_flops(n, C, ns, k), edge_bytes,
            on_path=kname == edge_k, registers=e_regs, spill_bytes=spill,
            blocks_per_sm=blocks, warps_per_sm=blocks, peak_mib=peak)
    del site_p
    torch.cuda.empty_cache()
    tree_axis_phases(dt, eng, sys_, row)
    return rows


def tree_axis_phases(dt, eng, sys_, row):
    """The rapid bootstrap's forms on a stack of REPLICATES[dt] random
    trees of the problem's taxa: K3 with a slot schedule per tree and
    the route's edge-dot-product kernel (K2 or K5) with a tree axis, each
    one launch, against its plain version and timed beside one launch
    per tree on the same tensors (CUDA events, as `timed`); each adds
    its row through kernel_phases's `row`."""
    import torch
    from phyml_tpu_torch.ops import clv, edotp
    from phyml_tpu_torch.ops.likelihood import TreeArrays, tree_arrays
    from phyml_tpu_torch.topology import Topology

    R, cuda = REPLICATES[dt], eng.device
    n, C, ns, k = eng.n_otu, eng.C, eng.ns, eng.P
    lam, V, Vinv, pi, w, pinv = sys_
    rng = np.random.default_rng(SEED + 7)
    trees = [tree_arrays(Topology.random(n, rng, mean_blen=0.08).rooted(),
                         device=cuda) for _ in range(R)]
    stack = TreeArrays(torch.stack([t.child for t in trees]),
                       torch.stack([t.blen for t in trees]))
    pm = eng._pmats(lam, V, Vinv, stack.blen)
    logw = eng._logw(w)
    child, sched, n_slots = eng._topology(stack.child)
    singles = [eng._topology(t.child) for t in trees]
    W = wrappers()
    print(f". [{dt}] tree axis: {R} random trees of {n} taxa in one stack, "
          f"{n_slots} slots at most (theirs: "
          f"{[s[2] for s in singles]})")

    # K3, a schedule per tree, one system broadcast
    k3 = lambda: clv.uppass_site_lse(child, eng.tips, pm, pi, logw,
                                     sched=sched, n_slots=n_slots)
    peak = peak_mib(k3)
    got, ms = timed(k3)
    _, single_ms = timed(lambda: [clv.uppass_site_lse(
        c, eng.tips, pm[r:r + 1], pi[None], logw[None], sched=sc,
        n_slots=ns_) for r, (c, sc, ns_) in enumerate(singles)])
    ref, pms = timed(lambda: clv.uppass_site_lse_plain(child, eng.tips, pm,
                                                       pi, logw), 1)
    b1 = bound(pruning_flops(n, C, ns, k), nbytes(sched[0], eng.tips, pm[0],
                                                  pi, logw) + k * 4)[0]
    print(f". [{dt}] K3 tree axis R={R}: one launch {ms:.4f} ms, {R} single "
          f"launches {single_ms:.4f} ms; peak {peak:.2f} MiB beyond its "
          f"inputs (output {R * k * 4 / 2 ** 20:.2f} MiB); R x the single "
          f"bound {R * b1:.4f} ms")
    row("K3", f"uppass_site_lse (tree axis, R={R})",
        float((got - ref).abs().max()), ms, pms, SITE_TOL[dt],
        pruning_flops(n, C, ns, k, R),
        nbytes(sched, eng.tips, pm, pi, logw) + R * k * 4, R=R,
        tree_axis=True, single_launches_ms=single_ms, r_single_bound_ms=R * b1,
        peak_mib=peak)
    del got, ref

    # the route's edge-dot-product kernel with a tree axis, compared
    # through each tree's per-edge site terms on its free edges
    kname = eng.edotp_route
    fn = W[kname]
    aux = eng._aux(sys_, None)
    peak = peak_mib(lambda: fn(child, eng.tips, pm, V, Vinv, pi))
    (dk, sk), ms = timed(lambda: fn(child, eng.tips, pm, V, Vinv, pi))
    _, single_ms = timed(lambda: [fn(c, eng.tips, pm[r], V, Vinv, pi)
                                  for r, (c, _, _) in enumerate(singles)])
    err, pms = 0.0, 0.0
    for r, t in enumerate(trees):
        (dp, sp), p_ms = timed(lambda: edotp.edge_dotprods_plain(
            singles[r][0], eng.tips, pm[r], V, Vinv, pi), 1)
        pms += p_ms
        free = torch.ones(eng.n_nodes, dtype=torch.bool)
        free[-1] = False
        free[int(t.child[-1, 1])] = False
        site_p = eng.edge_site_terms(dp, sp, aux, t.blen)[0][free]
        site_k = eng.edge_site_terms(dk[r], sk[r], aux, t.blen)[0][free]
        err = max(err, float((site_k - site_p).abs().max()))
        del dp, sp, site_p, site_k
    out_bytes = R * eng.n_nodes * C * (ns + 1) * k * 4
    geo = edotp.geometry(ns, C, k)
    ws_bytes = 2 * R * (n - 1) * geo["workspace_floats_per_node"] * 4
    b1 = bound(edotp_flops(n, C, ns, k),
               nbytes(child[0], eng.tips, pm[0], V, Vinv, pi)
               + out_bytes // R)[0]
    print(f". [{dt}] {kname} tree axis R={R}: one launch {ms:.4f} ms, {R} "
          f"single launches {single_ms:.4f} ms; peak {peak:.2f} MiB beyond "
          f"its inputs (outputs {out_bytes / 2 ** 20:.2f} + workspace "
          f"{ws_bytes / 2 ** 20:.2f} MiB); R x the single bound "
          f"{R * b1:.4f} ms")
    # d, sc_d and the two workspace tensors, each rounded up by the
    # caching allocator to its 2 MiB segments
    if peak > (out_bytes + ws_bytes) / 2 ** 20 + 4 * 2.0:
        fail(f"[{dt}] {kname} on a stack allocates more than its outputs "
             "and workspace")
    row(kname, f"{fn.__name__} (tree axis, R={R})", err, ms, pms, EDGE_TOL,
        R * edotp_flops(n, C, ns, k),
        nbytes(child, eng.tips, pm, V, Vinv, pi) + out_bytes, R=R,
        tree_axis=True, single_launches_ms=single_ms, r_single_bound_ms=R * b1,
        peak_mib=peak)


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
        reset_counts()
        out = io.StringIO()
        torch.cuda.synchronize()
        t1 = time.time()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        walls.append(time.time() - t1)
        if run == 0:
            counts = {name: fn.launches for name, fn in W.items()}
            k3_by_b = dict(W["K3"].launches_by_batch)
            text = out.getvalue()
        if rc != 0:
            fail(f"[{dt}] main path returned {rc}")
    print(text.rstrip())
    rounds = text.count("  round ")
    lnl_final = stats_lnl(aln_path)
    print(f". [{dt}] main path: start lnL {lnl_start:.5f}  final lnL "
          f"{lnl_final:.5f}  rounds {rounds}  wall {walls[0]:.2f} s "
          f"(first run in the process), {walls[1]:.2f} s (second)  "
          f"launches {counts}, K3 by batch size {k3_by_b}")
    if not (math.isfinite(lnl_final) and lnl_final >= lnl_start):
        fail(f"[{dt}] final lnL is not finite or below the start lnL")
    with open(f"{aln_path}_phyml_tree.txt") as fh:
        topo = Topology.from_newick(fh.read(), aln.names)
    if topo.n_otu != N_TAXA or not np.all(np.isfinite(topo.blen)):
        fail(f"[{dt}] the output tree does not parse to a finite tree")
    if k3_by_b.get(1, 0):
        fail(f"[{dt}] K3 ran {k3_by_b[1]} single-system passes; those "
             f"belong to {path[0]}")
    for name, count in counts.items():
        if name in path and count <= 0:
            fail(f"[{dt}] {name} never launched on the main path")
        if name not in path and count != 0:
            fail(f"[{dt}] {name} launched {count} times off its route")
    return counts, k3_by_b


# the search's own functions whose calls the default-run phase counts
# and times (module, attribute, label); each is wrapped for that run only
SEARCH_PROBES = [
    ("phyml_tpu_torch.search.distances", "ml_pairwise_distances",
     "distances"),
    ("phyml_tpu_torch.search.bionj", "bionj", "agglomeration"),
    ("phyml_tpu_torch.search.driver", "nni_round", "NNI rounds"),
    ("phyml_tpu_torch.search.driver", "spr_round", "SPR sweeps"),
    ("phyml_tpu_torch.search.nni", "nni_scores", "NNI scorer"),
    ("phyml_tpu_torch.search.spr", "spr_scores_batched", "SPR scorer"),
]


# the supports path's functions the supports phase counts and times
SUPPORT_PROBES = [
    ("phyml_tpu_torch.search.support", "alrt_supports", "aLRT supports"),
    ("phyml_tpu_torch.search.support", "bootstrap_supports_batched",
     "rapid bootstrap"),
    ("phyml_tpu_torch.optim.blen", "optimize_branch_lengths_batched",
     "batched branch lengths"),
    ("phyml_tpu_torch.search.nni", "nni_scores_batched", "NNI scorer"),
]


@contextlib.contextmanager
def search_probes(probes=SEARCH_PROBES):
    """Wrap `probes`: label -> {calls, s (wall, the card synchronized
    before and after each call), sizes (the SPR scorer's candidates per
    call), last (the last result)}."""
    import importlib

    import torch

    stats, saved = {}, []
    for mod_name, attr, label in probes:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        rec = stats[label] = {"calls": 0, "s": 0.0, "sizes": []}

        def wrapped(*a, _fn=fn, _rec=rec, **kw):
            torch.cuda.synchronize()
            t = time.time()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            _rec["s"] += time.time() - t
            _rec["calls"] += 1
            _rec["last"] = out
            if _fn.__name__ == "spr_scores_batched":
                _rec["sizes"].append(len(a[4]))
            return out

        setattr(mod, attr, wrapped)
        saved.append((mod, attr, fn))
    try:
        yield stats
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def utilization_sampler(period_ms=100):
    """Samples the card's utilization with nvidia-smi every period_ms
    while the block runs (NVML: the share of each period in which a
    kernel ran); yields a list that holds the samples (0..1) once the
    block is left.  The sampler is stopped on the way out."""
    samples = []
    try:
        proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", str(period_ms)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        yield samples
        return
    try:
        yield samples
    finally:
        proc.terminate()
        try:
            out = proc.communicate(timeout=30)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            out = proc.communicate()[0]
        samples += [float(x) / 100 for x in out.split()
                    if x.replace(".", "").isdigit()]


def default_argv(dt, aln_path, platform):
    """The default `phyml` run: no -u (BioNJ start tree), the default
    -o tlr -s NNI search."""
    argv = cli_argv(dt, aln_path, None, platform)
    i = argv.index("-u")
    del argv[i:i + 2]
    i = argv.index("-o")
    del argv[i:i + 2]
    return argv


def distance_check(dt, aln_path, cuda):
    """The card's ML distances (float32) against the CPU's float64 on
    the same alignment and starting parameters; returns the engine's
    scorer block size (spr.default_batch_k on the BioNJ tree)."""
    import torch
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine
    from phyml_tpu_torch.search import distances, spr
    from phyml_tpu_torch.search.bionj import bionj

    args = cli.build_parser().parse_args(default_argv(dt, aln_path, "gpu"))
    aln = read_alignment(aln_path, datatype=dt)
    model = cli._build_model(args, aln)
    params = cli._init_params(args, model, aln)
    D, secs = {}, {}
    for name, dev, dtype in (("gpu", cuda, torch.float32),
                             ("cpu", "cpu", torch.float64)):
        eng = LikelihoodEngine(aln, model, dtype=dtype, device=dev)
        if name == "gpu":
            distances.ml_pairwise_distances(eng, params)   # warm-up
            torch.cuda.synchronize()
        t = time.time()
        D[name] = distances.ml_pairwise_distances(eng, params)
        if name == "gpu":
            torch.cuda.synchronize()
            batch_k = spr.default_batch_k(eng, bionj(D[name]).rooted())
        secs[name] = time.time() - t
    gap = float(np.abs(D["gpu"] - D["cpu"]).max())
    rf = bionj(D["gpu"]).rf_distance(bionj(D["cpu"]))
    print(f". [{dt}] ML distances, {aln.n_otu * (aln.n_otu - 1) // 2} "
          f"pairs: card f32 {secs['gpu']:.3f} s (warm), CPU f64 "
          f"{secs['cpu']:.3f} s; max |D gpu - D cpu| {gap:.3e} (tol "
          f"{D_TOL:g}); BioNJ trees of the two: RF {rf}; scorer block "
          f"batch_k {batch_k}")
    if not gap <= D_TOL:
        fail(f"[{dt}] the card's ML distances are off the CPU's float64 "
             f"ones by {gap}")
    return batch_k


def small_default_check(dt, tmp):
    """The default run (BioNJ, NNI search) on a small problem: card
    float32 against CPU float64, the same tree and lnL within E2E_TOL."""
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.topology import Topology

    finals, trees = {}, {}
    for platform in ("cpu", "gpu"):
        d = os.path.join(tmp, f"small_default_{dt}_{platform}")
        aln_path, _ = write_problem(d, dt, 16, 500, SEED + 1)
        t = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(default_argv(dt, aln_path, platform)
                          + ["--quiet"])
        if rc != 0:
            fail(f"[{dt}] small default run on {platform} returned {rc}")
        finals[platform] = (stats_lnl(aln_path), time.time() - t)
        with open(f"{aln_path}_phyml_tree.txt") as fh:
            trees[platform] = fh.read()
    names = [f"T{i:04d}" for i in range(16)]
    rf = Topology.from_newick(trees["gpu"], names).rf_distance(
        Topology.from_newick(trees["cpu"], names))
    gap = finals["gpu"][0] - finals["cpu"][0]
    print(f". [{dt}] small default run (16 x 500, BioNJ + NNI): gpu f32 "
          f"{finals['gpu'][0]:.5f} ({finals['gpu'][1]:.1f} s)  cpu f64 "
          f"{finals['cpu'][0]:.5f} ({finals['cpu'][1]:.1f} s)  diff "
          f"{gap:.2e} (tol {E2E_TOL})  RF {rf}")
    if rf != 0 or not abs(gap) <= E2E_TOL:
        fail(f"[{dt}] the small default run disagrees between the card "
             "and the CPU")


def default_run(dt, aln_path, tree_path, cuda, batch_k):
    """The default `phyml` run (BioNJ start tree, NNI search with its
    SPR escapes and probes) at full width through the CLI, with every
    launch counter set to 0 just before and read just after, and the
    search's functions counted and timed (search_probes).  Returns the
    launch counts and the run's numbers."""
    import torch
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.topology import Topology

    argv = default_argv(dt, aln_path, "gpu")
    path = ("K1", "K2", "K3") if dt == "nt" else ("K4", "K5", "K3")
    W = wrappers()
    reset_counts()
    out = io.StringIO()
    with search_probes() as st, utilization_sampler() as util:
        torch.cuda.synchronize()
        t1 = time.time()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t1
    busy = statistics.mean(util) if util else None
    counts = {name: fn.launches for name, fn in W.items()}
    k3_by_b = dict(W["K3"].launches_by_batch)
    if rc != 0:
        fail(f"[{dt}] the default run returned {rc}")
    text = out.getvalue()
    with open(os.path.join(os.path.dirname(aln_path),
                           "default_run.log"), "w") as fh:
        fh.write(text)
    lnl_final = stats_lnl(aln_path)
    # the BioNJ tree's lnL at the starting parameters (after the run's
    # counters were read)
    args = cli.build_parser().parse_args(argv)
    aln = read_alignment(aln_path, datatype=dt)
    model = cli._build_model(args, aln)
    eng = LikelihoodEngine(aln, model, dtype=torch.float32, device=cuda)
    start = st["agglomeration"]["last"]
    lnl_start = float(eng.loglik(cli._init_params(args, model, aln),
                                 tree_arrays(start.rooted(), device=cuda)))
    with open(f"{aln_path}_phyml_tree.txt") as fh:
        topo = Topology.from_newick(fh.read(), aln.names)
    with open(tree_path) as fh:
        truth = Topology.from_newick(fh.read(), aln.names)
    rf_true, rf_start = topo.rf_distance(truth), start.rf_distance(truth)
    sizes = st["SPR scorer"]["sizes"]
    res = dict(
        wall_s=wall, bionj_s=st["distances"]["s"] + st["agglomeration"]["s"],
        distances_s=st["distances"]["s"],
        agglomeration_s=st["agglomeration"]["s"],
        search_s=wall - st["distances"]["s"] - st["agglomeration"]["s"],
        nni_rounds=st["NNI rounds"]["calls"],
        spr_sweeps=st["SPR sweeps"]["calls"],
        nni_scorer_calls=st["NNI scorer"]["calls"],
        nni_scorer_ms=1e3 * st["NNI scorer"]["s"] /
        max(1, st["NNI scorer"]["calls"]),
        spr_scorer_calls=st["SPR scorer"]["calls"],
        spr_scorer_ms=1e3 * st["SPR scorer"]["s"] /
        max(1, st["SPR scorer"]["calls"]),
        spr_candidates=sum(sizes), batch_k=batch_k,
        max_block=max(sizes, default=0), lnl_start=lnl_start,
        lnl_final=lnl_final, rf_true=rf_true, rf_start=rf_start,
        launches=counts, k3_by_batch=k3_by_b, nvml_busy=busy,
        idle_share=None if busy is None else 1 - busy,
        nvml_samples=len(util))
    print(f". [{dt}] default run (BioNJ + NNI search): wall {wall:.2f} s; "
          f"BioNJ {res['bionj_s']:.3f} s (distances "
          f"{res['distances_s']:.3f}, agglomeration "
          f"{res['agglomeration_s']:.3f}); search {res['search_s']:.2f} s; "
          f"{res['nni_rounds']} NNI rounds, {res['spr_sweeps']} SPR sweeps; "
          f"NNI scorer {res['nni_scorer_calls']} calls x "
          f"{res['nni_scorer_ms']:.1f} ms; SPR scorer "
          f"{res['spr_scorer_calls']} calls x {res['spr_scorer_ms']:.1f} ms "
          f"({res['spr_candidates']} candidates, blocks of at most "
          f"{res['max_block']}, batch_k {batch_k}); idle share "
          + ("not measured (no nvidia-smi samples)" if busy is None else
             f"{1 - busy:.3f} (nvidia-smi utilization, {len(util)} "
             "samples)"))
    print(f". [{dt}] default run: start (BioNJ) lnL {lnl_start:.5f}  final "
          f"lnL {lnl_final:.5f}  RF to the simulating tree {rf_true} "
          f"(BioNJ tree {rf_start})  launches {counts}, K3 by batch size "
          f"{k3_by_b}")
    if not (math.isfinite(lnl_final) and lnl_final >= lnl_start):
        fail(f"[{dt}] default run: final lnL is not finite or below the "
             "start lnL")
    if topo.n_otu != N_TAXA or not np.all(np.isfinite(topo.blen)):
        fail(f"[{dt}] default run: the output tree does not parse to a "
             "finite tree")
    if k3_by_b.get(1, 0):
        fail(f"[{dt}] default run: K3 ran {k3_by_b[1]} single-system "
             f"passes; those belong to {path[0]}")
    for name, count in counts.items():
        if name in path and count <= 0:
            fail(f"[{dt}] {name} never launched in the default run")
        if name not in path and count != 0:
            fail(f"[{dt}] {name} launched {count} times off its route in "
                 "the default run")
    return counts, res


def tree_labels(path, names):
    """{bipartition: support label} of a tree file's internal edges."""
    from phyml_tpu_torch.io.newick import parse_newick

    root = parse_newick(open(path).read())
    ids = {nm: i for i, nm in enumerate(names)}
    out = {}

    def leaves(node):
        if node.is_leaf:
            return {ids[node.name]}
        below = set().union(*(leaves(c) for c in node.children))
        if node is not root:
            side = below if 0 not in below else set(ids.values()) - below
            out[frozenset(side)] = node.support or node.name
        return below

    leaves(root)
    return out


def by_bipartition(support, tree_path, names):
    """An edge-id-keyed support dict of the tree in tree_path, keyed by
    bipartition (the side without taxon 0)."""
    from phyml_tpu_torch.topology import Topology

    with open(tree_path) as fh:
        bips = Topology.from_newick(fh.read(), names).bipartitions()
    return {bip: support[eid] for bip, eid in bips.items()}


def support_argv(dt, aln_path, tree_path, platform, b, *extra):
    """A supports run on a given tree: -u tree -o lr (the fit), -b b."""
    argv = cli_argv(dt, aln_path, tree_path, platform)
    argv[argv.index("-b") + 1] = str(b)
    return argv + list(extra)


def supports_phase(dt, aln_path, cuda):
    """The supports path on the default run's final 128 x 4096 tree,
    through the CLI a user runs (-u final tree -o lr, then the supports):
    `-b -5` (aBayes) and `-b -4` (SH-aLRT), timed, every support in
    [0, 1]; then the rapid bootstrap (`-b R --rapid_boot`, R =
    REPLICATES[dt]) with every launch counter set to 0 just before and
    read just after: wall, rounds, launches by stack size, peak memory,
    the NNI scorer's share.  Returns (launch counts, stacked launches by
    kernel, the phase's numbers)."""
    import shutil

    import torch
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.io.alignment import read_alignment

    names = read_alignment(aln_path, datatype=dt).names
    final = os.path.join(os.path.dirname(aln_path), "final_tree.nwk")
    shutil.copy(f"{aln_path}_phyml_tree.txt", final)
    res = {}
    for b, label in ((-5, "abayes"), (-4, "sh_alrt")):
        with search_probes(SUPPORT_PROBES) as st, \
                contextlib.redirect_stdout(io.StringIO()):
            torch.cuda.synchronize()
            t = time.time()
            rc = cli.main(support_argv(dt, aln_path, final, "gpu", b,
                                       "--quiet"))
            torch.cuda.synchronize()
            wall = time.time() - t
        if rc != 0:
            fail(f"[{dt}] -b {b} returned {rc}")
        vals = np.asarray(list(st["aLRT supports"]["last"].values()))
        res[label] = dict(wall_s=wall, supports_s=st["aLRT supports"]["s"],
                          edges=len(vals), min=float(vals.min()),
                          median=float(np.median(vals)),
                          max=float(vals.max()))
        print(f". [{dt}] -b {b} ({label}) on the final tree: wall "
              f"{wall:.2f} s (fit + supports), supports {res[label]['supports_s']:.3f} s, "
              f"{len(vals)} edges, min / median / max {vals.min():.4f} / "
              f"{np.median(vals):.4f} / {vals.max():.4f}")
        if len(vals) != N_TAXA - 3 or not np.all((vals >= 0) & (vals <= 1)):
            fail(f"[{dt}] -b {b}: supports outside [0, 1] or edges missing")

    R = REPLICATES[dt]
    W = wrappers()
    reset_counts()
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with search_probes(SUPPORT_PROBES) as st, \
            contextlib.redirect_stdout(out):
        t = time.time()
        rc = cli.main(support_argv(dt, aln_path, final, "gpu", R,
                                   "--rapid_boot"))
        torch.cuda.synchronize()
        wall = time.time() - t
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    counts = {name: fn.launches for name, fn in W.items()}
    stacked = {name: dict(fn.launches_by_trees) for name, fn in W.items()
               if hasattr(fn, "launches_by_trees")}
    k3_by_b = dict(W["K3"].launches_by_batch)
    if rc != 0:
        fail(f"[{dt}] the rapid bootstrap returned {rc}")
    text = out.getvalue()
    with open(os.path.join(os.path.dirname(aln_path), "rapid_boot.log"),
              "w") as fh:
        fh.write(text)
    boot = st["rapid bootstrap"]
    rounds = text.count("  boot round ")
    nni_s = st["NNI scorer"]["s"]
    labels = tree_labels(f"{aln_path}_phyml_tree.txt", names)
    vals = np.asarray([int(v) for v in labels.values()])
    res["rapid_boot"] = dict(
        replicates=R, wall_s=wall, bootstrap_s=boot["s"], rounds=rounds,
        blen_calls=st["batched branch lengths"]["calls"],
        blen_s=st["batched branch lengths"]["s"],
        nni_scorer_calls=st["NNI scorer"]["calls"], nni_scorer_s=nni_s,
        nni_scorer_share=nni_s / boot["s"], peak_gib=peak,
        launches=counts, stacked_launches=stacked, k3_by_batch=k3_by_b,
        supports_min=int(vals.min()), supports_max=int(vals.max()))
    print("\n".join(ln for ln in text.splitlines() if "boot round" in ln))
    print(f". [{dt}] rapid bootstrap R={R} on the final tree: wall "
          f"{wall:.2f} s (fit + bootstrap), bootstrap {boot['s']:.2f} s, "
          f"{rounds} rounds; batched branch lengths "
          f"{st['batched branch lengths']['calls']} calls "
          f"{st['batched branch lengths']['s']:.2f} s; NNI scorer "
          f"{st['NNI scorer']['calls']} calls {nni_s:.2f} s "
          f"({100 * nni_s / boot['s']:.1f} % of the bootstrap); peak "
          f"{peak:.2f} GiB; launches {counts}, stacked by R {stacked}, K3 "
          f"by batch size {k3_by_b}; supports {int(vals.min())}..."
          f"{int(vals.max())} of {R}")
    if len(vals) != N_TAXA - 3 or vals.min() < 0 or vals.max() > R:
        fail(f"[{dt}] rapid bootstrap: supports outside [0, {R}]")
    slot_k, edge_k = ("K1", "K2") if dt == "nt" else ("K4", "K5")
    if not sum(stacked["K3"].values()) or not sum(stacked[edge_k].values()):
        fail(f"[{dt}] the rapid bootstrap did not run K3 and {edge_k} on "
             f"stacks: {stacked}")
    if k3_by_b.get(1, 0):
        fail(f"[{dt}] rapid bootstrap run: K3 ran single-system passes")
    for name, count in counts.items():
        on = name in ("K3", slot_k, edge_k)
        if on != (count > 0):
            fail(f"[{dt}] rapid bootstrap run: {name} launched {count} "
                 "times")
    return counts, stacked, res


def small_support_check(tmp):
    """`-b 2` and `-b -5` after the default run on a 16 x 500 DNA
    problem, card float32 against CPU float64: the same final tree, the
    same two replicate trees and bootstrap counts, aBayes within
    ABAYES_TOL.  Returns the measured aBayes gap."""
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.search import support
    from phyml_tpu_torch.topology import Topology

    names = [f"T{i:04d}" for i in range(16)]
    got = {}
    real = support.bootstrap_supports

    def keep(*a, **kw):
        sup, trees = real(*a, **{**kw, "keep_trees": True})
        got[platform]["replicates"] = trees
        return sup

    for platform in ("cpu", "gpu"):
        got[platform] = {}
        d = os.path.join(tmp, f"small_support_{platform}")
        aln_path, _ = write_problem(d, "nt", 16, 500, SEED + 1)
        t = time.time()
        support.bootstrap_supports = keep
        try:
            argv = default_argv("nt", aln_path, platform) + ["--quiet"]
            argv[argv.index("-b") + 1] = "2"
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(argv)
        finally:
            support.bootstrap_supports = real
        if rc != 0:
            fail(f"small -b 2 run on {platform} returned {rc}")
        tree_path = f"{aln_path}_phyml_tree.txt"
        got[platform]["final"] = Topology.from_newick(open(tree_path).read(),
                                                      names)
        got[platform]["boot"] = tree_labels(tree_path, names)
        final = os.path.join(d, "final_tree.nwk")
        with open(final, "w") as fh:
            fh.write(got[platform]["final"].to_newick(names) + "\n")
        with search_probes(SUPPORT_PROBES) as st, \
                contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(support_argv("nt", aln_path, final, platform, -5,
                                       "--quiet"))
        if rc != 0:
            fail(f"small -b -5 run on {platform} returned {rc}")
        got[platform]["abayes"] = by_bipartition(
            st["aLRT supports"]["last"], final, names)
        got[platform]["s"] = time.time() - t
    g, c = got["gpu"], got["cpu"]
    rf = [a.rf_distance(b) for a, b in zip(g["replicates"],
                                            c["replicates"])]
    gap = max(abs(g["abayes"][k] - c["abayes"][k]) for k in c["abayes"])
    print(f". [nt] small supports (16 x 500, default run then -b 2, then "
          f"-u final -o lr -b -5): gpu {g['s']:.1f} s, cpu {c['s']:.1f} s; "
          f"final trees RF {g['final'].rf_distance(c['final'])}, replicate "
          f"trees RF {rf}, bootstrap counts equal "
          f"{g['boot'] == c['boot']}; aBayes max gap {gap:.3e} (tol "
          f"{ABAYES_TOL:g})")
    if g["final"].rf_distance(c["final"]) != 0 or any(rf) or \
            g["boot"] != c["boot"] or set(g["abayes"]) != set(c["abayes"]):
        fail("the small supports run disagrees between the card and the CPU")
    if not gap <= ABAYES_TOL:
        fail(f"aBayes of the small run off the CPU's by {gap}")
    return gap


def main() -> int:
    import torch

    t_all = time.time()
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
    log_path = os.path.join(os.path.dirname(so), "build.log")
    with open(log_path) as fh:
        for line in fh:
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"  ptxas: {line.strip()}")
    regs = {}
    for kname, fragment in PTXAS_KERNEL.items():
        regs[kname] = ptxas_report(log_path, fragment)
        print(f". {kname} ptxas (ns: registers, spill bytes): "
              f"{regs[kname]}")
        for ns in (4, 20):
            if ns not in regs[kname] or regs[kname][ns][0] is None:
                fail(f"no ptxas report for {kname} at ns={ns}")
            if regs[kname][ns][1] != 0:
                fail(f"{kname} spills {regs[kname][ns][1]} bytes at ns={ns}")

    rows, runs, supports = [], {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for dt in ("nt", "aa"):
            aln_path, tree_path = write_problem(
                os.path.join(tmp, dt), dt, N_TAXA, N_SITES, SEED)
            dt_rows = kernel_phases(dt, aln_path, tree_path, cuda, regs)
            torch.cuda.empty_cache()
            small_fit_check(dt, tmp)
            fit_counts, fit_k3 = main_path(dt, aln_path, tree_path, cuda)
            torch.cuda.empty_cache()
            batch_k = distance_check(dt, aln_path, cuda)
            small_default_check(dt, tmp)
            if dt == "nt":
                supports["small_abayes_gap"] = small_support_check(tmp)
            counts, res = default_run(dt, aln_path, tree_path, cuda,
                                      batch_k)
            runs[dt] = res
            torch.cuda.empty_cache()
            s_counts, stacked, supports[dt] = supports_phase(dt, aln_path,
                                                             cuda)
            # `launches`: the default run's (the main path), the
            # fixed-topology fit's beside them; the tree-axis rows',
            # the rapid bootstrap's (the supports path), by stack size
            for r in dt_rows:
                kname = r.pop("kernel")
                if r.pop("tree_axis", False):
                    r["launches"] = sum(stacked[kname].values())
                    r["launches_by_stack"] = stacked[kname]
                    continue
                r["launches"] = counts[kname]
                r["launches_fixed_fit"] = fit_counts[kname]
                r["launches_rapid_boot"] = s_counts[kname]
                if "B" in r:
                    r["launches_at_B"] = res["k3_by_batch"].get(r["B"], 0)
                    r["launches_at_B_fixed_fit"] = fit_k3.get(r["B"], 0)
            rows += dt_rows
            torch.cuda.empty_cache()

    print(f". chip_smoke: {time.time() - t_all:.0f} s in all, the kernels' "
          "build included")
    print(json.dumps({"default_runs": runs}))
    print(json.dumps({"supports": supports}, default=str))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
