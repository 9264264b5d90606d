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
   the plain version and beside R single launches.  The protein default
   run and its supports run on a 64-taxon problem (DEFAULT_RUN_TAXA);
10. the partitioned, mixture and flag paths: the two-partition XML run
   (`--xml`, the DNA problem split at site 2048, GTR+G4 and HKY85+G4,
   BioNJ and the NNI search) at full width; a two-matrix DNA mixture
   (HKY85 and GTR classes, each its own pi) fitted through the
   library, with K1, K2 and K3 against their plain versions at its
   system; LG4X on the protein problem (`-m LG4X`: the fixed fit at 128
   x 4096 and the default run at 64 taxa, K4, K5 and K3 at the LG4X
   system, K3 at the batch sizes
   those runs launched, on the line search's extreme grid points), each
   run with the launch counters reset just before and read just after;
   then 16 x 500 card-against-CPU runs of the LG4X fit, a one-partition
   XML mixture, the two-partition XML run with the SPR search, `--il`,
   `--aa_rate_file`, `-n 2` and a checkpoint resume;
11. phytime, the Bayesian dating chain: three `--xml` runs with a
   <phytime> root (run_xml on the card, the launch counters reset just
   before and read just after each, the chain's lnL evaluations and
   topology proposals counted and timed): the DNA problem under GTR+G4
   with the simulating tree as the user tree, a lognormal clock,
   topology moves, the birth-death prior, a root and a clade
   calibration, 5,000 iterations; the same under the Guindon clock
   (no <lineagerates>: the Gamma-MGF P-matrices) at a fixed topology,
   5,000; the 64-taxon protein problem under LG+G4, 2,000.  Each must
   run every posterior lnL through the route's slot kernel (K1 / K4;
   K2 / K5 for the start tree's branch lengths) and none through K3,
   give MALA weight 0, cache an lnL equal to a recompute, keep its
   heights feasible and its calibrations, and write a trace and a
   chronogram that parse; the slot kernel at each run's final
   P-matrices (MGF ones for the Guindon run) against its plain version;
12. other state counts, on the kernels' ladder (every rung built, ptxas
   checked for spills at each): DNA covarion GTR+G4 `--cov --cov_ncats
   3` (12 states, 128 taxa) and binary `-d generic` (2 states, padded
   to 4; 128 taxa), and past the ladder's top rung (32) protein covarion
   LG+G4 (60 states, padded to 64, 64 taxa: the big bodies), each with
   every kernel of its route against its plain version and the padding's
   cost, its fixed fit and (DNA covarion, binary) its default run at 64
   taxa, the launch counters reset just before and read just after;
   protein covarion `--cov_ncats 4` (80 states, 64
   taxa: the big bodies, csrc/big.cuh, ptxas checked for spills) with
   every kernel of its route against its plain version, K3 at the line
   search's B = 13 and 2, and its fixed fit, which must launch K3 at
   both; the kernels alone at 160 states (`--cov_ncats 8`, 32 taxa);
   then at 16 x 500 the covarion fits in the 'alpha' and 'free' modes,
   amino-acid covarion at two hidden classes (40 states) and at four
   (80: the fit and the default run), 7- and 36-state alphabets, the
   36-state alphabet at three hidden classes (108 states) and a dating
   chain that samples cov_delta;
13. the auxiliary tools (`aux_phase`): at 128 x 4096 through the CLI
   (`-u tree -o lr`, the fit first), DNA `--ancestral --cv tip --ps
   --alias_subpatt --mutmap`, DNA `--cv kfold.col` and `--cv kfold.pos`,
   protein `--ancestral --cv tip`, each with the launch counters reset
   just before and read just after (the fit's read as it returns: the
   tools after it launch nothing but the k-fold refits), every tool
   timed, its outputs parsed (the mutation map's events replayed
   within their edges); `run_phytime(fastlk=True)` on the DNA problem at
   64 taxa (lognormal clock, 10,000 iterations): its Hessian a float64 tensor
   on the card, no kernel launched; a `<phytime mutmap="yes">` XML at
   16 x 500;
14. PhyREX, the joint phylogeography chain (`phyrex_phase`): three
   `--xml` runs with a <phyrex> root on the DNA problem (taxa labelled
   S|Name|; tip coordinates simulated as Brownian motion down the
   simulating tree and written in the reference's coordinates format,
   read back through read_coordinates): <spatialmodel
   name="rrw+lognormal"> with a lognormal clock and topology moves,
   3,000 iterations; "ibm" at a fixed topology under the XML's default
   (Guindon) clock, 2,000 iterations with the posterior velocity
   draws; no <spatialmodel> (the SLFV event-disk sampler), 200 sweeps.
   Each with the launch counters reset just before and read just
   after: wall, ms an iteration (a sweep), sequence lnL evaluations
   and their ms, the location term's host ms, launches, idle share,
   peak; every posterior lnL on K1 (K2 only for the start chronogram,
   K3 never), its outputs parsed, its ancestral locations finite, its
   heights feasible; K1 at each run's final tree against its plain
   version;
15. --distributed (`distributed_phase`): DIST_RANKS ranks on the one
   card (gloo; NCCL refuses two ranks on one device), launched with
   `torchrun` after the kernels are built, each rerunning this script
   as `--rank-worker`: the sharded engine (1 x 2 sites mesh) at 128 x
   4096 against the unsharded one on the same card (the gathered site
   lnL against K3 at B = 1 on the whole pattern axis, the lnL against
   the host lnL, one branch-length round), the launch counters reset
   just before the sharded path and read just after (K3 at B = 1 and K2
   on every rank, K1 never), ms a sharded lnL (the all_reduce included)
   and an all_reduce beside the unsharded lnL's, K3 on a rank's shard
   against its plain version (the "K3 per shard" row); the farmed `-u
   final -o lr -b 4` on the DNA default run's final tree (wall, each
   rank's launches, supports in [0, 4]); and a 16 x 500 `--distributed
   -b 4` whose counts must equal the single-process `-b 4` on the card;
16. the 16 x 500 card-against-CPU checks of steps 5, 7, 9, 10, 11, 12,
   13 and 14 run last, after every full-width path: the CPU float64 side
   of each
   in a worker process (spawned, one torch thread each, all started
   together, stopped before the script ends), the card's side in this
   process meanwhile.  The dating check holds the card's start
   chronogram to the CPU's, the card's lnL and log prior at its start
   and at its chain's final state to a CPU float64 recompute, and a
   chain checkpointed at half and resumed on the card to the
   uninterrupted chain's final state; the tools' check holds the
   card's posteriors (within AUX_TOL, the same MAP states where the top
   two differ by more than MAP_TIE), CV tip score (CV_TOL) and fastlk
   Hessian (HESS_REL) to the CPU's, and replays the card's mutation map
   from its sampled states; the PhyREX check holds the card's start
   chronogram to the CPU's, the lnL and log prior (the location term
   included) at the final states of card rrw and ibm chains to a CPU
   float64 recompute, the SLFV sampler's posterior at its final state
   to `_loglik_np` + its prior + a float64 sequence lnL, and
   GeoModel.loglik on the card to the CPU's.

It prints a JSON line of the default runs' numbers, a JSON line of the
supports' numbers, a JSON line of step 10's numbers, a JSON line of
the phytime runs' numbers, a JSON line of step 12's numbers, a JSON
line of step 13's (`aux_tools`: each tool's wall-clock, the fits'
launches, the idle shares), a JSON line of step 14's (`phyrex`), a
JSON line of step 15's (`distributed`), a JSON line of per-kernel
results
(`launches` from the default run, `launches_fixed_fit` from step 6,
`launches_aux_tools_fit` from step 13's tools run; the stacked forms'
from the rapid bootstrap, by stack size; a cell's rows, named "[cell]",
from that cell's runs; the "K3 per shard" row's from the sharded
path, on each rank), the card line, and as the last line {"ok":
true, "device": {...}}.  Any failure exits nonzero before that line; so does a machine without CUDA, or a directory
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
# taxa of the default run's and the supports' problem: the protein runs
# (LG+G4, and LG4X's since PR 13) at 64 taxa keep the script inside its
# time limit (PERF.md section 4)
DEFAULT_RUN_TAXA = {"nt": 128, "aa": 64}
# the bench problems of tools/gen_bench_problem.py:38-51
FREQS = np.array([0.3, 0.2, 0.3, 0.2])           # DNA: GTR+G4
RATES = np.array([1.2, 3.0, 0.8, 1.1, 4.0, 1.0])
ALPHA = {"nt": 0.7, "aa": 0.9,                   # amino acids: LG+G4
         "generic": 0.7}                         # JC over an alphabet
# tolerances, all float32 on the card (tests/test_pallas.py):
SITE_TOL = {"nt": 5e-4, "aa": 2e-3,  # per-site lnL, kernel vs plain
            "generic": 5e-4}         # (K1/K3/K4; DNA :44, AA :287; the
#                                      state-count cells: 5e-4 below 20
#                                      states, 2e-3 from 20 up)
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
# tensor cores, HBM3 bandwidth, and TF32 on the tensor cores (K3/K4's big
# body: three TF32 passes a float32 product)
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_TF32 = 495e12
TF32_PASSES = 3

TPU_KERNEL = {
    "K1": "phyml_tpu/ops/pallas_clv_slots.py:139",
    "K2": "phyml_tpu/ops/pallas_edotp.py:387",
    "K3": "phyml_tpu/ops/pallas_clv.py:62",
    "K4": "phyml_tpu/ops/pallas_clv_slots.py:298",
    "K5": "phyml_tpu/ops/pallas_edotp.py:89",
}
SOURCE = {"K1": "clv_slots.cu", "K2": "edotp.cu", "K3": "clv.cu",
          "K4": "clv_slots_stream.cu", "K5": "edotp_stream.cu"}
# past the ladder (more than 32 states) each entry runs a big body
# (csrc/big.cuh, big_ffma.cuh): K1's and K4's the K4 body, K2's and
# K5's the K5 body
BIG_SOURCE = {"K1": "big_slots.cu", "K2": "big_edotp.cu",
              "K3": "big_slots.cu", "K4": "big_slots.cu",
              "K5": "big_edotp.cu"}


def source_of(kname, NS):
    """The source file of the body kname's entry runs at NS states."""
    from phyml_tpu_torch.ops import _build

    return BIG_SOURCE[kname] if _build.is_big(NS) else SOURCE[kname]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def wrappers():
    """Kernel name -> its wrapper."""
    from phyml_tpu_torch.ops import clv, clv_slots, edotp
    return {"K1": clv_slots.uppass_site_lse_slots,
            "K2": edotp.edge_dotprods,
            "K3": clv.uppass_site_lse,
            "K4": clv_slots.uppass_site_lse_slots_stream,
            "K5": edotp.edge_dotprods_stream}


# the port's counters (phyml_tpu_torch/utils/trace.py) at the last
# reset_counts: a phase's launches are read as differences from them
_counted_from: dict = {}


def reset_counts():
    """Start a phase's launch counts here."""
    from phyml_tpu_torch.utils import trace
    global _counted_from
    _counted_from = trace.snapshot()


def _counted():
    from phyml_tpu_torch.utils import trace
    return trace.since(_counted_from)


def launch_counts():
    """Kernel name -> its launches since reset_counts."""
    moved = _counted()
    return {k: moved.get(f"launch.{k}", 0) for k in wrappers()}


def launches_by(kernel, kind):
    """{B or R: launches} of `kernel` since reset_counts, by the batch
    size of one schedule (kind "batch", K3) or by the size of a stack
    of trees ("trees": K2, K3, K5)."""
    head = f"launch.{kernel}.{kind}."
    return {int(k[len(head):]): v for k, v in _counted().items()
            if k.startswith(head)}


def simulate(topo, model, params, n_sites, rng):
    """Sequences down the rooted tree under the model (the port's own
    P(t), float64 on the CPU); returns (names, seqs)."""
    from phyml_tpu_torch.datatypes import (
        AA_STATES, GENERIC_STATES, NT_STATES,
    )
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
    alphabet = {"nt": NT_STATES, "aa": AA_STATES,
                "generic": GENERIC_STATES}[model.datatype]
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


def write_problem(dirname, dt, n_taxa, n_sites, seed, generic_ns=2):
    """An alignment simulated down a random tree (mean branch length
    0.08) and that tree: GTR+G4 DNA, LG+G4 amino acids, or JC+G4 over a
    custom alphabet of generic_ns states (0-9, then A-Z, as -d generic
    reads them; 'X' is the missing-data code, so a 36-state problem
    shows state 33 as missing)."""
    from phyml_tpu_torch.models.substitution import SubstModel
    from phyml_tpu_torch.topology import Topology

    rng = np.random.default_rng(seed)
    topo = Topology.random(n_taxa, rng, mean_blen=0.08)
    if dt == "nt":
        model = SubstModel(datatype="nt", name="GTR", n_classes=4,
                           freqs_mode="fixed", fixed_freqs=FREQS)
    elif dt == "generic":
        model = SubstModel(datatype="generic", generic_ns=generic_ns,
                           n_classes=4)
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


def bound(flops, nbytes, tensor=False):
    """(least ms on the card, what bounds it): the larger of the
    operations over their peak (FP32, or with `tensor` the three TF32
    passes of K3/K4's big body on the tensor cores) and the bytes over
    HBM bandwidth."""
    t_ops = (TF32_PASSES * flops / PEAK_TF32 if tensor
             else flops / PEAK_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# mangled-name fragment of the kernels whose ptxas report is checked
PTXAS_KERNEL = {"K1": "slot_site_lse_kernel",
                "K2": "edge_dotprods_kernel", "K3": "batched_uppass_kernel",
                "K4": "slot_site_lse_stream_kernel",
                "K5": "edge_dotprods_stream_kernel"}
# ... and of the big body each entry runs past the ladder (one
# instantiation each, whose state count is a run-time argument)
BIG_PTXAS_KERNEL = {"K1": "big_slot_kernel", "K2": "big_edotp_kernel",
                    "K3": "big_uppass_kernel", "K4": "big_slot_kernel",
                    "K5": "big_edotp_kernel"}


def ptxas_report(log_path, fragment):
    """One kernel's ptxas report from the build log: state count ->
    (registers, spill bytes stored + loaded) of each instantiation; a
    kernel that is no template (the big bodies) under the key "big"."""
    import re

    out, ns = {}, None
    with open(log_path) as fh:
        for line in fh:
            m = re.search(r"(?:entry function|properties for) '?"
                          rf"\S*{fragment}(?:ILi(\d+)E|E)", line)
            if m:
                ns = int(m.group(1)) if m.group(1) else "big"
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


def ptxas_regs(log_path):
    """{kernel: {state count: (registers, spill bytes)}} of every
    instantiation of K1-K5 on the ladder and, under "big", of the big
    body each entry runs past it; fails on a missing report or a
    spill."""
    from phyml_tpu_torch.ops import _build

    regs = {}
    for kname, fragment in PTXAS_KERNEL.items():
        regs[kname] = ptxas_report(log_path, fragment)
        print(f". {kname} ptxas (ns: registers, spill bytes): "
              f"{regs[kname]}")
        for ns in _build.LADDER:
            if ns not in regs[kname] or regs[kname][ns][0] is None:
                fail(f"no ptxas report for {kname} at ns={ns}")
            if regs[kname][ns][1] != 0:
                fail(f"{kname} spills {regs[kname][ns][1]} bytes at ns={ns}")
    # the big bodies past the ladder: one instantiation each
    for kname, fragment in BIG_PTXAS_KERNEL.items():
        big = ptxas_report(log_path, fragment).get("big", (None, 0))
        print(f". {kname} past the ladder, {fragment} ptxas: {big[0]} "
              f"registers, {big[1]} B spilled")
        if big[0] is None:
            fail(f"no ptxas report for {fragment}")
        if big[1] != 0:
            fail(f"{fragment} spills {big[1]} bytes")
        regs[kname]["big"] = big
    # K6, the Newton solve: one instantiation (ns a run-time argument)
    k6 = ptxas_report(log_path, "edge_newton_kernel").get("big", (None, 0))
    print(f". K6 edge_newton_kernel ptxas: {k6[0]} registers, {k6[1]} B "
          "spilled")
    if k6[0] is None:
        fail("no ptxas report for edge_newton_kernel")
    if k6[1] != 0:
        fail(f"edge_newton_kernel spills {k6[1]} bytes")
    regs["K6"] = {"any": k6}
    return regs


def big_sass(so):
    """The big bodies' machine code (cuobjdump -sass of the library):
    {kernel: (TF32 HMMA, other HMMA, FFMA instructions)}; fails unless
    K3/K4's body runs its products on the tensor cores in TF32 (HMMA of
    the TF32 kind, no other kind) and K5's on FFMA with no HMMA
    (csrc/big_ffma.cuh)."""
    import re

    from phyml_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    txt = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", txt)[1:]:
        name, code = part.split("\n", 1)
        for frag in sorted(set(BIG_PTXAS_KERNEL.values())):
            if frag in name:
                hmma = re.findall(r"\bHMMA\.\S+", code)
                out[frag] = (sum("TF32" in h for h in hmma),
                             sum("TF32" not in h for h in hmma),
                             len(re.findall(r"\bFFMA\b", code)))
    for frag in sorted(set(BIG_PTXAS_KERNEL.values())):
        tf32, other, ffma = out.get(frag, (0, 0, 0))
        print(f". {frag} SASS: {tf32} HMMA (TF32), {other} HMMA of "
              f"another kind, {ffma} FFMA")
        if frag == BIG_PTXAS_KERNEL["K5"]:
            if tf32 or other or ffma == 0:
                fail(f"{frag}: its products are not FFMA ({ffma} FFMA, "
                     f"{tf32 + other} HMMA)")
        elif tf32 == 0 or other:
            fail(f"{frag}: its products are not TF32 mma.sync on the "
                 f"tensor cores ({tf32} TF32 HMMA, {other} other HMMA)")
    return out


def regs_at(regs, kname, NS):
    """(registers, spill bytes) of the body kname's entry runs at NS
    states: its rung's instantiation, or past the ladder its big body."""
    from phyml_tpu_torch.ops import _build

    return regs[kname]["big" if _build.is_big(NS) else NS]


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
    model = {"nt": ["-m", "GTR"], "aa": ["-d", "aa", "-m", "LG", "-a", "e"],
             "generic": ["-d", "generic", "-a", "e"]}[dt]
    return ["-i", aln_path, "-u", tree_path, *model, "-c", "4",
            "-o", "lr", "-b", "0", "--platform", platform,
            "--r_seed", "1"]


def stats_lnl(aln_path) -> float:
    with open(f"{aln_path}_phyml_stats.txt") as fh:
        for line in fh:
            if line.startswith(". Log-likelihood:"):
                return float(line.split(":")[1])
    fail("no Log-likelihood line in the stats file")


def site_tol(dt, ns):
    """Per-site tolerance of a kernel against its plain version: 5e-4
    below 20 states (DNA, DNA covarion, small alphabets), 2e-3 from 20
    up (amino acids, their covarion, large alphabets)."""
    return SITE_TOL["aa"] if ns >= 20 else SITE_TOL[dt]


def route_path(aln, model):
    """(host lnL kernel, edge kernel, "K3") of a problem: the kernels
    its runs must launch (likelihood.kernel_route at the model's state
    count; K3 serves the batches)."""
    from phyml_tpu_torch.ops.likelihood import kernel_route

    return (*kernel_route(aln.n_otu, model.n_classes, model.ns), "K3")


def grid_rows(slots, params, B):
    """B parameter vectors of optimize_scalars's first zoom level (every
    slot swept over its whole bracket, 12 points and the current value,
    one slot at a time), cycled to B rows: the line search's extreme
    grid points."""
    from phyml_tpu_torch.optim.round import _get, _x0_of

    cur = [_x0_of(tf, _get(params, nm, i)) for nm, i, tf, _, _ in slots]
    rows = []
    for j, (_, _, _, lo, hi) in enumerate(slots):
        for x in list(np.linspace(lo, hi, 12)) + [cur[j]]:
            r = list(cur)
            r[j] = x
            rows.append(r)
    return np.asarray([rows[b % len(rows)] for b in range(B)])


def kernel_phases(dt, aln_path, tree_path, cuda, regs, model=None,
                  params=None, cell=None, k3_batches=None, extra=()):
    """Each kernel of the path against its plain version on the same
    card tensors at the main path's shapes; returns the kernels' JSON
    entries (launches filled in later).  `model` and `params` replace
    the CLI's model and the simulation's parameters for a cell of its
    own (`cell` names it in each row; no tree-axis rows), or `extra`
    CLI flags the CLI's model (the state-count cells), and
    `k3_batches` the K3 batch sizes, then filled from the line search's
    first zoom level (grid_rows)."""
    import torch
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.ops import _build, clv, clv_slots, edotp
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.optim.round import _batched_params, free_scalar_slots
    from phyml_tpu_torch.topology import Topology

    aln = read_alignment(aln_path, datatype=dt)
    if model is None:
        args = cli.build_parser().parse_args(cli_argv(
            dt, aln_path, tree_path, "gpu") + list(extra))
        model = cli._build_model(args, aln)
        params = true_params(dt, cli._init_params(args, model, aln))
    tag = dt if cell is None else f"{dt} {cell}"
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
    want = ("K1", "K2") if (dt, ns) == ("nt", 4) else \
        ("K4", "K5") if (dt, ns) == ("aa", 20) else route_path(aln, model)[:2]
    NS = _build.rung(ns)
    print(f". [{tag}] problem: {n} taxa, {aln.n_sites} sites, {k} "
          f"patterns, C={C}, ns={ns} (kernels at {NS}); route "
          f"{lnl_k}/{edge_k}")
    if (lnl_k, edge_k) != want:
        fail(f"[{tag}] route {lnl_k}/{edge_k}, expected {want}")
    W = wrappers()
    rows = []

    def row(kname, label, err, ms, plain_ms, tol, flops, nb, on_path=True,
            **extra):
        # past the ladder K3/K4's big body (K1's entry too) runs its
        # products as 3xTF32 on the tensor cores: its bound is the
        # tensor one, the FP32 one beside it; K5's (K2's) runs FFMA.
        # Each big row also gives its tile.
        big = _build.is_big(NS)
        tensor = big and kname not in ("K2", "K5")
        b_ms, b_by = bound(flops, nb, tensor=tensor)
        if tensor:
            extra["bound_fp32_ms"] = bound(flops, nb)[0]
        if big:
            extra["tile"] = (edotp.geometry(ns, C, k)["tile"]
                             if kname in ("K2", "K5") else
                             clv.big_geometry(ns, C, k, n_slots)["tile"])
        print(f". [{tag}] {kname} {label}: max|d|={err:.3e} (tol {tol:g})  "
              f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound "
              f"{b_ms:.4f} ms ({b_by})"
              + (f", FP32 bound {extra['bound_fp32_ms']:.4f} ms"
                 if tensor else "")
              + (f", tile {extra['tile']}" if big else "")
              + ("" if on_path else "  [not on this path]"))
        if not (err <= tol):
            fail(f"[{tag}] {kname} disagrees with its plain version: "
                 f"{err} > {tol}")
        if on_path:
            if cell is not None:
                label, extra["cell"] = f"{label} [{cell}]", cell
            rows.append(dict(
                name=f"{kname} {label}", route="cuda",
                source=f"phyml_tpu_torch/csrc/{source_of(kname, NS)}",
                replaces=TPU_KERNEL[kname], launches=0, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, ns=ns, path=dt, kernel=kname, **extra))

    # one parameter set (the host lnL and the branch-length probes): K1
    # (DNA) or K4 (amino acids), against K1's plain version and beside
    # K3 at B=1 on the same tensors, each with its peak memory, registers,
    # spills and the blocks per SM the runtime grants
    args1 = (sched, eng.slot_tips, pm, pi, logw)
    # a launch between rungs copies its tips, P-matrices and pi to the
    # rung (K2/K5 also V and V^-1): bytes, and a slack for the copies'
    # rounding up to the caching allocator's 2 MiB segments
    pad_bytes = 4 * (n * NS * -(-k // clv_slots.TILE) * clv_slots.TILE
                     + eng.n_nodes * C * NS * NS + C * NS) if NS != ns else 0
    pad_slack = 1.0 + (5 * 2.0 if NS != ns else 0.0)
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
            print(f". [{tag}] {kname}: refused at this shape (each class's "
                  f"P-matrices of the whole tree: a block would need "
                  f"{geo['block_smem_bytes'] / 1024:.1f} KB of shared "
                  "memory)  [not on this path]")
            if kname == lnl_k:
                fail(f"[{tag}] the route's {kname} refuses its shape")
            continue
        s_regs, spill = regs_at(regs, kname, NS)
        blocks = clv_slots.blocks_per_sm(ns, C, n, n_slots, not resident)
        peak = peak_mib(lambda: W[kname](*args1, n_slots=n_slots))
        print(f". [{tag}] {kname}: {s_regs} registers, {spill} B spilled, "
              f"{geo['blocks']} blocks of {geo['warps_per_block']} warps "
              f"({geo['tile']} patterns, "
              + ("K4's big body: a warp per 8 patterns, 3xTF32 on the "
                 "tensor cores, a block a class" if _build.is_big(NS) else
                 "a warp per class") + ", "
              f"{geo['block_smem_bytes'] / 1024:.1f} KB shared memory), "
              f"{blocks} per SM granted "
              f"({blocks * geo['warps_per_block']} warps); peak "
              f"{peak:.3f} MiB beyond its inputs (out "
              f"{k * 4 / 2 ** 20:.3f} MiB)")
        if peak > (k * 4 + pad_bytes) / 2 ** 20 + pad_slack:
            fail(f"[{tag}] {kname} allocates more than its outputs")
        out, ms = timed(lambda: W[kname](*args1, n_slots=n_slots))
        print(f". [{tag}] {kname} {ms:.4f} ms beside K3 at B=1 {k3_ms:.4f} "
              "ms on the same tensors")
        row(kname, W[kname].__name__, float((out - ref).abs().max()), ms,
            pms, site_tol(dt, ns), slot_flops, slot_bytes,
            on_path=kname == lnl_k, registers=s_regs, spill_bytes=spill,
            blocks_per_sm=blocks,
            warps_per_sm=blocks * geo["warps_per_block"], peak_mib=peak,
            k3_b1_ms=k3_ms)
        if kname == lnl_k:
            got = out
    lnl32 = float(torch.sum(got.double() * eng.weights))
    eng64 = LikelihoodEngine(aln, model, dtype=torch.float64, device=cuda)
    tree64 = tree_arrays(rv, dtype=torch.float64, device=cuda)
    lnl64 = float(torch.sum(eng64.site_logliks_scan(
        eng64.system_of(params), tree64) * eng64.weights))
    print(f". [{tag}] {lnl_k} lnL {lnl32:.6f} vs float64 scan {lnl64:.6f}")
    if not abs(lnl32 - lnl64) <= F64_TOL:
        fail(f"[{tag}] {lnl_k} lnL off the float64 evaluation by "
             f"{lnl32 - lnl64}")
    del eng64, tree64

    # K3: the line search's pair probe (B=2) and its grid (13 systems
    # per free scalar, optimize_scalars grid=12 plus the current value),
    # and one system (B=1, which the main path sends to K1/K4), one
    # launch each, through the topology's slot schedule
    slots = free_scalar_slots(model, params)
    rng = np.random.default_rng(SEED)
    # K3's warps a block
    k3_w = clv.big_geometry(ns, C, k, n_slots)["warps_per_block"] \
        if _build.is_big(NS) else C
    tp = 32 * max(1, 4 // C)   # the pattern tile of a workspace kernel
    for B in k3_batches or (1, 2, 13 * len(slots)):
        blocks = clv.blocks_per_sm(ns, C, n_slots)
        k3_regs, spill = regs_at(regs, "K3", NS)
        print(f". [{tag}] K3 B={B}: {n_slots} slots, {k3_regs} registers, "
              f"{spill} B spilled, {blocks} blocks of {32 * k3_w} threads "
              f"per SM ({blocks * k3_w} warps)")
        if B == 1:
            argsb = (child, eng.tips, pm, pi, logw)
        else:
            S = grid_rows(slots, params, B) if k3_batches else \
                np.asarray([[rng.uniform(max(lo, -3.0), min(hi, 3.0))
                             for _, _, _, lo, hi in slots]
                            for _ in range(B)])
            sysb = eng._system(_batched_params(params, slots, S))
            pmb = eng._pmats(sysb[0], sysb[1], sysb[2], tree.blen)
            argsb = (child, eng.tips, pmb, sysb[3], eng._logw(sysb[4]))
        k3 = lambda: clv.uppass_site_lse(*argsb, sched=sched,
                                         n_slots=n_slots)
        peak = peak_mib(k3)
        old_ws = B * (n - 1) * C * (ns + 1) * (-(-k // tp) * tp) * 4
        print(f". [{tag}] K3 B={B}: peak {peak:.2f} MiB beyond its "
              f"inputs (output {B * k * 4 / 2 ** 20:.2f} MiB; a device-"
              f"memory workspace of every internal node's partial would "
              f"take {old_ws / 2 ** 20:.1f} MiB, computed)")
        got, ms = timed(k3)
        plain = (lambda: clv.uppass_site_lse_plain(
            child, eng.tips, pm[None], pi[None], logw[None])[0]) \
            if B == 1 else (lambda: clv.uppass_site_lse_plain(*argsb))
        ref, pms = timed(plain, 1)
        row("K3", f"uppass_site_lse (B={B})",
            float((got - ref).abs().max()), ms, pms, site_tol(dt, ns),
            pruning_flops(n, C, ns, k, B),
            nbytes(*argsb[1:], sched) + B * k * 4, B=B, peak_mib=peak,
            registers=k3_regs, spill_bytes=spill, blocks_per_sm=blocks,
            warps_per_sm=blocks * k3_w)
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
    # more (at the rung; a padded call adds its padded tips, P-matrices,
    # V, V^-1 and pi)
    geo = edotp.geometry(ns, C, k)
    out_bytes = eng.n_nodes * C * (NS + 1) * k * 4 + \
        (pad_bytes + 4 * 2 * C * NS * NS if NS != ns else 0)
    ws_bytes = 2 * (n - 1) * geo["workspace_floats_per_node"] * 4
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for kname in ("K2", "K5"):
        blocks = edotp.blocks_per_sm(ns, kname == "K5")
        e_regs, spill = regs_at(regs, kname, NS)
        peak = peak_mib(lambda: W[kname](*args2))
        ew = geo["warps_per_block"]
        print(f". [{tag}] {kname}: {e_regs} registers, {spill} B spilled, "
              f"{geo['blocks']} blocks of {ew} warp(s) ({geo['tile']} "
              f"patterns x 1 class), {blocks} per SM granted "
              f"({blocks * ew} warps), "
              f"{geo['blocks'] / sms:.1f} per SM on {sms} SMs; peak "
              f"{peak:.2f} MiB beyond its inputs (outputs "
              f"{out_bytes / 2 ** 20:.2f} + workspace "
              f"{ws_bytes / 2 ** 20:.2f} MiB)")
        if peak > (out_bytes + ws_bytes) / 2 ** 20 + pad_slack:
            fail(f"[{tag}] {kname} allocates more than its outputs and "
                 "workspace")
        (dk, sk), ms = timed(lambda: W[kname](*args2))
        site_k = eng.edge_site_terms(dk, sk, aux, tree.blen)[0]
        del dk, sk
        row(kname, W[kname].__name__,
            float((site_k[mask] - site_p[mask]).abs().max()), ms, pms,
            EDGE_TOL, edotp_flops(n, C, ns, k), edge_bytes,
            on_path=kname == edge_k, registers=e_regs, spill_bytes=spill,
            blocks_per_sm=blocks, warps_per_sm=blocks * ew, peak_mib=peak)
    del site_p
    if NS != ns:
        # the padding a K1/K4 launch between rungs pays: its tips,
        # P-matrices and pi copied to the rung
        _, pad_ms = timed(lambda: (clv_slots.padded_tips(eng.slot_tips, NS),
                                   _build.pad_states(pm, NS, (2, 3)),
                                   _build.pad_states(pi, NS, (1,))))
        print(f". [{tag}] padding {ns} -> {NS} states: tips, P-matrices "
              f"and pi {pad_ms:.4f} ms a K1/K4 launch")
        for r in rows:
            r["pad_ms"] = pad_ms
    for r in rows:
        r["ns_kernel"] = NS
    torch.cuda.empty_cache()
    if cell is None:
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
        float((got - ref).abs().max()), ms, pms, site_tol(dt, ns),
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


def fit_side(dt, d, platform):
    """The whole fixed-topology fit on a 16 x 500 problem: its final
    lnL."""
    from phyml_tpu_torch import cli

    aln_path, tree_path = write_problem(d, dt, 16, 500, SEED + 1)
    rc = cli.main(cli_argv(dt, aln_path, tree_path, platform) + ["--quiet"])
    if rc != 0:
        fail(f"[{dt}] small fit on {platform} returned {rc}")
    return stats_lnl(aln_path)


def report_fit(dt, gpu, cpu):
    """The small fit: card float32 against CPU float64 (the port's
    reference dtype)."""
    gap = gpu[0] - cpu[0]
    print(f". [{dt}] small fit (16 x 500): gpu f32 {gpu[0]:.5f}  "
          f"cpu f64 {cpu[0]:.5f}  diff {gap:.2e} (tol {E2E_TOL})")
    if not abs(gap) <= E2E_TOL:
        fail(f"[{dt}] small fit disagrees between the card and the CPU")


def main_path(dt, aln_path, tree_path, cuda, extra=(), runs=2, tag=None):
    """The CLI a user runs (the fixed-topology fit, `extra` flags
    appended), with every launch counter set to 0 just before and read
    just after, its peak device memory and the card's idle share; then
    (runs=2) a second, warm run, timed only.  Returns the counts of the
    first run, its K3 launches by batch size and its numbers."""
    import torch
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.topology import Topology

    tag = tag or dt
    argv = cli_argv(dt, aln_path, tree_path, "gpu") + list(extra)
    args = cli.build_parser().parse_args(argv)
    aln = read_alignment(aln_path, datatype=dt)
    with open(tree_path) as fh:
        rv = Topology.from_newick(fh.read(), aln.names).rooted()
    model = cli._build_model(args, aln)
    eng = LikelihoodEngine(aln, model, dtype=torch.float32, device=cuda)
    lnl_start = float(eng.loglik(cli._init_params(args, model, aln),
                                 tree_arrays(rv, device=cuda)))
    del eng
    path = route_path(aln, model)
    walls = []
    for run in range(runs):
        reset_counts()
        out = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.time()
        with utilization_sampler() as util, contextlib.redirect_stdout(out):
            rc = cli.main(argv)
            torch.cuda.synchronize()
        walls.append(time.time() - t1)
        if run == 0:
            counts = launch_counts()
            k3_by_b = launches_by("K3", "batch")
            text = out.getvalue()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            busy = statistics.mean(util) if util else None
        if rc != 0:
            fail(f"[{tag}] main path returned {rc}")
    print(text.rstrip())
    rounds = text.count("  round ")
    lnl_final = stats_lnl(aln_path)
    res = dict(wall_s=walls[0], warm_wall_s=walls[1:], rounds=rounds,
               lnl_start=lnl_start, lnl_final=lnl_final, peak_gib=peak,
               idle_share=None if busy is None else 1 - busy,
               launches=counts, k3_by_batch=k3_by_b,
               **class_rates(aln_path))
    print(f". [{tag}] main path: start lnL {lnl_start:.5f}  final lnL "
          f"{lnl_final:.5f}  rounds {rounds}  wall "
          + ", ".join(f"{w:.2f}" for w in walls) + " s (the first run in "
          f"the process first)  peak {peak:.2f} GiB  idle share "
          + ("not measured" if busy is None else f"{1 - busy:.3f}")
          + f"  launches {counts}, K3 by batch size {k3_by_b}"
          + (f"  classes {res['classes']}" if res["classes"] else ""))
    if not (math.isfinite(lnl_final) and lnl_final >= lnl_start):
        fail(f"[{tag}] final lnL is not finite or below the start lnL")
    with open(f"{aln_path}_phyml_tree.txt") as fh:
        topo = Topology.from_newick(fh.read(), aln.names)
    if topo.n_otu != aln.n_otu or not np.all(np.isfinite(topo.blen)):
        fail(f"[{tag}] the output tree does not parse to a finite tree")
    if k3_by_b.get(1, 0):
        fail(f"[{tag}] K3 ran {k3_by_b[1]} single-system passes; those "
             f"belong to {path[0]}")
    for name, count in counts.items():
        if name in path and count <= 0:
            fail(f"[{tag}] {name} never launched on the main path")
        if name not in path and count != 0:
            fail(f"[{tag}] {name} launched {count} times off its route")
    return counts, k3_by_b, res


def class_rates(aln_path):
    """{"classes": [(rate, weight), ...]} of a FreeRate or mixture
    stats file (empty otherwise)."""
    import re

    with open(f"{aln_path}_phyml_stats.txt") as fh:
        text = fh.read()
    return {"classes": [(float(r), float(w)) for r, w in re.findall(
        r"Rate class \d+: \s*rate=(\S+) weight=(\S+)", text)]}


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

    def sync():
        # a worker process of the CPU float64 runs has no CUDA context
        # and must not make one
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    stats, saved = {}, []
    for mod_name, attr, label in probes:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        rec = stats[label] = {"calls": 0, "s": 0.0, "sizes": []}

        def wrapped(*a, _fn=fn, _rec=rec, **kw):
            sync()
            t = time.time()
            out = _fn(*a, **kw)
            sync()
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


def distance_check(dt, aln_path, cuda, extra=()):
    """The card's ML distances (float32) against the CPU's float64 on
    the same alignment and starting parameters (`extra` CLI flags
    appended); returns the engine's scorer block size
    (spr.default_batch_k on the BioNJ tree)."""
    import torch
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine
    from phyml_tpu_torch.search import distances, spr
    from phyml_tpu_torch.search.bionj import bionj

    args = cli.build_parser().parse_args(default_argv(dt, aln_path, "gpu")
                                         + list(extra))
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


def default_side(dt, d, platform):
    """The default run (BioNJ, NNI search) on a 16 x 500 problem: (final
    lnL, the tree file's text)."""
    from phyml_tpu_torch import cli

    aln_path, _ = write_problem(d, dt, 16, 500, SEED + 1)
    rc = cli.main(default_argv(dt, aln_path, platform) + ["--quiet"])
    if rc != 0:
        fail(f"[{dt}] small default run on {platform} returned {rc}")
    with open(f"{aln_path}_phyml_tree.txt") as fh:
        return stats_lnl(aln_path), fh.read()


def report_default(dt, gpu, cpu):
    """The small default run: card float32 against CPU float64, the
    same tree and lnL within E2E_TOL."""
    from phyml_tpu_torch.topology import Topology

    (g, g_s), (c, c_s) = gpu, cpu
    names = [f"T{i:04d}" for i in range(16)]
    rf = Topology.from_newick(g[1], names).rf_distance(
        Topology.from_newick(c[1], names))
    gap = g[0] - c[0]
    print(f". [{dt}] small default run (16 x 500, BioNJ + NNI): gpu f32 "
          f"{g[0]:.5f} ({g_s:.1f} s)  cpu f64 {c[0]:.5f} ({c_s:.1f} s)  "
          f"diff {gap:.2e} (tol {E2E_TOL})  RF {rf}")
    if rf != 0 or not abs(gap) <= E2E_TOL:
        fail(f"[{dt}] the small default run disagrees between the card "
             "and the CPU")


def default_run(dt, aln_path, tree_path, cuda, batch_k, extra=(), tag=None):
    """The default `phyml` run (BioNJ start tree, NNI search with its
    SPR escapes and probes; `extra` flags appended) through the CLI,
    with every launch counter set to 0 just before and read just after,
    the search's functions counted and timed (search_probes), and its
    peak device memory.  Returns the launch counts and the run's
    numbers."""
    import torch
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.topology import Topology

    tag = tag or dt
    argv = default_argv(dt, aln_path, "gpu") + list(extra)
    args = cli.build_parser().parse_args(argv)
    aln = read_alignment(aln_path, datatype=dt)
    model = cli._build_model(args, aln)
    path = route_path(aln, model)
    reset_counts()
    out = io.StringIO()
    with search_probes() as st, utilization_sampler() as util:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.time()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t1
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    busy = statistics.mean(util) if util else None
    counts = launch_counts()
    k3_by_b = launches_by("K3", "batch")
    if rc != 0:
        fail(f"[{tag}] the default run returned {rc}")
    text = out.getvalue()
    with open(os.path.join(os.path.dirname(aln_path),
                           "default_run.log"), "w") as fh:
        fh.write(text)
    lnl_final = stats_lnl(aln_path)
    # the BioNJ tree's lnL at the starting parameters (after the run's
    # counters were read)
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
        nvml_samples=len(util), n_taxa=aln.n_otu, peak_gib=peak,
        **class_rates(aln_path))
    print(f". [{tag}] default run (BioNJ + NNI search), {aln.n_otu} taxa: "
          f"wall {wall:.2f} s; peak {peak:.2f} GiB; "
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
    print(f". [{tag}] default run: start (BioNJ) lnL {lnl_start:.5f}  final "
          f"lnL {lnl_final:.5f}  RF to the simulating tree {rf_true} "
          f"(BioNJ tree {rf_start})  launches {counts}, K3 by batch size "
          f"{k3_by_b}"
          + (f"  classes {res['classes']}" if res["classes"] else ""))
    if not (math.isfinite(lnl_final) and lnl_final >= lnl_start):
        fail(f"[{tag}] default run: final lnL is not finite or below the "
             "start lnL")
    if topo.n_otu != aln.n_otu or not np.all(np.isfinite(topo.blen)):
        fail(f"[{tag}] default run: the output tree does not parse to a "
             "finite tree")
    if k3_by_b.get(1, 0):
        fail(f"[{tag}] default run: K3 ran {k3_by_b[1]} single-system "
             f"passes; those belong to {path[0]}")
    for name, count in counts.items():
        if name in path and count <= 0:
            fail(f"[{tag}] {name} never launched in the default run")
        if name not in path and count != 0:
            fail(f"[{tag}] {name} launched {count} times off its route in "
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
    n_taxa = len(names)
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
        if len(vals) != n_taxa - 3 or not np.all((vals >= 0) & (vals <= 1)):
            fail(f"[{dt}] -b {b}: supports outside [0, 1] or edges missing")

    R = REPLICATES[dt]
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
    counts = launch_counts()
    stacked = {k: launches_by(k, "trees") for k in ("K2", "K3", "K5")}
    k3_by_b = launches_by("K3", "batch")
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
    if len(vals) != n_taxa - 3 or vals.min() < 0 or vals.max() > R:
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


def support_side(d, platform):
    """`-b 2` and then `-b -5` on its final tree, after the default run
    on a 16 x 500 DNA problem: {final tree, replicate trees, bootstrap
    labels by bipartition, aBayes by bipartition}."""
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.search import support
    from phyml_tpu_torch.topology import Topology

    names = [f"T{i:04d}" for i in range(16)]
    got = {}
    real = support.bootstrap_supports

    def keep(*a, **kw):
        sup, trees = real(*a, **{**kw, "keep_trees": True})
        got["replicates"] = trees
        return sup

    aln_path, _ = write_problem(d, "nt", 16, 500, SEED + 1)
    support.bootstrap_supports = keep
    try:
        argv = default_argv("nt", aln_path, platform) + ["--quiet"]
        argv[argv.index("-b") + 1] = "2"
        rc = cli.main(argv)
    finally:
        support.bootstrap_supports = real
    if rc != 0:
        fail(f"small -b 2 run on {platform} returned {rc}")
    tree_path = f"{aln_path}_phyml_tree.txt"
    with open(tree_path) as fh:
        got["final"] = Topology.from_newick(fh.read(), names)
    got["boot"] = tree_labels(tree_path, names)
    final = os.path.join(d, "final_tree.nwk")
    with open(final, "w") as fh:
        fh.write(got["final"].to_newick(names) + "\n")
    with search_probes(SUPPORT_PROBES) as st:
        rc = cli.main(support_argv("nt", aln_path, final, platform, -5,
                                   "--quiet"))
    if rc != 0:
        fail(f"small -b -5 run on {platform} returned {rc}")
    got["abayes"] = by_bipartition(st["aLRT supports"]["last"], final, names)
    return got


def report_support(gpu, cpu):
    """The small supports run, card float32 against CPU float64: the
    same final tree, the same two replicate trees and bootstrap counts,
    aBayes within ABAYES_TOL.  Returns the measured aBayes gap."""
    (g, g_s), (c, c_s) = gpu, cpu
    rf = [a.rf_distance(b) for a, b in zip(g["replicates"],
                                            c["replicates"])]
    gap = max(abs(g["abayes"][k] - c["abayes"][k]) for k in c["abayes"])
    print(f". [nt] small supports (16 x 500, default run then -b 2, then "
          f"-u final -o lr -b -5): gpu {g_s:.1f} s, cpu {c_s:.1f} s; "
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


# ---------------------------------------------------------------------------
# LG4X and matrix mixtures, partitioned --xml runs, the remaining flags
# ---------------------------------------------------------------------------

# the DNA mixture's classes (an XML <mixtureelem> list of two matrices):
# HKY85 (kappa 4) and the bench problem's GTR, each with its own pi
MIX_PI = np.array([[0.3, 0.2, 0.3, 0.2], [0.2, 0.3, 0.25, 0.25]])


def dna_mixture():
    """The two-matrix DNA mixture, FreeRate rates and weights."""
    from phyml_tpu_torch.models.substitution import SubstModel

    hky = np.ones((4, 4)) - np.eye(4)
    hky[0, 2] = hky[2, 0] = hky[1, 3] = hky[3, 1] = 4.0
    gtr = np.zeros((4, 4))
    gtr[np.triu_indices(4, k=1)] = RATES
    return SubstModel(datatype="nt", name="XMLMIX", n_classes=2,
                      freerate=True, freqs_mode="model",
                      components=[(hky, MIX_PI[0]), (gtr + gtr.T, MIX_PI[1])])


def mixture_params(model):
    """Starting parameters with the classes' rates spread (0.4, 1.6)."""
    import torch

    params = model.init_params()
    params["class_rates_raw"] = torch.log(torch.tensor(
        [0.4, 1.6][:model.n_classes], dtype=torch.float64))
    return params


def copy_problem(src_aln, src_tree, dirname):
    """The alignment and tree files copied into a directory of their own
    (a run writes its outputs next to its alignment)."""
    import shutil

    os.makedirs(dirname, exist_ok=True)
    dst = os.path.join(dirname, "aln.phy")
    shutil.copy(src_aln, dst)
    return dst, src_tree


def scorer_block(dt, aln_path, extra, cuda):
    """spr.default_batch_k of the run's model on the problem's
    simulating-size tree (the SPR scorer's block)."""
    import torch
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine
    from phyml_tpu_torch.search import spr
    from phyml_tpu_torch.topology import Topology

    args = cli.build_parser().parse_args(default_argv(dt, aln_path, "gpu")
                                         + list(extra))
    aln = read_alignment(aln_path, datatype=dt)
    eng = LikelihoodEngine(aln, cli._build_model(args, aln),
                           dtype=torch.float32, device=cuda)
    rv = Topology.random(aln.n_otu, np.random.default_rng(0)).rooted()
    return spr.default_batch_k(eng, rv)


def mixture_fit(aln_path, tree_path, cuda):
    """The fixed-topology fit of the DNA mixture (dna_mixture) on the
    DNA problem through the library's entry points (LikelihoodEngine,
    round_optimize: the XML front end builds such a model but phyml_tpu's
    XML reads built-in matrices for amino acids only), with every launch
    counter set to 0 just before and read just after.  Returns (counts,
    K3 by batch size, numbers)."""
    import torch
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.optim.round import round_optimize
    from phyml_tpu_torch.topology import Topology

    aln = read_alignment(aln_path, datatype="nt")
    model = dna_mixture()
    params = mixture_params(model)
    with open(tree_path) as fh:
        rv = Topology.from_newick(fh.read(), aln.names).rooted()
    eng = LikelihoodEngine(aln, model, dtype=torch.float32, device=cuda)
    tree = tree_arrays(rv, device=cuda)
    reset_counts()
    out = io.StringIO()
    torch.cuda.synchronize()
    t = time.time()
    lnl0 = float(eng.loglik(params, tree))
    with contextlib.redirect_stdout(out):
        params, tree, lnl = round_optimize(eng, model, params, tree,
                                           verbose=True)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = launch_counts()
    k3_by_b = launches_by("K3", "batch")
    from phyml_tpu_torch.models.rates import freerate_normalize
    r, w = freerate_normalize(params["class_rates_raw"],
                              params["class_weights_raw"])
    res = dict(wall_s=wall, rounds=out.getvalue().count("  round "),
               lnl_start=lnl0, lnl_final=lnl, launches=counts,
               k3_by_batch=k3_by_b,
               classes=[(float(a), float(b)) for a, b in zip(r, w)])
    print(f". [nt mixture] fit of the HKY85 + GTR mixture (library entry "
          f"points): wall {wall:.2f} s, {res['rounds']} rounds, lnL "
          f"{lnl0:.5f} -> {lnl:.5f}, classes (rate, weight) "
          f"{res['classes']}; launches {counts}, K3 by batch size {k3_by_b}")
    if not (math.isfinite(lnl) and lnl >= lnl0):
        fail("[nt mixture] the fit's lnL is not finite or below its start")
    for name, count in counts.items():
        if (name in ("K1", "K2", "K3")) != (count > 0):
            fail(f"[nt mixture] {name} launched {count} times")
    if k3_by_b.get(1, 0):
        fail("[nt mixture] K3 ran single-system passes")
    return counts, k3_by_b, res


def write_columns(path, names, seqs, lo, hi):
    with open(path, "w") as fh:
        fh.write(f" {len(names)} {hi - lo}\n")
        for nm, sq in zip(names, seqs):
            fh.write(f"{nm:<10s}  {sq[lo:hi]}\n")


def read_phylip_rows(aln_path):
    with open(aln_path) as fh:
        rows = [ln.split() for ln in fh.read().splitlines()[1:] if ln.strip()]
    return [r[0] for r in rows], [r[1] for r in rows]


def partition_xml(path, files, search):
    """A two-<partitionelem> XML: GTR+G4 on the first file, HKY85+G4 on
    the second, BioNJ start, `search`; outputs joint_part{1,2}_*."""
    rates = ",".join(f"R{i}" for i in range(1, 5))
    elems = "".join(
        f'''
  <partitionelem file.name="{f}" data.type="nt" interleaved="no">
    <mixtureelem list="T1,T1,T1,T1"/>
    <mixtureelem list="{m},{m},{m},{m}"/>
    <mixtureelem list="F1,F1,F1,F1"/>
    <mixtureelem list="{rates}"/>
    <mixtureelem list="{b},{b},{b},{b}"/>
  </partitionelem>'''
        for f, m, b in zip(files, ("M1", "M2"), ("L1", "L2")))
    sr = "".join(f'<instance id="R{i}" init.value="1.0"/>'
                 for i in range(1, 5))
    with open(path, "w") as fh:
        fh.write(f'''<phyml run.id="x" output.file="joint">
  <topology><instance id="T1" init.tree="bionj" search="{search}"
            optimise.tree="yes"/></topology>
  <ratematrices><instance id="M1" model="GTR"/>
                <instance id="M2" model="HKY85"/></ratematrices>
  <siterates>{sr}<weights family="gamma" alpha="1.0"/></siterates>
  <equfreqs><instance id="F1" freqs="empirical"/></equfreqs>
  <branchlengths><instance id="L1" optimise.lens="yes"/>
                 <instance id="L2" optimise.lens="yes"/></branchlengths>{elems}
</phyml>
''')


def write_paml(path, S, pi):
    """A PAML rate file: 19 lower-triangular rows, then 20 freqs."""
    with open(path, "w") as fh:
        for i in range(1, 20):
            fh.write(" ".join(f"{S[i, j]:.10f}" for j in range(i)) + "\n")
        fh.write("\n" + " ".join(f"{p:.10f}" for p in pi) + "\n")


def mixture_xml(dirname, aln_name):
    """A one-<partitionelem> XML of four amino-acid matrices read from
    PAML files written from LG4X's tables, FreeRate rates and weights,
    BioNJ start and the NNI search; outputs mix_*."""
    from phyml_tpu_torch.models.matrices import empirical_aa

    for i in range(1, 5):
        write_paml(os.path.join(dirname, f"X{i}.mat"),
                   *empirical_aa(f"lg4x_{i}"))
    mats = "".join(f'<instance id="M{i}" model="customaa" '
                   f'ratematrix.file="X{i}.mat"/>' for i in range(1, 5))
    rates = "".join(f'<instance id="R{i}" init.value="{v}"/>' for i, v in
                    zip(range(1, 5), (0.197063, 0.750275, 1.951569, 0.42)))
    wts = "".join(f'<instance appliesto="R{i}" value="{v}"/>' for i, v in
                  zip(range(1, 5), (0.287, 0.339, 0.195, 0.179)))
    path = os.path.join(dirname, "mix.xml")
    with open(path, "w") as fh:
        fh.write(f'''<phyml run.id="mx" output.file="mix">
  <topology><instance id="T1" init.tree="bionj" search="nni"
            optimise.tree="yes"/></topology>
  <ratematrices>{mats}</ratematrices>
  <equfreqs><instance id="F1" freqs="model"/></equfreqs>
  <siterates>{rates}
    <weights family="freerates" optimise.freerates="yes">{wts}</weights>
  </siterates>
  <branchlengths><instance id="L1" optimise.lens="yes"/></branchlengths>
  <partitionelem file.name="{aln_name}" data.type="aa" interleaved="no">
    <mixtureelem list="T1,T1,T1,T1"/>
    <mixtureelem list="M1,M2,M3,M4"/>
    <mixtureelem list="F1,F1,F1,F1"/>
    <mixtureelem list="R1,R2,R3,R4"/>
    <mixtureelem list="L1,L1,L1,L1"/>
  </partitionelem>
</phyml>
''')
    return path


def combined_lnl(stats_path):
    with open(stats_path) as fh:
        for line in fh:
            if line.startswith(". Combined log-likelihood"):
                return float(line.split(":")[1])
    fail(f"no combined log-likelihood in {stats_path}")


# the partitioned search's functions the XML phase counts and times
PARTITION_PROBES = [
    ("phyml_tpu_torch.search.partitioned", "nni_round_partitioned",
     "NNI rounds"),
    ("phyml_tpu_torch.search.partitioned", "spr_round_partitioned",
     "SPR sweeps"),
    ("phyml_tpu_torch.search.partitioned", "nni_scores", "NNI scorer"),
    ("phyml_tpu_torch.search.partitioned", "optimize_scalars",
     "parameters"),
]


def partitioned_phase(aln_path, tree_path, cuda):
    """The two-partition XML run at full width: the DNA problem split at
    site N_SITES // 2 into two files, GTR+G4 and HKY85+G4, BioNJ start,
    search="nni", through `phyml_tpu_torch.cli --xml`, with every launch
    counter set to 0 just before and read just after.  Returns (counts,
    K3 by batch size, numbers)."""
    import torch
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.topology import Topology

    d = os.path.join(os.path.dirname(os.path.dirname(aln_path)), "xml")
    os.makedirs(d, exist_ok=True)
    names, seqs = read_phylip_rows(aln_path)
    half = N_SITES // 2
    for k, (lo, hi) in enumerate(((0, half), (half, N_SITES))):
        write_columns(os.path.join(d, f"gene{k + 1}.phy"), names, seqs, lo,
                      hi)
    xml = os.path.join(d, "run.xml")
    partition_xml(xml, ["gene1.phy", "gene2.phy"], "nni")
    reset_counts()
    out = io.StringIO()
    with search_probes(PARTITION_PROBES) as st, \
            utilization_sampler() as util:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.time()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--xml", xml, "--platform", "gpu"])
        torch.cuda.synchronize()
        wall = time.time() - t
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    busy = statistics.mean(util) if util else None
    counts = launch_counts()
    k3_by_b = launches_by("K3", "batch")
    if rc != 0:
        fail(f"the partitioned XML run returned {rc}")
    with open(os.path.join(d, "xml_run.log"), "w") as fh:
        fh.write(out.getvalue())
    lnl = combined_lnl(os.path.join(d, "joint_part1_phyml_stats.txt"))
    trees = []
    for k in (1, 2):
        with open(os.path.join(d, f"joint_part{k}_phyml_tree.txt")) as fh:
            trees.append(Topology.from_newick(fh.read(), names))
    with open(tree_path) as fh:
        truth = Topology.from_newick(fh.read(), names)
    res = dict(wall_s=wall, combined_lnl=lnl,
               nni_rounds=st["NNI rounds"]["calls"],
               nni_rounds_s=st["NNI rounds"]["s"],
               nni_scorer_calls=st["NNI scorer"]["calls"],
               nni_scorer_s=st["NNI scorer"]["s"],
               parameter_searches=st["parameters"]["calls"],
               parameters_s=st["parameters"]["s"],
               rf_true=trees[0].rf_distance(truth), peak_gib=peak,
               idle_share=None if busy is None else 1 - busy,
               launches=counts, k3_by_batch=k3_by_b)
    print(f". [nt xml] two partitions ({N_SITES} sites split at {half}, "
          f"GTR+G4 | HKY85+G4, BioNJ + NNI): wall {wall:.2f} s, combined "
          f"lnL {lnl:.5f}, {res['nni_rounds']} NNI rounds "
          f"({res['nni_rounds_s']:.2f} s; NNI scorer "
          f"{res['nni_scorer_calls']} calls {res['nni_scorer_s']:.2f} s), "
          f"{res['parameter_searches']} parameter searches "
          f"({res['parameters_s']:.2f} s); RF to the simulating tree "
          f"{res['rf_true']}; peak {peak:.2f} GiB; idle share "
          + ("not measured" if busy is None else f"{1 - busy:.3f}")
          + f"; launches {counts}, K3 by batch size {k3_by_b}")
    if not math.isfinite(lnl):
        fail("the partitioned run's combined lnL is not finite")
    if trees[0].rf_distance(trees[1]) != 0 or trees[0].n_otu != N_TAXA:
        fail("the partitions' trees differ or do not parse")
    if k3_by_b.get(1, 0):
        fail("the partitioned run: K3 ran single-system passes")
    for name, count in counts.items():
        if (name in ("K1", "K2", "K3")) != (count > 0):
            fail(f"the partitioned run: {name} launched {count} times")
    return counts, k3_by_b, res


def stats_lnls(aln_path):
    """Every data set's final lnL in a stats file (-n appends)."""
    with open(f"{aln_path}_phyml_stats.txt") as fh:
        return [float(ln.split(":")[1]) for ln in fh
                if ln.startswith(". Log-likelihood:")]


def tree_lines(path, names):
    from phyml_tpu_torch.topology import Topology

    with open(path) as fh:
        return [Topology.from_newick(ln, names) for ln in fh if ln.strip()]


def slice_runs():
    """{check: run(d, platform)}: the slice's entry points on 16 x 500
    problems, each run returning (final lnL of every data set, trees)."""
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.io.xmlcfg import run_xml
    from phyml_tpu_torch.models.matrices import empirical_aa

    names = [f"T{i:04d}" for i in range(16)]

    def by_cli(extra, dt="nt", default=False, n_sets=1):
        def run(d, platform):
            aln, tree = write_problem(d, dt, 16, 500, SEED + 1)
            if n_sets == 2:
                aln2, _ = write_problem(os.path.join(d, "b"), dt, 16, 500,
                                        SEED + 2)
                with open(aln, "a") as fh, open(aln2) as f2:
                    fh.write("\n" + f2.read())
            argv = (default_argv(dt, aln, platform) if default
                    else cli_argv(dt, aln, tree, platform))
            argv += [a.replace("DIR", d) for a in extra] + ["--quiet"]
            if cli.main(argv) != 0:
                fail(f"small {extra} run on {platform} failed")
            return (stats_lnls(aln),
                    tree_lines(f"{aln}_phyml_tree.txt", names))
        return run

    def by_xml(kind):
        def run(d, platform):
            os.makedirs(d, exist_ok=True)
            if kind == "mixture":
                aln, _ = write_problem(d, "aa", 16, 500, SEED + 1)
                xml = mixture_xml(d, os.path.basename(aln))
                outs = ["mix"]
            else:
                aln, _ = write_problem(d, "nt", 16, 500, SEED + 1)
                nm, seqs = read_phylip_rows(aln)
                for k, (lo, hi) in enumerate(((0, 250), (250, 500))):
                    write_columns(os.path.join(d, f"gene{k + 1}.phy"), nm,
                                  seqs, lo, hi)
                xml = os.path.join(d, "run.xml")
                partition_xml(xml, ["gene1.phy", "gene2.phy"], "spr")
                outs = ["joint_part1", "joint_part2"]
            device = "cpu" if platform == "cpu" else "cuda"
            if run_xml(xml, quiet=True, device=device) != 0:
                fail(f"small {kind} XML run on {platform} failed")
            if kind == "mixture":
                lnls = stats_lnls(os.path.join(d, "mix"))
            else:
                lnls = [combined_lnl(os.path.join(
                    d, f"{outs[0]}_phyml_stats.txt"))]
            trees = [t for o in outs for t in tree_lines(
                os.path.join(d, f"{o}_phyml_tree.txt"), names)]
            return lnls, trees
        return run

    def checkpoint(d, platform):
        """Two runs on one checkpoint: the first stands for a run
        interrupted once the search's checkpoint was written, the second
        resumes from it; returns the second's numbers and checks it ends
        where the first did."""
        aln, _ = write_problem(d, "nt", 16, 500, SEED + 1)
        argv = default_argv("nt", aln, platform) + [
            "--checkpoint", os.path.join(d, "ck.npz")]
        first = None
        for run in range(2):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                if cli.main(argv) != 0:
                    fail(f"checkpoint run {run} on {platform} failed")
            got = (stats_lnls(aln), tree_lines(f"{aln}_phyml_tree.txt",
                                               names))
            if run == 0:
                first = got
        if "Resumed from checkpoint (search_done)" not in out.getvalue():
            fail(f"the second run on {platform} did not resume")
        if got[1][0].rf_distance(first[1][0]) or \
                abs(got[0][0] - first[0][0]) > E2E_TOL:
            fail(f"the resumed run on {platform} ended elsewhere: {got[0]} "
                 f"against {first[0]}")
        return got

    def aa_rate_file(d, platform):
        os.makedirs(d, exist_ok=True)
        write_paml(os.path.join(d, "lg4x_1.dat"), *empirical_aa("lg4x_1"))
        return by_cli(["--aa_rate_file", "DIR/lg4x_1.dat"], "aa")(d,
                                                                  platform)

    return {
        "lg4x_fit": by_cli(["-m", "LG4X"], "aa"),
        "xml_mixture": by_xml("mixture"),
        "xml_two_partitions_spr": by_xml("partitions"),
        "il_fit": by_cli(["--il"]),
        "aa_rate_file_fit": aa_rate_file,
        "n2_default_run": by_cli(["-n", "2"], default=True, n_sets=2),
        "checkpoint_resume": checkpoint,
    }


def slice_side(label, d, platform):
    return slice_runs()[label](d, platform)


def report_slice(label, gpu, cpu):
    """One slice check, card float32 against CPU float64: final lnL
    within E2E_TOL of each data set and the same trees where a search
    runs.  Returns its numbers."""
    ((lg, tg), g_s), ((lc, tc), c_s) = gpu, cpu
    gaps = [g - c for g, c in zip(lg, lc)]
    rf = [a.rf_distance(b) for a, b in zip(tg, tc)]
    print(f". [small] {label}: gpu f32 {lg} ({g_s:.1f} s)  cpu f64 {lc} "
          f"({c_s:.1f} s)  diff " + ", ".join(f"{g:.2e}" for g in gaps)
          + f" (tol {E2E_TOL})  RF {rf}")
    if len(lg) != len(lc) or len(tg) != len(tc) or not lg or \
            any(not abs(g) <= E2E_TOL for g in gaps) or any(rf):
        fail(f"small {label} disagrees between the card and the CPU")
    return dict(lnl_gpu=lg, lnl_cpu=lc, gaps=gaps, rf=rf, gpu_s=g_s,
                cpu_s=c_s)


def run_side(side, args, d, platform):
    """(side(*args, d, platform), seconds), its standard output
    swallowed: one side of a small card-against-CPU check."""
    t = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        got = side(*args, d, platform)
    return got, time.time() - t


def one_torch_thread():
    import torch

    torch.set_num_threads(1)


def small_checks(tmp):
    """Every 16 x 500 card-against-CPU check, after the full-width
    paths: the CPU float64 side of each in a worker process (spawned,
    one torch thread each, the longest first), the card's side in this
    process meanwhile; then each comparison.  Returns (the supports
    check's aBayes gap, {slice check: numbers}, the dating check's
    numbers, {state-count check: numbers}, the tools' check's
    numbers, the PhyREX check's numbers)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    slice_labels = list(slice_runs())
    states_labels = list(states_runs())
    checks = [(f"small_default_{dt}", default_side, (dt,), report_default)
              for dt in ("aa", "nt")]
    checks += [(label, states_side, (label,), report_slice)
               for label in states_labels]
    checks.append(("small_cov_chain", cov_chain_side, (), report_cov_chain))
    checks.append(("small_support", support_side, (), report_support))
    checks.append(("small_phytime", phytime_side, (), report_phytime))
    checks.append(("small_aux", aux_side, (), report_aux))
    checks.append(("small_phyrex", phyrex_side, (), report_phyrex))
    checks += [(label, slice_side, (label,), report_slice)
               for label in slice_labels]
    checks += [(f"small_{dt}", fit_side, (dt,), report_fit)
               for dt in ("nt", "aa")]
    workers = max(1, min(6, len(os.sched_getaffinity(0)) - 2))
    pool = ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=one_torch_thread)
    try:
        cpu = [pool.submit(run_side, side, args, os.path.join(
            tmp, f"{label}_cpu"), "cpu") for label, side, args, _ in checks]
        gpu = [run_side(side, args, os.path.join(tmp, f"{label}_gpu"), "gpu")
               for label, side, args, _ in checks]
        out = {}
        for (label, _, args, report), g, c in zip(checks, gpu, cpu):
            out[label] = report(*args, g, c.result())
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    states = {k: out[k] for k in states_labels + ["small_cov_chain"]}
    return out["small_support"], {k: out[k] for k in slice_labels}, \
        out["small_phytime"], states, out["small_aux"], out["small_phyrex"]


def mixture_rows(aln_path, tree_path, cuda, regs):
    """The DNA mixture's cell: its fit on the DNA problem (mixture_fit),
    then K1, K2 and K3 (at the batch sizes the fit launched, on the line
    search's first zoom level) against their plain versions at the
    mixture's system; each row's launches are the fit's."""
    counts, k3_by_b, res = mixture_fit(aln_path, tree_path, cuda)
    rows = kernel_phases("nt", aln_path, tree_path, cuda, regs,
                               model=dna_mixture(),
                               params=mixture_params(dna_mixture()),
                               cell="HKY85+GTR mixture",
                               k3_batches=sorted(k3_by_b))
    for r in rows:
        kname = r.pop("kernel")
        r["launches"] = counts[kname]
        r["launches_from"] = "the mixture's fixed-topology fit"
        if "B" in r:
            r["launches_at_B"] = k3_by_b.get(r["B"], 0)
    return rows


def lg4x_phase(aln_path, tree_path, run_aln, run_tree, cuda, regs, out):
    """LG4X at full width on the protein problem (its own directory):
    the fixed-topology fit (`-u tree -o lr -m LG4X`) and, on the protein
    default run's problem (run_aln, DEFAULT_RUN_TAXA: a depth cut), the
    default run (BioNJ, then the NNI search), each with every launch counter set to
    0 just before and read just after (K4, K5 and K3 launch, nothing off
    the route); then K4, K5 and K3 (at every batch size the two runs
    launched, on the line search's first zoom level: its extreme grid
    points) against their plain versions at the LG4X system.  Puts the
    runs' numbers into out["lg4x_fit"] and out["lg4x_default_run"];
    returns the kernel rows, launches from the default run."""
    import torch
    from phyml_tpu_torch.models.substitution import lg4x_model

    root = os.path.dirname(os.path.dirname(aln_path))
    lg_aln, lg_tree = copy_problem(aln_path, tree_path,
                                   os.path.join(root, "lg4x"))
    extra = ("-m", "LG4X")
    fit_counts, fit_k3, out["lg4x_fit"] = main_path(
        "aa", lg_aln, lg_tree, cuda, extra=extra, runs=1, tag="aa LG4X")
    run_aln, run_tree = copy_problem(run_aln, run_tree,
                                     os.path.join(root, "lg4x_run"))
    batch_k = scorer_block("aa", run_aln, extra, cuda)
    counts, res = default_run("aa", run_aln, run_tree, cuda, batch_k,
                              extra=extra, tag="aa LG4X")
    out["lg4x_default_run"] = res
    # the kernels at the system the fit found
    model = lg4x_model()
    found = torch.as_tensor(out["lg4x_fit"]["classes"], dtype=torch.float64)
    params = {"class_rates_raw": found[:, 0].log(),
              "class_weights_raw": found[:, 1].log()}
    batches = sorted(set(fit_k3) | set(res["k3_by_batch"]))
    rows = kernel_phases("aa", aln_path, tree_path, cuda, regs, model=model,
                         params=params, cell="LG4X", k3_batches=batches)
    for r in rows:
        kname = r.pop("kernel")
        r["launches"] = counts[kname]
        r["launches_fixed_fit"] = fit_counts[kname]
        if "B" in r:
            r["launches_at_B"] = res["k3_by_batch"].get(r["B"], 0)
            r["launches_at_B_fixed_fit"] = fit_k3.get(r["B"], 0)
    return rows


# ----------------------------------------------------------------------
# state counts other than 4 and 20: covarion (M4) and custom alphabets,
# on the kernels' ladder (ops/_build.py)
# ----------------------------------------------------------------------
# cell: (datatype, CLI flags, taxa of its kernel rows and fixed fit, taxa
# of its default run or None); 4096 sites each.  The default runs at 64
# taxa are a depth cut, as the protein default run's
STATES_CELLS = {
    "DNA covarion": ("nt", ("--cov", "--cov_ncats", "3"), N_TAXA, 64),
    "protein covarion": ("aa", ("--cov", "--cov_ncats", "3"), 64, None),
    "binary generic": ("generic", (), N_TAXA, 64),
    # past the ladder (its top rung is 32), as "protein covarion" (60
    # states, padded to 64): 80 states, the big bodies
    "protein covarion 4": ("aa", ("--cov", "--cov_ncats", "4"), 64, None),
}
# the K3 batch sizes of a cell's rows where not (1, 2, 13 per free
# scalar): the line search's grid of its one free scalar (alpha) and the
# pair probe
STATES_K3_BATCHES = {"protein covarion 4": (1, 2, 13)}
# cells whose kernels only are held against their plain versions, no
# run: 160 states (`--cov_ncats 8`) at 32 taxa, a depth cut; cell: (datatype, CLI
# flags, taxa, the cell whose runs launch the same bodies)
STATES_KERNEL_CELLS = {
    "protein covarion 8": ("aa", ("--cov", "--cov_ncats", "8"), 32,
                           "protein covarion 4"),
}


def states_phase(tmp, cuda, regs):
    """The state-count cells (STATES_CELLS): DNA covarion GTR+G4 `--cov
    --cov_ncats 3` (12 states), protein covarion LG+G4 (60 states, the
    big bodies at 64), binary `-d generic` (2 states, padded to 4) and,
    past the ladder, protein covarion `--cov_ncats 4` (80 states, the big
    bodies), each on a problem of its own simulated from the script's
    seed: every kernel of its route (and the one beside it) and K3 at the
    line search's batch against their plain versions, the fixed-topology
    fit (`-u tree -o lr`) and, where the cell has one, the default run,
    each with every launch counter set to 0 just before and read just
    after (the 80-state fit must launch K3 at B = 13 and 2); then the
    kernels alone at 160 states (STATES_KERNEL_CELLS).  Returns (kernel
    rows, launches from the cell's default run or else its fit; the
    runs' numbers)."""
    import torch

    rows, out, counts_of = [], {}, {}
    for cell, (dt, extra, fit_n, run_n) in STATES_CELLS.items():
        tag = f"{dt} {cell}"
        d = os.path.join(tmp, "states_" + cell.replace(" ", "_"))
        aln, tree = write_problem(d, dt, fit_n, N_SITES, SEED)
        t_cell = time.time()
        cell_rows = kernel_phases(dt, aln, tree, cuda, regs, cell=cell,
                                  extra=extra,
                                  k3_batches=STATES_K3_BATCHES.get(cell))
        torch.cuda.empty_cache()
        fit_counts, fit_k3, out[f"{cell} fit"] = main_path(
            dt, aln, tree, cuda, extra=extra, runs=1, tag=tag)
        torch.cuda.empty_cache()
        if cell in STATES_K3_BATCHES:
            missing = [B for B in (2, 13) if not fit_k3.get(B)]
            if missing:
                fail(f"[{tag}] the fit launched K3 at no B = {missing} "
                     f"(by batch size: {fit_k3})")
        counts, k3_by_b, src = fit_counts, fit_k3, "the fixed-topology fit"
        if run_n:
            run_aln, run_tree = write_problem(f"{d}_{run_n}", dt, run_n,
                                              N_SITES, SEED)
            batch_k = distance_check(dt, run_aln, cuda, extra)
            counts, res = default_run(dt, run_aln, run_tree, cuda, batch_k,
                                      extra=extra, tag=tag)
            out[f"{cell} default run"] = res
            k3_by_b, src = res["k3_by_batch"], "the default run"
            torch.cuda.empty_cache()
        for r in cell_rows:
            kname = r.pop("kernel")
            r["launches"] = counts[kname]
            r["launches_from"] = src
            r["launches_fixed_fit"] = fit_counts[kname]
            if "B" in r:
                r["launches_at_B"] = k3_by_b.get(r["B"], 0)
                r["launches_at_B_fixed_fit"] = fit_k3.get(r["B"], 0)
        rows += cell_rows
        counts_of[cell] = (counts, k3_by_b, src)
        out[f"{cell} wall_s"] = time.time() - t_cell
    for cell, (dt, extra, n_taxa, runs_of) in STATES_KERNEL_CELLS.items():
        d = os.path.join(tmp, "states_" + cell.replace(" ", "_"))
        aln, tree = write_problem(d, dt, n_taxa, N_SITES, SEED)
        t_cell = time.time()
        cell_rows = kernel_phases(dt, aln, tree, cuda, regs, cell=cell,
                                  extra=extra, k3_batches=(2, 13))
        torch.cuda.empty_cache()
        counts, k3_by_b, src = counts_of[runs_of]
        for r in cell_rows:
            kname = r.pop("kernel")
            r["launches"] = counts[kname]
            r["launches_from"] = (f"{src} of the {runs_of} cell, the same "
                                  "big body (no run at this cell)")
            if "B" in r:
                r["launches_at_B"] = k3_by_b.get(r["B"], 0)
        rows += cell_rows
        out[f"{cell} wall_s"] = time.time() - t_cell
    return rows, out


def states_runs():
    """{check: run(d, platform)}: the state-count paths on 16 x 500
    problems, each run returning (final lnL, trees): covarion fits in
    the 'alpha' and 'free' modes, amino-acid covarion at two hidden
    classes (40 states), custom alphabets of 7 states (the default
    run) and 36 (the fit); past the ladder, amino-acid covarion at four
    hidden classes (80 states: the fit, and the default run on 8 x 500)
    and the 36-state alphabet at three (108 states, the fit)."""
    from phyml_tpu_torch import cli

    def by_cli(dt, extra, default=False, generic_ns=2, size=(16, 500)):
        def run(d, platform):
            aln, tree = write_problem(d, dt, *size, SEED + 1,
                                      generic_ns=generic_ns)
            argv = (default_argv(dt, aln, platform) if default
                    else cli_argv(dt, aln, tree, platform))
            if cli.main(argv + list(extra) + ["--quiet"]) != 0:
                fail(f"small {dt} {extra} run on {platform} failed")
            names = [f"T{i:04d}" for i in range(size[0])]
            return (stats_lnls(aln),
                    tree_lines(f"{aln}_phyml_tree.txt", names))
        return run

    return {
        # past the kernels' ladder (the big bodies): 80 and 108 states;
        # the 80-state default run at 8 taxa, a depth cut: its CPU
        # float64 side on one thread ran past 10 minutes at 16 x 500 and
        # took 196 s at 8 x 500, so it comes first, among the workers
        # that start at once
        "aa_cov_4_hidden_default_run_8_taxa": by_cli(
            "aa", ["--cov", "--cov_ncats", "4"], default=True, size=(8, 500)),
        "aa_cov_4_hidden_fit": by_cli("aa", ["--cov", "--cov_ncats", "4"]),
        "generic_36_cov_3_fit": by_cli(
            "generic", ["--cov", "--cov_ncats", "3"], generic_ns=36),
        "cov_alpha_fit": by_cli("nt", ["--cov_alpha", "e", "--cov_ncats",
                                       "2"]),
        "cov_free_fit": by_cli("nt", ["--cov_free"]),
        "aa_cov_2_hidden_fit": by_cli("aa", ["--cov", "--cov_ncats", "2"]),
        "generic_7_default_run": by_cli("generic", [], default=True,
                                        generic_ns=7),
        "generic_36_fit": by_cli("generic", [], generic_ns=36),
    }


def states_side(label, d, platform):
    return states_runs()[label](d, platform)


def cov_chain(d, platform, dtype=None):
    """(files' names, engine, MCMC) of the covarion dating check: the
    16 x 500 DNA problem under GTR+G4 with two hidden classes, its
    simulating tree as the chronogram's shape, a strict clock and the
    birth-death prior; cov_delta is a chain parameter (the cov_switch
    move)."""
    import torch
    from phyml_tpu_torch.bayes.chrono import TimeTree
    from phyml_tpu_torch.bayes.mcmc import MCMC, MCMCSettings
    from phyml_tpu_torch.bayes.rates import RateModel
    from phyml_tpu_torch.bayes.times import TimePrior
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.models.substitution import SubstModel
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine
    from phyml_tpu_torch.topology import Topology

    device = torch.device("cuda" if platform == "gpu" else "cpu")
    dtype = dtype or (torch.float32 if platform == "gpu" else torch.float64)
    aln_path, tree_path = write_problem(d, "nt", 16, 500, SEED + 1)
    aln = read_alignment(aln_path, datatype="nt")
    names = list(aln.names)
    model = SubstModel(datatype="nt", name="GTR", n_classes=4,
                       covarion=True, n_hidden=2)
    params = model.init_params(aln.obs_state_freqs)
    eng = LikelihoodEngine(aln, model, dtype=dtype, device=device)
    with open(tree_path) as fh:
        tt = TimeTree.from_topology(Topology.from_newick(fh.read(), names),
                                    names=names)
    return MCMC(eng, model, params, tt, RateModel(kind="strict"),
                TimePrior(kind="birthdeath"),
                MCMCSettings(n_iter=1000, burnin=500, batch=250, seed=5))


def cov_chain_side(d, platform):
    """The covarion dating check's side: the chain's start state (both
    platforms) and, on the card, its state after 1,000 iterations and
    the cov_switch move's acceptance."""
    from phyml_tpu_torch.bayes.mcmc import MCMC

    def host(st):
        return {k: ({k2: v2.numpy() for k2, v2 in v.items()}
                    if isinstance(v, dict) else v.numpy())
                for k, v in st._asdict().items()}

    mc = cov_chain(d, platform)
    st0 = mc.init_state()
    out = dict(start=host(st0))
    if platform == "gpu":
        final, _, acc = mc.run(state=st0)
        out.update(final=host(final),
                   switch_accept=float(acc[MCMC.MOVE_NAMES.index(
                       "cov_switch")]))
    return out


def report_cov_chain(gpu, cpu):
    """The covarion dating check: the start state's lnL on the card
    (float32) and on the CPU (float64) within F64_TOL; the card chain's
    final state recomputed by a CPU float64 chain within F64_TOL; the
    chain sampled cov_delta (its move accepted, the value moved)."""
    import torch
    from phyml_tpu_torch.interop import chain_state_from_numpy

    (g, g_s), (c, c_s) = gpu, cpu
    mc = cov_chain(os.path.join(tempfile.mkdtemp(), "cov_chain"), "cpu",
                   torch.float64)
    start_gap = float(g["start"]["lnL"]) - float(c["start"]["lnL"])
    final = chain_state_from_numpy(g["final"])
    final_gap = float(final.lnL) - float(mc._lnL(final))
    d0 = float(g["start"]["subst"]["cov_delta"])
    d1 = float(g["final"]["subst"]["cov_delta"])
    print(f". [small] covarion dating chain (16 x 500, GTR+G4, 2 hidden "
          f"classes, 1,000 iterations on the card): start lnL gpu f32 - "
          f"cpu f64 {start_gap:.2e}, final lnL - CPU f64 recompute "
          f"{final_gap:.2e} (tol {F64_TOL}); cov_delta {d0:.4f} -> "
          f"{d1:.4f}, cov_switch accepted {g['switch_accept']:.3f} "
          f"({g_s:.1f} s card, {c_s:.1f} s CPU)")
    if not (abs(start_gap) <= F64_TOL and abs(final_gap) <= F64_TOL):
        fail("small covarion chain: the card's lnL is off the CPU's")
    if not (g["switch_accept"] > 0 and d1 != d0):
        fail("small covarion chain: cov_delta was not sampled")
    return dict(start_gap=start_gap, final_gap=final_gap, delta=(d0, d1),
                switch_accept=g["switch_accept"], gpu_s=g_s, cpu_s=c_s)


# ----------------------------------------------------------------------
# phytime: the Bayesian dating chain through `--xml` with a <phytime> root
# ----------------------------------------------------------------------
# iterations of each run (mcmc_iter_cap; batches of 250 between the
# topology sweeps, MCMCSettings.batch)
PHYTIME_RUNS = {"lognormal": ("nt", 5000, "lognormal", True),
                "guindon": ("nt", 5000, None, False),
                "protein": ("aa", 2000, "lognormal", True)}
# cached lnL against a recompute on the card: both are one K1/K4 pass on
# the same P-matrices (the recompute is asserted bit-identical to a
# second one); a gap can only come from a branch length whose float32
# rounding the lnL-invariant moves flip in its last bit
CACHE_TOL = 1e-3
# start chronogram of the 16 x 500 problem, card float32 branch-length
# fit against CPU float64 (heights in substitutions per site)
HEIGHT_TOL = 1e-3
PRIOR_REL = 1e-9  # log prior at one state, card side against CPU: both
#                   float64 host arithmetic


def tip_sets(tt):
    """Tip set below every node of a TimeTree."""
    below = [frozenset([u]) for u in range(tt.n_otu)]
    for i in range(tt.n_otu - 1):
        c0, c1 = (int(x) for x in tt.child[i])
        below.append(below[c0] | below[c1])
    return below


def phytime_calibrations(tree_path, names):
    """A root calibration and one clade calibration (the internal node
    with 8 to 32 tips closest to 16) around the heights the user tree's
    own branch lengths give (TimeTree.from_topology, as the XML run
    builds its start): [0.5 h, 2 h] each.  Returns [(taxa, lo, hi)]."""
    from phyml_tpu_torch.bayes.chrono import TimeTree
    from phyml_tpu_torch.topology import Topology

    with open(tree_path) as fh:
        tt = TimeTree.from_topology(Topology.from_newick(fh.read(), names),
                                    names=names)
    below = tip_sets(tt)
    cands = [u for u in range(tt.n_otu, tt.root) if 8 <= len(below[u]) <= 32]
    u = min(cands or [tt.root - 1], key=lambda v: abs(len(below[v]) - 16))
    out = []
    for node in (tt.root, u):
        h = float(tt.heights[node])
        out.append(([names[t] for t in sorted(below[node])], 0.5 * h,
                     2.0 * h))
    return out


def phytime_xml(path, aln_name, tree_path, dt, cals, lineagerates,
                sample_topology, seed=1):
    """A <phytime> analysis: GTR+G4 (DNA) or LG+G4 (amino acids) on
    aln_name, the user tree (optimise.tree: topology moves), the
    birth-death prior, `cals`, outputs out_phytime_*."""
    lr = (f'  <lineagerates model="{lineagerates}"/>\n'
          if lineagerates else "")
    model = "GTR" if dt == "nt" else "LG"
    clades = "".join(
        f'  <clade id="c{k}">'
        + "".join(f'<taxon value="{t}"/>' for t in taxa) + "</clade>\n"
        f'  <calibration clade.id="c{k}"><lower>{lo!r}</lower>'
        f'<upper>{hi!r}</upper></calibration>\n'
        for k, (taxa, lo, hi) in enumerate(cals))
    rates = "".join(f'<instance id="R{i}" init.value="1.0"/>'
                    for i in range(1, 5))
    with open(path, "w") as fh:
        fh.write(f'''<phytime run.id="phytime" output.file="out" r.seed="{seed}"
  mcmc.chain.len="1e6" mcmc.sample.every="50" mcmc.burnin="1000">
{lr}  <topology><instance id="T1" init.tree="user" file.name="{tree_path}"
    optimise.tree="{'yes' if sample_topology else 'no'}"/></topology>
  <ratematrices><instance id="M1" model="{model}"/></ratematrices>
  <siterates>{rates}<weights family="gamma" alpha="1.0"/></siterates>
  <branchlengths><instance id="L1"/></branchlengths>
  <partitionelem file.name="{aln_name}" data.type="{dt}" interleaved="no">
    <mixtureelem list="T1,T1,T1,T1"/>
    <mixtureelem list="M1,M1,M1,M1"/>
    <mixtureelem list="R1,R2,R3,R4"/>
    <mixtureelem list="L1,L1,L1,L1"/>
  </partitionelem>
{clades}</phytime>
''')


@contextlib.contextmanager
def chain_probes():
    """Counts and times the chain's lnL evaluations (each ends in the
    host sync that reads the lnL back), its topology proposals (each
    holds one lnL evaluation), the slot schedules built and the chain
    as a whole, and keeps each run_phytime's result and start state;
    restores the functions on the way out."""
    from phyml_tpu_torch.bayes import date
    from phyml_tpu_torch.bayes.mcmc import MCMC
    from phyml_tpu_torch.ops import likelihood

    rec = {"lnL": [0, 0.0], "topology": [0, 0.0], "run": [0, 0.0],
           "schedules": [0, 0.0], "results": [], "starts": []}
    inside = []       # the topology step running, if any

    def timed_fn(fn, key):
        def run(*a, **k):
            # an lnL evaluation inside a topology step counts as the
            # step's
            k_ = "topology lnL" if key == "lnL" and any(inside) else key
            inside.append(key == "topology")
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                inside.pop()
                got = rec.setdefault(k_, [0, 0.0])
                got[0] += 1
                got[1] += time.perf_counter() - t
        return run

    saved = [(MCMC, "_lnL", MCMC._lnL),
             (MCMC, "topology_step", MCMC.topology_step),
             (MCMC, "run", MCMC.run), (MCMC, "init_state", MCMC.init_state),
             (date, "run_phytime", date.run_phytime),
             (likelihood, "build_slot_schedule",
              likelihood.build_slot_schedule)]
    init_state, run_phytime = MCMC.init_state, date.run_phytime
    MCMC._lnL = timed_fn(MCMC._lnL, "lnL")
    MCMC.topology_step = timed_fn(MCMC.topology_step, "topology")
    MCMC.run = timed_fn(MCMC.run, "run")
    likelihood.build_slot_schedule = timed_fn(likelihood.build_slot_schedule,
                                              "schedules")
    MCMC.init_state = lambda self, *a: rec["starts"].append(
        init_state(self, *a)) or rec["starts"][-1]
    date.run_phytime = lambda *a, **k: rec["results"].append(
        run_phytime(*a, **k)) or rec["results"][-1]
    try:
        yield rec
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def chain_state_checks(tag, res, cals):
    """Heights feasible, every calibrated clade's MRCA in the final
    tree inside its bounds, the chronogram and trace written."""
    from phyml_tpu_torch.bayes.chrono import TimeTree

    st = res.state
    h, par = st.heights.numpy(), st.parent.numpy()
    dt_min = float((h[par] - h)[:-1].min())
    if not dt_min >= -1e-12:
        fail(f"[{tag}] the final heights are infeasible: an edge of "
             f"duration {dt_min}")
    tt = TimeTree(n_otu=res.tree.n_otu, child=st.child.numpy(), heights=h,
                  names=res.tree.names)
    for taxa, lo, hi in cals:
        node = tt.mrca([tt.names.index(t) for t in taxa])
        if not lo <= h[node] <= hi:
            fail(f"[{tag}] calibration [{lo}, {hi}] of a {len(taxa)}-taxon "
                 f"clade broken: its MRCA at {h[node]}")
    return dt_min


def parse_outputs(tag, prefix, names, n_iter, thin):
    """The trace (header, one row of finite numbers every `thin`
    iterations, the ESS line) and the chronogram (every taxon, finite
    non-negative durations) parse; returns the trace's rows."""
    from phyml_tpu_torch.io.newick import parse_newick

    with open(prefix + "_phyml_trace.txt") as fh:
        lines = fh.read().splitlines()
    if lines[0] != "iter\tposterior\tlnL\troot_height\tclock\tnu":
        fail(f"[{tag}] trace header {lines[0]!r}")
    rows = [[float(x) for x in ln.split("\t")] for ln in lines[1:]
            if not ln.startswith("#")]
    if len(rows) != -(-n_iter // thin) or not np.isfinite(rows).all() or \
            not any(ln.startswith("# ESS:") for ln in lines):
        fail(f"[{tag}] the trace does not parse: {len(rows)} rows")
    with open(prefix + "_chronogram.txt") as fh:
        root = parse_newick(fh.read().strip())
    leaves, lengths, stack = [], [], [root]
    while stack:
        nd = stack.pop()
        stack += nd.children
        if nd.is_leaf:
            leaves.append(nd.name)
        if nd is not root:
            lengths.append(nd.length)
    if sorted(leaves) != sorted(names) or not all(
            x is not None and math.isfinite(x) and x >= 0 for x in lengths):
        fail(f"[{tag}] the chronogram does not parse to the taxa with "
             "finite non-negative durations")
    return rows


def phytime_run(label, aln_path, tree_path, cuda):
    """One <phytime> XML run through run_xml on the card (PHYTIME_RUNS),
    with every launch counter set to 0 just before and read just after,
    the chain's lnL evaluations and topology proposals counted and
    timed, the card's idle share and peak memory.  Checks the route's
    kernels launched and K3 never, MALA's weight 0, the cached lnL
    against a recompute, feasible heights, the calibrations and the
    outputs.  Returns (counts, result, numbers)."""
    import torch
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.io.xmlcfg import run_xml

    dt, n_iter, lineagerates, topo_moves = PHYTIME_RUNS[label]
    tag = f"phytime {label}"
    d = os.path.dirname(aln_path)
    names = list(read_alignment(aln_path, datatype=dt).names)
    cals = phytime_calibrations(tree_path, names)
    xml = os.path.join(d, "phytime.xml")
    phytime_xml(xml, os.path.basename(aln_path), tree_path, dt, cals,
                lineagerates, topo_moves)
    path = ("K1", "K2") if dt == "nt" else ("K4", "K5")
    reset_counts()
    with chain_probes() as rec, utilization_sampler() as util:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.time()
        rc = run_xml(xml, quiet=True, device=cuda, mcmc_iter_cap=n_iter)
        torch.cuda.synchronize()
        wall = time.time() - t1
    counts = launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    busy = statistics.mean(util) if util else None
    if rc != 0:
        fail(f"[{tag}] run_xml returned {rc}")
    res, start = rec["results"][0], rec["starts"][0]
    mcmc = res.mcmc
    st = res.state
    again = mcmc._lnL(st)
    twice = mcmc._lnL(st)
    gap = float(st.lnL) - float(again)
    ess = {k: float(v) for k, v in mcmc.ess.items()}
    chain_s = rec["run"][1]
    n_lnl, lnl_s = rec["lnL"]
    n_topo, topo_s = rec["topology"]
    n_tlnl, tlnl_s = rec.get("topology lnL", (0, 0.0))
    n_sched, sched_s = rec["schedules"]
    slot = path[0]
    num = dict(
        n_taxa=len(names), iterations=n_iter, wall_s=wall, chain_s=chain_s,
        setup_s=wall - chain_s, ms_per_iteration=1e3 * chain_s / n_iter,
        lnl_evaluations=n_lnl, lnl_ms=1e3 * lnl_s / max(1, n_lnl),
        topology_tries=mcmc.topo_tries, topology_accepts=mcmc.topo_accepts,
        topology_ms=1e3 * topo_s / max(1, n_topo),
        topology_lnl_evaluations=n_tlnl,
        topology_lnl_ms=1e3 * tlnl_s / max(1, n_tlnl),
        schedule_builds=n_sched, schedule_ms=1e3 * sched_s / max(1, n_sched),
        lnl_breakdown=lnl_breakdown(mcmc, st),
        host_ms_per_iteration=1e3 * (chain_s - lnl_s - topo_s) / n_iter,
        launches=counts, slot_launches_per_iteration=counts[slot] / n_iter,
        idle_share=None if busy is None else 1 - busy,
        nvml_samples=len(util), peak_gib=peak,
        start_posterior=float(start.lnL + start.lp),
        start_lnl=float(start.lnL), final_posterior=float(st.lnL + st.lp),
        final_lnl=float(st.lnL), cached_minus_recompute=gap,
        mala_weight=float(mcmc.move_w[-1]), ess=ess,
        clock=float(torch.exp(st.log_clock)), nu=float(torch.exp(st.log_nu)))
    print(f". [{tag}] {len(names)} taxa, {n_iter} iterations: wall "
          f"{wall:.2f} s (chain {chain_s:.2f} s, {num['ms_per_iteration']:.3f}"
          f" ms an iteration; set-up {wall - chain_s:.2f} s); {n_lnl} lnL "
          f"evaluations x {num['lnl_ms']:.3f} ms (with the read-back); "
          f"topology {mcmc.topo_accepts}/{mcmc.topo_tries} accepted, "
          f"{num['topology_ms']:.3f} ms a proposal ({n_tlnl} lnL "
          f"evaluations x {num['topology_lnl_ms']:.3f} ms), {n_sched} slot "
          f"schedules built x {num['schedule_ms']:.3f} ms; host "
          f"{num['host_ms_per_iteration']:.3f} ms an iteration; "
          f"{slot} {num['slot_launches_per_iteration']:.3f} launches an "
          f"iteration; idle share "
          + ("not measured" if busy is None else f"{1 - busy:.3f}")
          + f"; peak {peak:.3f} GiB; launches {counts}")
    print(f". [{tag}] one lnL evaluation at the final state: "
          + ", ".join(f"{k} {v:.4f}" for k, v in
                      num["lnl_breakdown"].items()))
    print(f". [{tag}] posterior {num['start_posterior']:.4f} -> "
          f"{num['final_posterior']:.4f}, lnL {num['start_lnl']:.4f} -> "
          f"{num['final_lnl']:.4f}; cached - recompute {gap:.3e}; ESS {ess}")
    if float(again) != float(twice):
        fail(f"[{tag}] two recomputes of one state differ: {float(again)} "
             f"and {float(twice)}")
    if not abs(gap) <= CACHE_TOL:
        fail(f"[{tag}] cached lnL off the recompute by {gap}")
    if mcmc.move_w[-1] != 0.0:
        fail(f"[{tag}] MALA has weight {mcmc.move_w[-1]} on the card")
    if not (math.isfinite(num["final_posterior"]) and
            math.isfinite(num["start_posterior"])):
        fail(f"[{tag}] the start or final posterior is not finite")
    if topo_moves and mcmc.topo_tries == 0:
        fail(f"[{tag}] no topology move was tried")
    for name, count in counts.items():
        if name in path and count <= 0:
            fail(f"[{tag}] {name} never launched")
        if name not in path and count != 0:
            fail(f"[{tag}] {name} launched {count} times off its route")
    num["min_duration"] = chain_state_checks(tag, res, cals)
    prefix = os.path.join(d, "out_phytime")
    parse_outputs(tag, prefix, names, n_iter, 50)
    return counts, res, num


def lnl_breakdown(mcmc, st, reps=200):
    """What one of the chain's lnL evaluations at st is made of (ms,
    each the mean over reps): the whole call with its read-back
    (`MCMC._lnL`), the same work enqueued without the read-back (one
    synchronize after all reps: the host's share), the card's time for
    it (CUDA events around that loop), and the slot kernel alone."""
    import torch
    from phyml_tpu_torch.ops.likelihood import TreeArrays

    eng = mcmc.engine
    blen, _ = mcmc._blen(st)

    def enqueue():
        tree = TreeArrays(child=st.child, blen=blen.to(eng.device, eng.dtype))
        sys_ = eng.system_of(mcmc._params(st))
        if mcmc.rate_model.kind == "guindon":
            return eng._loglik_mgf_sys(sys_, tree, torch.exp(st.log_nu))
        return eng._loglik_sys(sys_, tree)

    out = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        mcmc._lnL(st)
    out["with_read_back_ms"] = 1e3 * (time.perf_counter() - t) / reps
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t = time.perf_counter()
    start.record()
    for _ in range(reps):
        enqueue()
    end.record()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    out["enqueue_ms"] = 1e3 * host / reps
    out["device_ms"] = start.elapsed_time(end) / reps
    lam, V, Vinv, pi, w, _ = eng.system_of(mcmc._params(st))
    pm = eng._pmats(lam, V, Vinv, blen.to(eng.device, eng.dtype))
    _, sched, n_slots = eng._topology(st.child)
    fn = wrappers()[eng.lnl_route]
    out["slot_kernel_ms"] = timed(lambda: fn(
        sched, eng.slot_tips, pm, pi, eng._logw(w), n_slots=n_slots))[1]
    return out


def chain_kernel_row(label, cell, mcmc, st, dt, launches, mgf=False):
    """The route's slot kernel at a chain state's P-matrices (the
    Guindon clock's MGF P-matrices with mgf, sigma = exp(log_nu) of the
    state) against K1's plain version, timed, with its bound; launches
    are the run's."""
    import torch
    from phyml_tpu_torch.models.eigen import mgf_rates
    from phyml_tpu_torch.ops import clv_slots

    eng = mcmc.engine
    blen, _ = mcmc._blen(st)
    blen = blen.to(eng.device, eng.dtype)
    lam, V, Vinv, pi, w, _ = eng.system_of(mcmc._params(st))
    if mgf:
        lam = mgf_rates(lam, torch.exp(st.log_nu).to(eng.device, eng.dtype))
    pm = eng._pmats(lam, V, Vinv, blen)
    _, sched, n_slots = eng._topology(st.child)
    logw = eng._logw(w)
    args = (sched, eng.slot_tips, pm, pi, logw)
    kname = eng.lnl_route
    fn = wrappers()[kname]
    ref, pms = timed(lambda: clv_slots.uppass_site_lse_slots_plain(
        *args, n_slots=n_slots), 1)
    out, ms = timed(lambda: fn(*args, n_slots=n_slots))
    err = float((out - ref).abs().max())
    n, C, ns, k = eng.n_otu, eng.C, eng.ns, eng.P
    b_ms, b_by = bound(pruning_flops(n, C, ns, k),
                       nbytes(sched, eng.tips, pm, pi, logw) + k * 4)
    print(f". [{cell}] {kname} {fn.__name__} at the chain's "
          f"{'MGF ' if mgf else ''}P-matrices ({label}): max|d|={err:.3e} "
          f"(tol {site_tol(dt, ns):g})  kernel {ms:.4f} ms  plain "
          f"{pms:.3f} ms  bound {b_ms:.4f} ms ({b_by})  launches {launches}")
    if not err <= site_tol(dt, ns):
        fail(f"[{cell}] {kname} disagrees with its plain version at the "
             f"chain's P-matrices: {err}")
    return dict(name=f"{kname} {fn.__name__} [{cell}]", route="cuda",
                source=f"phyml_tpu_torch/csrc/{SOURCE[kname]}",
                replaces=TPU_KERNEL[kname], launches=launches,
                max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, ns=ns, path=dt, cell=cell,
                launches_from=f"the phytime {label} run")


def phytime_phase(tmp, cuda):
    """The three <phytime> runs at full width (PHYTIME_RUNS: the DNA
    bench problem with a lognormal clock and topology moves, the same
    under the Guindon clock at a fixed topology, the 64-taxon protein
    problem), each on a copy of its problem, and the slot kernel's rows
    at each run's final state.  Returns (numbers by run, kernel rows)."""
    import torch

    runs, rows = {}, []
    for label, (dt, _, _, _) in PHYTIME_RUNS.items():
        n_taxa = N_TAXA if dt == "nt" else DEFAULT_RUN_TAXA["aa"]
        aln, tree = write_problem(os.path.join(tmp, f"phytime_{label}"), dt,
                                  n_taxa, N_SITES, SEED)
        counts, res, runs[label] = phytime_run(label, aln, tree, cuda)
        cell = "phytime-guindon" if label == "guindon" else "phytime"
        slot = res.mcmc.engine.lnl_route
        rows.append(chain_kernel_row(label, cell, res.mcmc, res.state, dt,
                                     counts[slot], mgf=label == "guindon"))
        del res
        torch.cuda.empty_cache()
    return runs, rows


def phytime_side(d, platform):
    """The 16 x 500 dating check's side on one platform: the XML run's
    start (the user tree's branch lengths fitted, TimeTree.from_topology)
    and the chain's state there; on the card also a 1,000-iteration
    chain with topology moves, and the same chain checkpointed at 500
    and resumed, which must end in the same state."""
    import torch
    from phyml_tpu_torch.bayes.chrono import TimeTree
    from phyml_tpu_torch.bayes.mcmc import MCMC, MCMCSettings
    from phyml_tpu_torch.bayes.rates import RateModel
    from phyml_tpu_torch.bayes.times import Calibration, TimePrior
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.models.substitution import SubstModel
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.optim.blen import optimize_branch_lengths
    from phyml_tpu_torch.search.nni import _host_blen
    from phyml_tpu_torch.topology import Topology

    device = torch.device("cuda" if platform == "gpu" else "cpu")
    dtype = torch.float32 if platform == "gpu" else torch.float64
    aln_path, tree_path = write_problem(d, "nt", 16, 500, SEED + 1)
    aln = read_alignment(aln_path, datatype="nt")
    names = list(aln.names)
    model = SubstModel(datatype="nt", name="GTR", n_classes=4)
    params = model.init_params(aln.obs_state_freqs)
    eng = LikelihoodEngine(aln, model, dtype=dtype, device=device)
    with open(tree_path) as fh:
        topo = Topology.from_newick(fh.read(), names)
    rv = topo.rooted()
    ta, _ = optimize_branch_lengths(eng, params, tree_arrays(
        rv, dtype=dtype, device=device))
    topo.set_blen_from_rooted(rv, _host_blen(ta))
    tt = TimeTree.from_topology(topo, names=names)
    cals = tuple(Calibration(taxa=tuple(t), lower=lo, upper=hi)
                 for t, lo, hi in phytime_calibrations(tree_path, names))

    def chain(n_iter):
        return MCMC(eng, model, params, tt, RateModel(kind="lognormal"),
                    TimePrior(kind="birthdeath", calibrations=cals),
                    MCMCSettings(n_iter=n_iter, burnin=500, batch=250,
                                 seed=3),
                    sample_topology=True)

    def host(st):
        return {k: ({k2: v2.numpy() for k2, v2 in v.items()}
                    if isinstance(v, dict) else v.numpy())
                for k, v in st._asdict().items()}

    st0 = chain(1000).init_state()
    out = dict(dir=d, child=tt.child, heights=tt.heights, start=host(st0))
    if platform == "gpu":
        full = chain(1000)
        final, _, _ = full.run(state=st0)
        ck = os.path.join(d, "chain.npz")
        chain(500).run(checkpoint_path=ck)
        resumed, _, _ = chain(1000).run(checkpoint_path=ck)
        out.update(final=host(final), topo_accepts=full.topo_accepts,
                   resume_same=all(
                       np.array_equal(a, b) for a, b in zip(
                           (final.child, final.heights, final.log_r,
                            final.lnL, final.lp),
                           (resumed.child, resumed.heights, resumed.log_r,
                            resumed.lnL, resumed.lp))))
    return out


def report_phytime(gpu, cpu):
    """The 16 x 500 dating check: the same start chronogram (heights
    within HEIGHT_TOL); the card's lnL and log prior at its start state
    and at its chain's final state recomputed by a CPU float64 chain on
    the card side's files (lnL within F64_TOL, log prior within
    PRIOR_REL); the checkpoint resume ended where the chain did."""
    import torch
    from phyml_tpu_torch.bayes.chrono import TimeTree
    from phyml_tpu_torch.bayes.mcmc import MCMC, MCMCSettings
    from phyml_tpu_torch.bayes.rates import RateModel
    from phyml_tpu_torch.bayes.times import Calibration, TimePrior
    from phyml_tpu_torch.interop import chain_state_from_numpy
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.models.substitution import SubstModel
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine

    (g, g_s), (c, c_s) = gpu, cpu
    same_tree = np.array_equal(g["child"], c["child"])
    dh = float(np.abs(g["heights"] - c["heights"]).max())
    aln_path = os.path.join(g["dir"], "aln.phy")
    aln = read_alignment(aln_path, datatype="nt")
    names = list(aln.names)
    model = SubstModel(datatype="nt", name="GTR", n_classes=4)
    eng = LikelihoodEngine(aln, model, dtype=torch.float64, device="cpu")
    tt = TimeTree(n_otu=16, child=g["child"], heights=g["heights"],
                  names=names)
    cals = tuple(Calibration(taxa=tuple(t), lower=lo, upper=hi)
                 for t, lo, hi in phytime_calibrations(
                     os.path.join(g["dir"], "tree.nwk"), names))
    mcmc = MCMC(eng, model, model.init_params(aln.obs_state_freqs), tt,
                RateModel(kind="lognormal"),
                TimePrior(kind="birthdeath", calibrations=cals),
                MCMCSettings(seed=3))
    gaps = {}
    for label in ("start", "final"):
        s = g[label]
        st = chain_state_from_numpy(s)
        gaps[label] = (float(s["lnL"]) - float(mcmc._lnL(st)),
                       float(s["lp"]) - float(mcmc._log_prior(st)))
    print(f". [small] phytime: start chronogram card against CPU: same "
          f"topology {same_tree}, heights max|d| {dh:.2e} (tol "
          f"{HEIGHT_TOL:g}); card lnL - CPU f64 at the start "
          f"{gaps['start'][0]:.3e}, at the final state "
          f"{gaps['final'][0]:.3e} (tol {F64_TOL}); log prior "
          f"{gaps['start'][1]:.2e} / {gaps['final'][1]:.2e}; topology "
          f"accepts {g['topo_accepts']}; checkpoint resume same state "
          f"{g['resume_same']} ({g_s:.1f} s card, {c_s:.1f} s CPU)")
    if not (same_tree and dh <= HEIGHT_TOL):
        fail("small phytime: the start chronograms differ")
    for label, (dl, dp) in gaps.items():
        lp = abs(float(g[label]["lp"]))
        if not (abs(dl) <= F64_TOL and abs(dp) <= PRIOR_REL * max(1.0, lp)):
            fail(f"small phytime: the card's {label} state off the CPU's "
                 f"recompute: lnL {dl}, log prior {dp}")
    if not g["resume_same"]:
        fail("small phytime: the resumed chain ended elsewhere")
    return dict(height_gap=dh, lnl_gaps={k: v[0] for k, v in gaps.items()},
                prior_gaps={k: v[1] for k, v in gaps.items()},
                resume_same=g["resume_same"], gpu_s=g_s, cpu_s=c_s)


# ----------------------------------------------------------------------
# the auxiliary tools: ancestral states, mutation maps, cross-validation,
# the PostScript drawing, subpattern aliasing, and the fastlk chain
# ----------------------------------------------------------------------
# runs of the CLI (`-u tree -o lr`, the fixed-topology fit first), on a
# copy of the bench problem of their datatype: label -> (datatype, flags)
AUX_RUNS = {
    "nt tools": ("nt", ("--ancestral", "--cv", "tip", "--ps",
                        "--alias_subpatt", "--mutmap")),
    "nt kfold.col": ("nt", ("--cv", "kfold.col")),
    "nt kfold.pos": ("nt", ("--cv", "kfold.pos")),
    "aa tools": ("aa", ("--ancestral", "--cv", "tip")),
}
# the functions each run is timed in: (module, attribute, label); the
# fit's probe also reads the launch counters as it returns
AUX_PROBES = [
    ("phyml_tpu_torch.optim.round", "round_optimize", "fit"),
    ("phyml_tpu_torch.ops.ancestral", "marginal_posteriors", "marginals"),
    ("phyml_tpu_torch.io.output", "write_ancestral", "write_ancestral"),
    ("phyml_tpu_torch.ops.ancestral", "sample_ancestral", "sample_ancestral"),
    ("phyml_tpu_torch.ops.ancestral", "map_mutations", "map_mutations"),
    ("phyml_tpu_torch.ops.crossval", "tip_cv", "cv tip"),
    ("phyml_tpu_torch.ops.crossval", "kfold_col_cv", "cv kfold.col"),
    ("phyml_tpu_torch.ops.crossval", "kfold_pos_cv", "cv kfold.pos"),
    ("phyml_tpu_torch.io.output", "write_cv", "write_cv"),
    ("phyml_tpu_torch.io.draw", "write_postscript", "ps"),
    ("phyml_tpu_torch.ops.alias", "alias_stats", "alias"),
]
FASTLK_ITERS = 10000
AUX_TOL = 1e-3    # 16 x 500 posteriors, card f32 against CPU f64
MAP_TIE = 1e-3    # MAP states must agree where the top two differ by more
CV_TOL = 1e-4     # 16 x 500 CV tip score, card f32 against CPU f64
HESS_REL = 1e-8   # fastlk Hessian (both float64), relative to max |H|


@contextlib.contextmanager
def aux_probes():
    """Times every AUX_PROBES function (a synchronize on each side of
    the call) and reads the launch counters when the fit returns;
    yields {label: [calls, seconds]} with "fit launches" added, and
    restores the functions on the way out."""
    import importlib

    import torch

    # the modules that import round_optimize by name bind it before the
    # probe replaces it: their refits are timed under their own label
    importlib.import_module("phyml_tpu_torch.ops.crossval")
    rec, saved = {}, []

    def probe(fn, label):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.time()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            c = rec.setdefault(label, [0, 0.0])
            c[0] += 1
            c[1] += time.time() - t
            if label == "fit":
                rec["fit launches"] = launch_counts()
            return out
        return run

    for mod_name, attr, label in AUX_PROBES:
        mod = importlib.import_module(mod_name)
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, probe(getattr(mod, attr), label))
    try:
        yield rec
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def replay_mutmap(events, blen, states=None, child=None, n_otu=None,
                  t_tol=1e-5):
    """Checks a mutation map: every event inside its edge (times within
    t_tol relative of the lengths), the events of one (edge, site)
    chained state to state; with the sampled states and the child table,
    every edge's chain at every site (an empty one too) leads from the
    parent's state to the node's.  Returns the number of (edge, site)
    chains with events."""
    by = {}
    for (u, p, t, a, b) in events:
        if not (0.0 < t <= blen[u] * (1 + t_tol) + 1e-12 and a != b):
            fail(f"mutation map: event {(u, p, t, a, b)} outside edge "
                 f"{u} (length {blen[u]})")
        by.setdefault((u, p), []).append((t, a, b))
    for evs in by.values():
        evs.sort()
        for (_, _, b), (_, a, _) in zip(evs, evs[1:]):
            if a != b:
                fail(f"mutation map: a jump from {a} follows one to {b}")
    if child is None:
        return len(by)
    parent = {}
    for i, (c0, c1) in enumerate(np.asarray(child)):
        parent[int(c0)] = parent[int(c1)] = n_otu + i
    for u, pa in parent.items():
        if blen[u] <= 0:
            continue
        for p in range(states.shape[1]):
            evs = by.get((u, p), [])
            s = int(states[pa, p])
            if evs and evs[0][1] != s:
                fail(f"mutation map: edge {u} site {p} starts from "
                     f"{evs[0][1]}, not from its parent's {s}")
            end = evs[-1][2] if evs else s
            if end != int(states[u, p]):
                fail(f"mutation map: edge {u} site {p} ends in {end}, not "
                     f"in the node's state {int(states[u, p])}")
    return len(by)


def read_mutmap(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    if lines[0] != ("# sampled substitution history "
                    "(node, site, time_from_parent, from, to)"):
        fail(f"{path}: not a mutation map")
    out = []
    for ln in lines[1:]:
        u, p, t, a, b = ln.split("\t")
        out.append((int(u), int(p), float(t), int(a), int(b)))
    return out


def aux_outputs(label, aln_path, names, n_sites, counts):
    """Checks one run's output files; returns their numbers."""
    from phyml_tpu_torch.topology import Topology

    out = {}
    n = len(names)
    seq = f"{aln_path}_phyml_ancestral_seq.txt"
    if os.path.exists(seq):
        rows, sums = 0, []
        with open(seq) as fh:
            for ln in fh:
                f = ln.rstrip("\n").split("\t")
                if len(f) > 3 and f[0].strip().isdigit():
                    rows += 1
                    sums.append(sum(float(x) for x in f[2:-1]))
        with open(f"{aln_path}_phyml_ancestral_tree.txt") as fh:
            anc_tree = fh.read()
        out["ancestral_rows"] = rows
        out["posterior_sum_gap"] = float(np.abs(np.asarray(sums) - 1).max())
        # float32 posteriors sum to 1 within the card's gap to the CPU
        if rows != (n - 2) * n_sites or out["posterior_sum_gap"] > AUX_TOL \
                or not all(nm in anc_tree for nm in names):
            fail(f"[{label}] the ancestral files are malformed ({rows} rows, "
                 f"sums off by {out['posterior_sum_gap']})")
    cv = f"{aln_path}_phyml_cv.txt"
    if os.path.exists(cv):
        with open(cv) as fh:
            text = fh.read()
        score = float(text.split(". Score:")[1].split()[0])
        out["cv_score"] = score
        out["cv_lines"] = text.count("\n")
        if not (math.isfinite(score) and score < 0):
            fail(f"[{label}] CV score {score}")
    ps = f"{aln_path}_phyml_tree.ps"
    if os.path.exists(ps):
        with open(ps) as fh:
            text = fh.read()
        if not (text.startswith("%!PS-Adobe-3.0") and
                text.rstrip().endswith("%%EOF")):
            fail(f"[{label}] the PostScript drawing is malformed")
        out["ps_bytes"] = len(text)
    mm = f"{aln_path}_phyml_mutmap.txt"
    if os.path.exists(mm):
        events = read_mutmap(mm)
        with open(f"{aln_path}_phyml_tree.txt") as fh:
            rv = Topology.from_newick(fh.read(), names).rooted()
        out["mutmap_events"] = len(events)
        out["mutmap_chains"] = replay_mutmap(events, rv.node_blen)
    return out


def aux_run(label, aln_path, tree_path, cuda):
    """One AUX_RUNS run through the CLI on the card, every launch counter
    set to 0 just before and read just after, each tool timed, the
    card's idle share and peak memory; the fit's kernels must launch
    and nothing off its route, and the tools after the fit launch only
    what the k-fold refits launch.  Returns its numbers."""
    import torch
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.io.alignment import read_alignment

    dt, flags = AUX_RUNS[label]
    argv = cli_argv(dt, aln_path, tree_path, "gpu") + list(flags)
    aln = read_alignment(aln_path, datatype=dt)
    model = cli._build_model(cli.build_parser().parse_args(argv), aln)
    path = route_path(aln, model)
    W = wrappers()
    reset_counts()
    out = io.StringIO()
    with aux_probes() as rec, utilization_sampler() as util:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.time()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t1
    if rc != 0:
        fail(f"[aux {label}] the run returned {rc}")
    counts = launch_counts()
    fit = rec.pop("fit launches")
    after = {k: counts[k] - fit[k] for k in counts}
    busy = statistics.mean(util) if util else None
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    res = dict(
        n_taxa=aln.n_otu, n_patterns=aln.n_patterns, wall_s=wall,
        tools_s={k: v[1] for k, v in rec.items()},
        calls={k: v[0] for k, v in rec.items()},
        fit_launches=fit, tool_launches=after,
        idle_share=None if busy is None else 1 - busy,
        nvml_samples=len(util), peak_gib=peak)
    res.update(aux_outputs(label, aln_path, list(aln.names), aln.n_sites,
                           counts))
    alias = [ln for ln in out.getvalue().splitlines()
             if "Subpattern aliasing" in ln]
    if "--alias_subpatt" in flags:
        if not alias:
            fail(f"[aux {label}] no subpattern aliasing report")
        res["alias"] = alias[0].split(": ", 1)[1]
    print(f". [aux {label}] {aln.n_otu} taxa x {aln.n_sites} sites "
          f"({aln.n_patterns} patterns), {' '.join(flags)}: wall "
          f"{wall:.2f} s; " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                        res["tools_s"].items())
          + f"; fit launches {fit}, after the fit {after}; idle share "
          + ("not measured" if busy is None else f"{1 - busy:.3f}")
          + f"; peak {peak:.2f} GiB"
          + "".join(f"; {k} {res[k]}" for k in (
              "cv_score", "ancestral_rows", "mutmap_events", "alias")
              if k in res))
    for name in W:
        if name in path and fit[name] <= 0:
            fail(f"[aux {label}] {name} never launched in the fit")
        if name not in path and counts[name] != 0:
            fail(f"[aux {label}] {name} launched {counts[name]} times off "
                 "its route")
    if "kfold" not in label and any(after.values()):
        fail(f"[aux {label}] the tools launched kernels after the fit: "
             f"{after}")
    return res


def fastlk_run(aln_path, tree_path, cuda):
    """run_phytime(fastlk=True) on the DNA bench problem (GTR+G4, the
    simulating tree as the chronogram's shape, a lognormal clock, the
    birth-death prior), FASTLK_ITERS iterations, every launch counter set
    to 0 just before and read just after: the Hessian must be a float64
    tensor on the card, no pruning kernel may launch, and the cached lnL
    must be the quadratic surface's at the final state.  Returns its
    numbers."""
    import torch
    from phyml_tpu_torch.bayes.chrono import TimeTree
    from phyml_tpu_torch.bayes.date import run_phytime
    from phyml_tpu_torch.bayes.mcmc import MCMCSettings
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.models.substitution import SubstModel
    from phyml_tpu_torch.optim import fastlk
    from phyml_tpu_torch.topology import Topology

    aln = read_alignment(aln_path, datatype="nt")
    names = list(aln.names)
    with open(tree_path) as fh:
        tt = TimeTree.from_topology(Topology.from_newick(fh.read(), names),
                                    names=names)
    model = SubstModel(datatype="nt", name="GTR", n_classes=4)
    fits = []
    real = fastlk.fit_normal_approx

    def fit(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.time()
        na = real(*a, **k)
        torch.cuda.synchronize()
        fits.append((na, time.time() - t,
                     (torch.cuda.max_memory_allocated() - base) / 2 ** 30))
        return na

    reset_counts()
    fastlk.fit_normal_approx = fit
    try:
        with utilization_sampler() as util:
            t1 = time.time()
            res = run_phytime(
                aln, tt, model=model, rate_kind="lognormal",
                prior_kind="birthdeath", fastlk=True, device=cuda,
                settings=MCMCSettings(n_iter=FASTLK_ITERS, burnin=2000,
                                      batch=250, seed=7))
            torch.cuda.synchronize()
            wall = time.time() - t1
    finally:
        fastlk.fit_normal_approx = real
    counts = launch_counts()
    na, fit_s, fit_gib = fits[0]
    st = res.state
    gap = float(st.lnL) - float(res.mcmc._lnL(st))
    busy = statistics.mean(util) if util else None
    chain_s = wall - fit_s
    # the surface's curvature over the free slots: a positive eigenvalue
    # is a direction in which the chain's lnL grows without bound
    ev = torch.linalg.eigvalsh(na.hess[:-1, :-1])
    n_pos = int((ev > 1e-9 * float(ev.abs().max())).sum())
    num = dict(
        n_taxa=aln.n_otu, iterations=FASTLK_ITERS, wall_s=wall,
        hessian_s=fit_s, hessian_peak_gib=fit_gib,
        hessian_chunk=fastlk.hessian_chunk(res.mcmc.engine),
        chain_s=chain_s, ms_per_iteration=1e3 * chain_s / FASTLK_ITERS,
        launches=counts, idle_share=None if busy is None else 1 - busy,
        nvml_samples=len(util), lnl0=float(na.lnL0),
        final_lnl=float(st.lnL), cached_minus_surface=gap,
        hess_dtype=str(na.hess.dtype), hess_device=str(na.hess.device),
        max_abs_hess=float(na.hess.abs().max()),
        hess_positive_eigenvalues=n_pos, hess_max_eigenvalue=float(ev.max()),
        accept={k: v for k, v in res.summary["acceptance"].items() if v})
    print(f". [aux fastlk] run_phytime(fastlk=True), {aln.n_otu} taxa, "
          f"{FASTLK_ITERS} iterations: wall {wall:.2f} s; Hessian "
          f"{fit_s:.2f} s ({na.hess.dtype} on {na.hess.device}, chunks of "
          f"{num['hessian_chunk']}, peak {fit_gib:.2f} GiB); chain "
          f"{chain_s:.2f} s ({num['ms_per_iteration']:.3f} ms an "
          f"iteration); idle share "
          + ("not measured" if busy is None else f"{1 - busy:.3f}")
          + f"; launches {counts}; lnL0 {num['lnl0']:.4f}, final "
          f"{num['final_lnl']:.4f}, cached - surface {gap:.2e}; the "
          f"Hessian has {n_pos} positive eigenvalues of {len(ev)} (largest "
          f"{num['hess_max_eigenvalue']:.4g})")
    if na.hess.dtype != torch.float64 or na.hess.device.type != "cuda":
        fail("[aux fastlk] the Hessian is not a float64 tensor on the card")
    if any(counts.values()):
        fail(f"[aux fastlk] the fastlk chain launched kernels: {counts}")
    if not (abs(gap) <= 1e-6 * max(1.0, abs(float(st.lnL))) and
            math.isfinite(float(st.lnL)) and
            np.isfinite(res.trace).all()):
        fail("[aux fastlk] the chain's lnL is not the surface's")
    return num


def xml_mutmap_run(tmp, cuda):
    """A <phytime mutmap="yes"> XML on the 16 x 500 problem, 500
    iterations: the mutation map of the final chronogram parses and its
    events chain.  Returns its numbers."""
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.io.xmlcfg import run_xml

    d = os.path.join(tmp, "aux_xml_mutmap")
    aln_path, tree_path = write_problem(d, "nt", 16, 500, SEED + 1)
    names = list(read_alignment(aln_path, datatype="nt").names)
    xml = os.path.join(d, "phytime.xml")
    phytime_xml(xml, "aln.phy", tree_path, "nt",
                phytime_calibrations(tree_path, names), "lognormal", False)
    with open(xml) as fh:
        text = fh.read().replace("<phytime ", '<phytime mutmap="yes" ', 1)
    with open(xml, "w") as fh:
        fh.write(text)
    t1 = time.time()
    rc = run_xml(xml, quiet=True, device=cuda, mcmc_iter_cap=500)
    wall = time.time() - t1
    if rc != 0:
        fail(f"[aux xml mutmap] run_xml returned {rc}")
    events = read_mutmap(os.path.join(d, "out_phytime_phyml_mutmap.txt"))
    chains = replay_mutmap(events, np.full(31, np.inf))
    print(f". [aux xml mutmap] <phytime mutmap=\"yes\"> 16 x 500, 500 "
          f"iterations on the card: {wall:.2f} s, {len(events)} events "
          f"on {chains} (edge, site) chains")
    if not events:
        fail("[aux xml mutmap] no event in the mutation map")
    return dict(wall_s=wall, events=len(events), chains=chains)


def aux_phase(tmp, cuda):
    """The auxiliary tools on the card (AUX_RUNS at 128 x 4096, DNA and
    protein), the fastlk chain on the DNA problem and a <phytime
    mutmap="yes"> XML at 16 x 500.  Returns their numbers, and each
    datatype's fit launches of its tools run."""
    import torch

    out, fit_launches = {}, {}
    t0 = time.time()
    for label, (dt, _) in AUX_RUNS.items():
        aln, tree = write_problem(os.path.join(tmp, "aux_" + label.replace(
            " ", "_")), dt, N_TAXA, N_SITES, SEED)
        out[label] = aux_run(label, aln, tree, cuda)
        if label.endswith("tools"):
            fit_launches[dt] = out[label]["fit_launches"]
        torch.cuda.empty_cache()
    # the fastlk chain at the default run's depth of the protein problem
    # (64 taxa; a depth cut, as its Hessian grows with the edges squared)
    aln, tree = write_problem(os.path.join(tmp, "aux_fastlk"), "nt",
                              DEFAULT_RUN_TAXA["aa"], N_SITES, SEED)
    out["fastlk"] = fastlk_run(aln, tree, cuda)
    torch.cuda.empty_cache()
    out["xml mutmap"] = xml_mutmap_run(tmp, cuda)
    out["wall_s"] = time.time() - t0
    print(f". [aux] phase wall {out['wall_s']:.1f} s")
    return out, fit_launches


def aux_side(d, platform):
    """The 16 x 500 check of the tools on one platform (GTR+G4 at the
    simulation's parameters, the simulating tree): the marginal
    posteriors (the root row included), the CV tip score, the fastlk
    normal approximation (float64 on both) at the tree's lengths (at
    least 0.01), and on the card one joint draw and its mutation map."""
    import torch
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.models.substitution import SubstModel
    from phyml_tpu_torch.ops.ancestral import (
        map_mutations, marginal_posteriors, sample_ancestral,
    )
    from phyml_tpu_torch.ops.crossval import tip_cv
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.optim.fastlk import fit_normal_approx
    from phyml_tpu_torch.topology import Topology

    device = torch.device("cuda" if platform == "gpu" else "cpu")
    dtype = torch.float32 if platform == "gpu" else torch.float64
    aln_path, tree_path = write_problem(d, "nt", 16, 500, SEED + 1)
    aln = read_alignment(aln_path, datatype="nt")
    model = SubstModel(datatype="nt", name="GTR", n_classes=4)
    params = true_params("nt", model.init_params(aln.obs_state_freqs))
    eng = LikelihoodEngine(aln, model, dtype=dtype, device=device)
    with open(tree_path) as fh:
        rv = Topology.from_newick(fh.read(), aln.names).rooted()
    tree = tree_arrays(rv, dtype=dtype, device=device)
    probs = marginal_posteriors(eng, params, tree, include_root=True)
    blen = torch.as_tensor(rv.node_blen, dtype=torch.float64).clone()
    blen[:-1] = blen[:-1].clamp(min=0.01)
    na = fit_normal_approx(eng, params, tree._replace(blen=blen.to(device)))
    out = dict(probs=probs.cpu().numpy(),
               cv=tip_cv(eng, params, tree)["score"],
               hess=na.hess.cpu().numpy(), lnl0=float(na.lnL0),
               hess_on=str(na.hess.device), hess_dtype=str(na.hess.dtype))
    if platform == "gpu":
        gen = torch.Generator(device=device)
        gen.manual_seed(5)
        cls, states = sample_ancestral(eng, params, tree, gen)
        out.update(states=states.cpu().numpy(), child=np.asarray(rv.child),
                   blen=np.asarray(rv.node_blen), n_otu=rv.n_otu,
                   events=map_mutations(eng, params, tree, cls, states,
                                        np.random.default_rng(6)))
    return out


def report_aux(gpu, cpu):
    """The 16 x 500 check of the tools: posteriors within AUX_TOL and
    the same MAP states wherever the CPU's top two differ by more than
    MAP_TIE; the CV tip score within CV_TOL; the fastlk Hessian within
    HESS_REL of max |H| (the root slot left out) and on the card in
    float64; the card's mutation map consistent with its draw."""
    (g, g_s), (c, c_s) = gpu, cpu
    gap = float(np.abs(g["probs"] - c["probs"]).max())
    top2 = np.sort(c["probs"], axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MAP_TIE
    map_same = bool((g["probs"].argmax(-1) == c["probs"].argmax(-1))[
        clear].all())
    cv_gap = g["cv"] - c["cv"]
    k = g["hess"].shape[0] - 1
    hc = c["hess"][:k, :k]
    h_rel = float(np.abs(g["hess"][:k, :k] - hc).max() / np.abs(hc).max())
    chains = replay_mutmap(g["events"], g["blen"], g["states"], g["child"],
                           g["n_otu"], t_tol=1e-6)
    print(f". [small] aux tools (16 x 500, GTR+G4): posteriors max|d| "
          f"{gap:.2e} (tol {AUX_TOL}), MAP states equal where the top two "
          f"differ by more than {MAP_TIE}: {map_same} ({int(clear.sum())} "
          f"of {clear.size} cells); CV tip score gpu {g['cv']:.6f} cpu "
          f"{c['cv']:.6f} diff {cv_gap:.2e} (tol {CV_TOL}); fastlk "
          f"Hessian ({g['hess_dtype']} on {g['hess_on']}) relative gap "
          f"{h_rel:.2e} (tol {HESS_REL}); mutation map {len(g['events'])} "
          f"events on {chains} chains, endpoints consistent ({g_s:.1f} s "
          f"card, {c_s:.1f} s CPU)")
    if not (gap <= AUX_TOL and map_same):
        fail("small aux: the card's posteriors are off the CPU's")
    if not abs(cv_gap) <= CV_TOL:
        fail("small aux: the card's CV tip score is off the CPU's")
    if not (h_rel <= HESS_REL and g["hess_dtype"] == "torch.float64"
            and g["hess_on"].startswith("cuda")):
        fail("small aux: the card's fastlk Hessian is off the CPU's")
    return dict(posterior_gap=gap, map_same=map_same, cv_gap=cv_gap,
                hessian_rel_gap=h_rel, mutmap_events=len(g["events"]),
                gpu_s=g_s, cpu_s=c_s)


# ----------------------------------------------------------------------
# PhyREX, the joint phylogeography chain: the movement models on the
# chain's log prior, the SLFV event-disk sampler, the <phyrex> root
# ----------------------------------------------------------------------
# <phyrex> runs at full width: label -> (<spatialmodel> name or None for
# the SLFV default, <lineagerates> model or None for the XML default
# (the Guindon clock), optimise.tree, mcmc_iter_cap; SLFV sweeps are
# the cap / 20)
PHYREX_RUNS = {"rrw": ("rrw+lognormal", "lognormal", True, 3000),
               "ibm": ("ibm", None, False, 2000),
               "slfv": (None, None, True, 4000)}
PHYREX_ROOT = (-95.0, 38.0)   # the tips' coordinates: Brownian motion
PHYREX_S2 = 4.0               # from here, degrees^2 per unit of height
GEO_REL = 1e-9    # GeoModel.loglik, card float64 against CPU float64


def phyrex_labels(names):
    """Taxon labels that carry the coordinate rows' '|Name|' token."""
    return [f"S|{nm}|" for nm in names]


def phyrex_problem(d, n_taxa, n_sites, seed):
    """The DNA problem with its taxa relabelled S|Name| (alignment and
    tree), and a coordinates file in the reference's format ('#
    state.name lon lat', then '|Name| lon lat'): Brownian motion down
    the simulating tree from PHYREX_ROOT, sigma^2 PHYREX_S2, from the
    seed.  Returns (alignment path, tree path, coordinates path,
    coordinates [n, 2] in taxon order)."""
    from phyml_tpu_torch.bayes.chrono import TimeTree
    from phyml_tpu_torch.topology import Topology

    aln_path, tree_path = write_problem(d, "nt", n_taxa, n_sites, seed)
    names = read_phylip_rows(aln_path)[0]
    with open(tree_path) as fh:
        topo = Topology.from_newick(fh.read(), names)
    tt = TimeTree.from_topology(topo, names=names)
    rng = np.random.default_rng(seed + 12)
    par, dt = tt.parent, tt.edge_durations()
    x = np.zeros((tt.n_nodes, 2))
    x[tt.root] = PHYREX_ROOT
    for u in range(tt.n_nodes - 2, -1, -1):
        x[u] = x[par[u]] + rng.normal(size=2) * np.sqrt(PHYREX_S2 * dt[u])
    labels = phyrex_labels(names)
    with open(aln_path) as fh:
        head, *rows = fh.read().splitlines()
    with open(aln_path, "w") as fh:
        fh.write(head + "\n" + "".join(
            f"{lab}  {row.split()[1]}\n" for lab, row in zip(labels, rows)))
    with open(tree_path, "w") as fh:
        fh.write(topo.to_newick(labels) + "\n")
    coord_path = os.path.join(d, "coords.txt")
    with open(coord_path, "w") as fh:
        fh.write("# state.name lon lat\n")
        for nm, (a, b) in zip(names, x[:n_taxa]):
            fh.write(f"|{nm}| {float(a)!r} {float(b)!r}\n")
    return aln_path, tree_path, coord_path, x[:n_taxa]


def phyrex_xml(path, aln_name, tree_path, coord_name, spatial, lineagerates,
               sample_topology, seed=1):
    """A <phyrex> analysis: GTR+G4 on aln_name, the user tree, the
    coordinates, the <spatialmodel> (none: SLFV), outputs out_phyrex_*."""
    sm = f'  <spatialmodel name="{spatial}"/>\n' if spatial else ""
    lr = (f'  <lineagerates model="{lineagerates}"/>\n'
          if lineagerates else "")
    rates = "".join(f'<instance id="R{i}" init.value="1.0"/>'
                    for i in range(1, 5))
    with open(path, "w") as fh:
        fh.write(f'''<phyrex run.id="phyrex" output.file="out" r.seed="{seed}"
  mcmc.chain.len="1e6" mcmc.sample.every="50" mcmc.burnin="1000">
{sm}{lr}  <topology><instance id="T1" init.tree="user" file.name="{tree_path}"
    optimise.tree="{'yes' if sample_topology else 'no'}"/></topology>
  <ratematrices><instance id="M1" model="GTR"/></ratematrices>
  <siterates>{rates}<weights family="gamma" alpha="1.0"/></siterates>
  <branchlengths><instance id="L1"/></branchlengths>
  <partitionelem file.name="{aln_name}" data.type="nt" interleaved="no">
    <mixtureelem list="T1,T1,T1,T1"/>
    <mixtureelem list="M1,M1,M1,M1"/>
    <mixtureelem list="R1,R2,R3,R4"/>
    <mixtureelem list="L1,L1,L1,L1"/>
  </partitionelem>
  <coordinates file.name="{coord_name}"/>
</phyrex>
''')


@contextlib.contextmanager
def phyrex_probes():
    """Counts and times the chain's lnL evaluations (MCMC._lnL, each
    one slot-kernel pass and a read-back), the location term
    (traits.location_loglik), the topology proposals, the SLFV
    sampler's sweeps and its sequence lnL calls, and keeps each
    run_phyrex's result with the launch counts at its start (after
    the start chronogram's fit); restores the functions on the way
    out."""
    from phyml_tpu_torch.bayes import phyrex, slfv, traits
    from phyml_tpu_torch.bayes.mcmc import MCMC

    rec = {"results": [], "at_start": []}
    inside = []

    def timed_fn(fn, key):
        def run(*a, **k):
            k_ = "topology lnL" if key == "lnL" and any(inside) else key
            inside.append(key == "topology")
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                inside.pop()
                got = rec.setdefault(k_, [0, 0.0])
                got[0] += 1
                got[1] += time.perf_counter() - t
        return run

    def seq_fn_factory(engine, params):
        rec["seq_system"] = (engine, engine.system_of(params))
        return timed_fn(make_seq(engine, params), "seq lnL")

    def run_phyrex(*a, **k):
        rec["at_start"].append(launch_counts())
        rec["results"].append(real_run(*a, **k))
        return rec["results"][-1]

    saved = [(MCMC, "_lnL", MCMC._lnL),
             (MCMC, "topology_step", MCMC.topology_step),
             (MCMC, "run", MCMC.run),
             (traits, "location_loglik", traits.location_loglik),
             (slfv.SLFVJointSampler, "sweep", slfv.SLFVJointSampler.sweep),
             (slfv, "make_seq_loglik_fn", slfv.make_seq_loglik_fn),
             (phyrex, "run_phyrex", phyrex.run_phyrex)]
    make_seq, real_run = slfv.make_seq_loglik_fn, phyrex.run_phyrex
    MCMC._lnL = timed_fn(MCMC._lnL, "lnL")
    MCMC.topology_step = timed_fn(MCMC.topology_step, "topology")
    MCMC.run = timed_fn(MCMC.run, "run")
    traits.location_loglik = timed_fn(traits.location_loglik, "location")
    slfv.SLFVJointSampler.sweep = timed_fn(slfv.SLFVJointSampler.sweep,
                                           "sweep")
    slfv.make_seq_loglik_fn = seq_fn_factory
    phyrex.run_phyrex = run_phyrex
    try:
        yield rec
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


def phyrex_outputs(tag, prefix, names, rows, slfv):
    """The trace (its header, `rows` rows of finite numbers, the MCMC
    chain's ESS line), the stats (the PhyREX summary) and the
    chronogram (every taxon, finite non-negative durations) parse."""
    from phyml_tpu_torch.io.newick import parse_newick

    with open(prefix + "_phyml_trace.txt") as fh:
        lines = fh.read().splitlines()
    head = ("sweep\tposterior\tlbda\tmu\trad\tn_disks\troot_height\tclock"
            if slfv else "iter\tposterior\tlnL\troot_height\tclock\tnu")
    if lines[0] != head:
        fail(f"[{tag}] trace header {lines[0]!r}")
    got = [[float(x) for x in ln.split("\t")] for ln in lines[1:]
           if not ln.startswith("#")]
    if len(got) != rows or not np.isfinite(got).all() or not (
            slfv or any(ln.startswith("# ESS:") for ln in lines)):
        fail(f"[{tag}] the trace does not parse: {len(got)} rows")
    with open(prefix + "_phyml_stats.txt") as fh:
        stats = fh.read()
    if "PhyREX" not in stats or "root location" not in stats:
        fail(f"[{tag}] the stats file lacks the PhyREX summary")
    with open(prefix + "_chronogram.txt") as fh:
        root = parse_newick(fh.read().strip())
    leaves, lengths, stack = [], [], [root]
    while stack:
        nd = stack.pop()
        stack += nd.children
        if nd.is_leaf:
            leaves.append(nd.name)
        if nd is not root:
            lengths.append(nd.length)
    if sorted(leaves) != sorted(names) or not all(
            x is not None and math.isfinite(x) and x >= 0 for x in lengths):
        fail(f"[{tag}] the chronogram does not parse to the taxa with "
             "finite non-negative durations")


def slfv_kernel_row(cell, res, seq_system, launches):
    """K1 at the SLFV sampler's final state (its collapsed tree, the
    strict clock's branch lengths, the sequence term's engine and
    system) against its plain version, timed, with its bound; launches
    are the run's."""
    import torch
    from phyml_tpu_torch.bayes.slfv import state_to_timetree
    from phyml_tpu_torch.ops import clv_slots

    smp = res.sampler
    eng, (lam, V, Vinv, pi, w, _) = seq_system
    tt = state_to_timetree(smp.state)
    dt = tt.edge_durations()
    blen = np.maximum(smp.clock * dt, 1e-10)
    blen[tt.root] = 0.0
    pm = eng._pmats(lam, V, Vinv, torch.as_tensor(
        blen, dtype=eng.dtype, device=eng.device))
    _, sched, n_slots = eng._topology(torch.as_tensor(
        tt.child.astype(np.int32)))
    args = (sched, eng.slot_tips, pm, pi, eng._logw(w))
    fn = wrappers()[eng.lnl_route]
    ref, pms = timed(lambda: clv_slots.uppass_site_lse_slots_plain(
        *args, n_slots=n_slots), 1)
    out, ms = timed(lambda: fn(*args, n_slots=n_slots))
    err = float((out - ref).abs().max())
    n, C, ns, k = eng.n_otu, eng.C, eng.ns, eng.P
    b_ms, b_by = bound(pruning_flops(n, C, ns, k),
                       nbytes(sched, eng.tips, pm, pi, args[4]) + k * 4)
    kname = eng.lnl_route
    print(f". [{cell}] {kname} {fn.__name__} at the SLFV sampler's final "
          f"tree: max|d|={err:.3e} (tol {site_tol('nt', ns):g})  kernel "
          f"{ms:.4f} ms  plain {pms:.3f} ms  bound {b_ms:.4f} ms ({b_by})  "
          f"launches {launches}")
    if not err <= site_tol("nt", ns):
        fail(f"[{cell}] {kname} disagrees with its plain version at the "
             f"SLFV sampler's final tree: {err}")
    return dict(name=f"{kname} {fn.__name__} [{cell}]", route="cuda",
                source=f"phyml_tpu_torch/csrc/{SOURCE[kname]}",
                replaces=TPU_KERNEL[kname], launches=launches,
                max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, ns=ns, path="nt", cell=cell,
                launches_from="the phyrex slfv run")


def phyrex_run(label, d, cuda):
    """One <phyrex> XML run through run_xml on the card (PHYREX_RUNS) on
    the relabelled DNA problem, with every launch counter set to 0 just
    before and read just after, the chain's lnL evaluations, location
    terms, topology proposals and SLFV sweeps counted and timed, the
    card's idle share and peak memory.  Checks every posterior lnL ran
    on K1 (K2 only before the chain: the start chronogram), K3 never,
    the outputs, finite ancestral locations and feasible heights.
    Returns (counts, result, numbers, the SLFV sequence term's
    (engine, system) or None)."""
    import torch
    from phyml_tpu_torch.io.xmlcfg import run_xml

    spatial, lineagerates, topo_moves, cap = PHYREX_RUNS[label]
    tag = f"phyrex {label}"
    aln, tree, coords, _ = phyrex_problem(d, N_TAXA, N_SITES, SEED)
    names = read_phylip_rows(aln)[0]
    xml = os.path.join(d, "phyrex.xml")
    phyrex_xml(xml, os.path.basename(aln), tree, os.path.basename(coords),
               spatial, lineagerates, topo_moves)
    reset_counts()
    with phyrex_probes() as rec, utilization_sampler() as util:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.time()
        rc = run_xml(xml, quiet=True, device=cuda, mcmc_iter_cap=cap)
        torch.cuda.synchronize()
        wall = time.time() - t1
    counts = launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    busy = statistics.mean(util) if util else None
    if rc != 0:
        fail(f"[{tag}] run_xml returned {rc}")
    res, at_start = rec["results"][0], rec["at_start"][0]
    slfv = spatial is None
    n_lnl, lnl_s = rec.get("seq lnL" if slfv else "lnL", (0, 0.0))
    n_loc, loc_s = rec.get("location", (0, 0.0))
    n_topo, topo_s = rec.get("topology", (0, 0.0))
    n_tlnl, tlnl_s = rec.get("topology lnL", (0, 0.0))
    steps = res.summary["n_iter"]
    chain_s = rec["sweep"][1] if slfv else rec["run"][1]
    chain_k1 = counts["K1"] - at_start["K1"]
    num = dict(
        n_taxa=len(names), iterations=steps, unit="sweep" if slfv else
        "iteration", wall_s=wall, chain_s=chain_s, setup_s=wall - chain_s,
        ms_per_step=1e3 * chain_s / steps, lnl_evaluations=n_lnl + n_tlnl,
        lnl_ms=1e3 * (lnl_s + tlnl_s) / max(1, n_lnl + n_tlnl),
        location_terms=n_loc, location_ms=1e3 * loc_s / max(1, n_loc),
        host_ms_per_step=1e3 * (chain_s - lnl_s - topo_s) / steps,
        launches=counts, launches_before_chain=at_start,
        k1_launches_per_step=chain_k1 / steps,
        idle_share=None if busy is None else 1 - busy,
        nvml_samples=len(util), peak_gib=peak,
        final_posterior=float(res.summary["posterior_final"]),
        final_lnl=float(res.summary["lnL_final"]),
        sigma2=float(res.sigma2), clock=float(res.summary["clock_rate"]),
        root_location=res.summary["root_location"])
    if slfv:
        smp = res.sampler
        num.update(n_disks=int(smp.state.n_disks), lbda=smp.params.lbda,
                   mu=smp.params.mu, rad=smp.params.rad,
                   accepts=dict(smp.accepts), tries=dict(smp.tries))
    else:
        mcmc = res.sampler
        num.update(topology_tries=mcmc.topo_tries,
                   topology_accepts=mcmc.topo_accepts,
                   topology_ms=1e3 * topo_s / max(1, n_topo),
                   mala_weight=float(mcmc.move_w[-1]),
                   ess={k: float(v) for k, v in mcmc.ess.items()})
        if res.velocity_samples is not None:
            num.update(velocity_ess=res.summary["velocity_ess"],
                       velocity_draws=res.summary["n_velocity_samples"])
    print(f". [{tag}] {len(names)} taxa, {steps} {num['unit']}s: wall "
          f"{wall:.2f} s (chain {chain_s:.2f} s, {num['ms_per_step']:.3f} ms "
          f"a {num['unit']}; set-up {wall - chain_s:.2f} s); "
          f"{num['lnl_evaluations']} sequence lnL evaluations x "
          f"{num['lnl_ms']:.3f} ms (with the read-back); {n_loc} location "
          f"terms x {num['location_ms']:.3f} ms (host); host "
          f"{num['host_ms_per_step']:.3f} ms a {num['unit']}; K1 "
          f"{num['k1_launches_per_step']:.3f} launches a {num['unit']}; "
          "idle share " + ("not measured" if busy is None else
                           f"{1 - busy:.3f}")
          + f"; peak {peak:.3f} GiB; launches {counts} ({at_start} before "
          "the chain)")
    print(f". [{tag}] final posterior {num['final_posterior']:.4f}, lnL "
          f"{num['final_lnl']:.4f}, sigma^2 {num['sigma2']:.6g}, clock "
          f"{num['clock']:.6g}, root location {num['root_location']}")
    if not (math.isfinite(num["final_posterior"])
            and math.isfinite(num["final_lnl"])):
        fail(f"[{tag}] the final posterior or lnL is not finite")
    if counts["K3"] != 0 or any(counts[k] for k in ("K4", "K5")):
        fail(f"[{tag}] a kernel off the DNA route or K3 launched: {counts}")
    if counts["K2"] != at_start["K2"] or at_start["K2"] <= 0:
        fail(f"[{tag}] K2 launched {counts['K2'] - at_start['K2']} times "
             f"in the chain (the start chronogram's {at_start['K2']})")
    if chain_k1 < num["lnl_evaluations"] or num["lnl_evaluations"] <= 0:
        fail(f"[{tag}] {num['lnl_evaluations']} lnL evaluations but "
             f"{chain_k1} K1 launches in the chain")
    if not slfv and num["mala_weight"] != 0.0:
        fail(f"[{tag}] MALA has weight {num['mala_weight']} on the card")
    if topo_moves and not slfv and res.sampler.topo_tries == 0:
        fail(f"[{tag}] no topology move was tried")
    if not np.isfinite(res.anc_locations).all():
        fail(f"[{tag}] the ancestral locations are not finite")
    if slfv:
        s = res.state
        kids = np.nonzero(s.parent >= 0)[0]
        gap = float((s.h_node[s.parent[kids]] - s.h_node[kids]).min())
        if not gap > 0:
            fail(f"[{tag}] an ldsk is older than its parent ({gap})")
        num["min_duration"] = gap
    else:
        num["min_duration"] = chain_state_checks(tag, res, [])
    thin = max(1, steps // 200) if slfv else 50
    phyrex_outputs(tag, os.path.join(d, "out_phyrex"), names,
                   -(-steps // thin), slfv)
    return counts, res, num, rec.get("seq_system")


def phyrex_phase(tmp, cuda):
    """The three <phyrex> runs at full width (PHYREX_RUNS), each on its
    own copy of the problem, and K1's rows at each run's final state.
    Returns (numbers by run, kernel rows)."""
    import torch

    runs, rows = {}, []
    t0 = time.time()
    for label in PHYREX_RUNS:
        counts, res, runs[label], seq_system = phyrex_run(
            label, os.path.join(tmp, f"phyrex_{label}"), cuda)
        cell = f"phyrex-{label}"
        launches = counts["K1"] - runs[label]["launches_before_chain"]["K1"]
        if label == "slfv":
            rows.append(slfv_kernel_row(cell, res, seq_system, launches))
        else:
            rows.append(chain_kernel_row(
                label, cell, res.sampler, res.state, "nt", launches,
                mgf=res.sampler.rate_model.kind == "guindon"))
        del res
        torch.cuda.empty_cache()
    runs["wall_s"] = time.time() - t0
    print(f". [phyrex] phase wall {runs['wall_s']:.1f} s")
    return runs, rows


def phyrex_side(d, platform):
    """The 16 x 500 PhyREX check's side on one platform: the start
    chronogram of an rrw <phyrex> run (the user tree's branch lengths
    fitted) and, on the card, the final states of a 500-iteration rrw
    chain, a 500-iteration ibm chain and 50 SLFV sweeps; and
    GeoModel.loglik at three labelings on the simulating tree (the CPU
    side too)."""
    import torch
    from phyml_tpu_torch.bayes.chrono import TimeTree
    from phyml_tpu_torch.bayes.geo import GeoModel
    from phyml_tpu_torch.bayes.mcmc import MCMCSettings
    from phyml_tpu_torch.bayes.phyrex import run_phyrex
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.models.substitution import SubstModel
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.optim.blen import optimize_branch_lengths
    from phyml_tpu_torch.search.nni import _host_blen
    from phyml_tpu_torch.topology import Topology

    device = torch.device("cuda" if platform == "gpu" else "cpu")
    dtype = torch.float32 if platform == "gpu" else torch.float64
    aln_path, tree_path, _, x = phyrex_problem(d, 16, 500, SEED + 1)
    aln = read_alignment(aln_path, datatype="nt")
    names = list(aln.names)
    model = SubstModel(datatype="nt", name="GTR", n_classes=4)
    params = model.init_params(aln.obs_state_freqs)
    eng = LikelihoodEngine(aln, model, dtype=dtype, device=device)
    with open(tree_path) as fh:
        topo = Topology.from_newick(fh.read(), names)
    sim_tree = TimeTree.from_topology(topo.copy(), names=names)
    rv = topo.rooted()
    ta, _ = optimize_branch_lengths(eng, params, tree_arrays(
        rv, dtype=dtype, device=device))
    topo.set_blen_from_rooted(rv, _host_blen(ta))
    tt = TimeTree.from_topology(topo, names=names)
    out = dict(dir=d, child=tt.child, heights=tt.heights, coords=x)
    if platform == "gpu":
        for kind in ("rrw", "ibm", "slfv"):
            res = run_phyrex(aln, x, tt, model=model, trait_kind=kind,
                             settings=MCMCSettings(n_iter=500, burnin=250,
                                                   batch=250, seed=3),
                             engine=eng)
            if kind == "slfv":
                smp = res.sampler
                s = smp.state
                out[kind] = dict(
                    state={f: getattr(s, f) for f in (
                        "n_otu", "coord", "h_node", "parent", "h_disk",
                        "centr", "hit")},
                    params=dict(vars(smp.params)), clock=smp.clock,
                    lp=smp.lp, seq_lnl=smp.seq_lnl)
            else:
                st = res.state
                out[kind] = {k: ({k2: v2.numpy() for k2, v2 in v.items()}
                                 if isinstance(v, dict) else v.numpy())
                             for k, v in st._asdict().items()}
    rng = np.random.default_rng(SEED + 2)
    land = rng.uniform(0.0, 10.0, size=(6, 2))
    geo = GeoModel(land, sim_tree, rng.integers(0, 6, size=16),
                   device=device)
    out["geo"] = [float(geo.loglik(geo.init_locations(rng), s, lb, ta))
                  for s, lb, ta in ((1.0, 1.0, 1.0), (2.0, 0.4, 0.8),
                                    (0.7, 1.5, 1.2))]
    return out


def report_phyrex(gpu, cpu):
    """The 16 x 500 PhyREX check: the same start chronogram (heights
    within HEIGHT_TOL); at each card chain's final state a CPU float64
    chain's lnL (within F64_TOL) and log prior, the location term
    included (within PRIOR_REL); the SLFV sampler's posterior at its
    final state against a CPU recompute (_loglik_np + the parameter
    prior + the float64 sequence lnL, within F64_TOL); GeoModel.loglik
    card against CPU within GEO_REL."""
    import torch
    from phyml_tpu_torch.bayes.chrono import TimeTree
    from phyml_tpu_torch.bayes.mcmc import MCMC, MCMCSettings
    from phyml_tpu_torch.bayes.rates import RateModel
    from phyml_tpu_torch.bayes.slfv import (
        SLFVJointSampler, _loglik_np, make_seq_loglik_fn,
    )
    from phyml_tpu_torch.bayes.times import TimePrior
    from phyml_tpu_torch.interop import (
        chain_state_from_numpy, slfv_params_from_numpy,
        slfv_state_from_numpy,
    )
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.models.substitution import SubstModel
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine

    (g, g_s), (c, c_s) = gpu, cpu
    same_tree = np.array_equal(g["child"], c["child"])
    dh = float(np.abs(g["heights"] - c["heights"]).max())
    aln = read_alignment(os.path.join(g["dir"], "aln.phy"), datatype="nt")
    model = SubstModel(datatype="nt", name="GTR", n_classes=4)
    params = model.init_params(aln.obs_state_freqs)
    eng = LikelihoodEngine(aln, model, dtype=torch.float64, device="cpu")
    tt = TimeTree(n_otu=16, child=g["child"], heights=g["heights"],
                  names=list(aln.names))
    gaps = {}
    for kind in ("rrw", "ibm"):
        mcmc = MCMC(eng, model, params, tt, RateModel(kind="lognormal"),
                    TimePrior(kind="coalescent"), MCMCSettings(seed=3),
                    trait_x=g["coords"], trait_kind=kind)
        s = g[kind]
        st = chain_state_from_numpy(s)
        gaps[kind] = (float(s["lnL"]) - float(mcmc._lnL(st)),
                      float(s["lp"]) - float(mcmc._log_prior(st)),
                      float(s["lp"]))
    sl = g["slfv"]
    state = slfv_state_from_numpy(sl["state"])
    p = slfv_params_from_numpy(sl["params"])
    seq = make_seq_loglik_fn(eng, params)(state, sl["clock"])
    lp_cpu = _loglik_np(state, p) + SLFVJointSampler._lprior(p) + seq
    gaps["slfv"] = (sl["seq_lnl"] - seq, sl["lp"] - lp_cpu, sl["lp"])
    geo_gap = max(abs(a - b) / max(1.0, abs(b))
                  for a, b in zip(g["geo"], c["geo"]))
    print(f". [small] phyrex: start chronogram card against CPU: same "
          f"topology {same_tree}, heights max|d| {dh:.2e} (tol "
          f"{HEIGHT_TOL:g}); card lnL - CPU f64 at the final states: "
          + ", ".join(f"{k} {v[0]:.3e}" for k, v in gaps.items())
          + f" (tol {F64_TOL}); log prior (rrw, ibm) / SLFV posterior: "
          + ", ".join(f"{k} {v[1]:.2e}" for k, v in gaps.items())
          + f"; GeoModel.loglik relative gap {geo_gap:.2e} (tol {GEO_REL:g})"
          f" ({g_s:.1f} s card, {c_s:.1f} s CPU)")
    if not (same_tree and dh <= HEIGHT_TOL):
        fail("small phyrex: the start chronograms differ")
    for kind, (dl, dp, lp) in gaps.items():
        ok_p = (abs(dp) <= F64_TOL if kind == "slfv"
                else abs(dp) <= PRIOR_REL * max(1.0, abs(lp)))
        if not (abs(dl) <= F64_TOL and ok_p):
            fail(f"small phyrex: the card's {kind} final state off the "
                 f"CPU's recompute: lnL {dl}, log prior/posterior {dp}")
    if not geo_gap <= GEO_REL:
        fail(f"small phyrex: GeoModel.loglik card against CPU {geo_gap}")
    return dict(height_gap=dh, lnl_gaps={k: v[0] for k, v in gaps.items()},
                prior_gaps={k: v[1] for k, v in gaps.items()},
                geo_rel_gap=geo_gap, gpu_s=g_s, cpu_s=c_s)


# ---------------------------------------------------------------------------
# --distributed: the site-sharded engine and the farmed bootstrap
# ---------------------------------------------------------------------------

DIST_RANKS = 2          # ranks on the one card (gloo: NCCL refuses two
#                         ranks on one device)
FARM_REPLICATES = 4     # -b 4 farmed over the ranks: 2 replicates a rank
DIST_TIMEOUT_S = 420    # the ranks' world, killed past this


def farm_run(argv):
    """One CLI run in a rank, its launch counters set to 0 just before and
    read just after: {rc, wall_s, launches, k3_by_batch}."""
    import torch
    from phyml_tpu_torch import cli

    reset_counts()
    torch.cuda.synchronize()
    t = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    return dict(rc=rc, wall_s=time.time() - t,
                launches=launch_counts(),
                k3_by_batch=launches_by("K3", "batch"))


def sharded_checks(spec, rank, world):
    """In every rank: the 1 x world sharded engine at full width against
    the unsharded one on the same card.  The launch counters are set to 0
    just before the sharded path (gathered site lnL, host lnL, one
    branch-length round) and read just after; then K3 at B = 1 on the
    full pattern axis against the gathered site lnL, the host lnL (K1)
    and the unsharded round, the ms of a sharded lnL (both ranks at once,
    the all_reduce included) and of one all_reduce; rank 0 alone (the
    other waiting) times the unsharded lnL and K3 at B = 1 on its shard
    against its plain version."""
    import torch
    import torch.distributed as dist
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.models.substitution import SubstModel
    from phyml_tpu_torch.ops import clv
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.optim.blen import optimize_branch_lengths
    from phyml_tpu_torch.parallel.mesh import make_mesh, sharded_engine
    from phyml_tpu_torch.topology import Topology

    cuda = torch.device("cuda")
    aln = read_alignment(spec["aln"], datatype="nt")
    model = SubstModel(datatype="nt", name="GTR", n_classes=4)
    params = true_params("nt", model.init_params(aln.obs_state_freqs))
    with open(spec["tree"]) as fh:
        topo = Topology.from_newick(fh.read(), aln.names)
    tree = tree_arrays(topo.rooted(), device=cuda)
    mesh = make_mesh(1, world)
    seng = sharded_engine(aln, model, mesh, device=cuda)
    ueng = LikelihoodEngine(aln, model, device=cuda)

    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    site = seng.site_logliks(params, tree)
    lnl_s = float(seng.loglik(params, tree))
    _, round_s = optimize_branch_lengths(seng, params, tree, max_rounds=1)
    torch.cuda.synchronize()
    out = dict(launches=launch_counts(),
               k3_by_batch=launches_by("K3", "batch"),
               P=seng.n_patterns, P_padded=seng.n_padded, P_local=seng.P,
               lnl_sharded=lnl_s, round_sharded=round_s)

    sys_ = ueng.system_of(params)
    child, sched, n_slots = ueng._topology(tree.child)
    pm = ueng._pmats_cached(sys_, tree)
    lse = clv.uppass_site_lse(child, ueng.tips, pm, sys_[3],
                              ueng._logw(sys_[4]), sched=sched,
                              n_slots=n_slots)
    out["site_max_abs_diff"] = float((site - lse).abs().max())
    out["lnl_unsharded"] = float(ueng.loglik(params, tree))
    out["round_unsharded"] = optimize_branch_lengths(
        ueng, params, tree, max_rounds=1)[1]
    _, out["ms_sharded_lnl"] = timed(lambda: seng.loglik(params, tree))
    zero = torch.zeros((), dtype=torch.float64, device=cuda)
    _, out["ms_all_reduce"] = timed(lambda: seng._sum_sites(zero))
    dist.barrier()
    if rank == 0:
        _, out["ms_unsharded_lnl"] = timed(lambda: ueng.loglik(params, tree))
        ssys = seng.system_of(params)
        schild, ssched, sn = seng._topology(tree.child)
        spm = seng._pmats_cached(ssys, tree)
        args = (schild, seng.tips, spm, ssys[3], seng._logw(ssys[4]))
        got, ms = timed(lambda: clv.uppass_site_lse(*args, sched=ssched,
                                                    n_slots=sn))
        ref, pms = timed(lambda: clv.uppass_site_lse_plain(
            schild, seng.tips, spm[None], ssys[3][None],
            seng._logw(ssys[4])[None])[0], 1)
        b_ms, b_by = bound(pruning_flops(aln.n_otu, 4, 4, seng.P),
                           nbytes(ssched, *args[1:]) + seng.P * 4)
        out["k3_shard"] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                               bound_by=b_by,
                               max_abs_err=float((got - ref).abs().max()))
    torch.cuda.synchronize()
    dist.barrier()
    return out


def rank_worker(spec_path) -> int:
    """One rank of the distributed phase (`torchrun ... chip_smoke.py
    --rank-worker spec.json`): join the group from torchrun's
    environment, run the sharded checks, the farmed bootstrap on the
    final 128 x 4096 tree and the 16 x 500 one, and write the results to
    spec["out"].<rank>.json."""
    import torch
    import torch.distributed as dist
    from phyml_tpu_torch.parallel.boot import initialize_distributed

    with open(spec_path) as fh:
        spec = json.load(fh)
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = initialize_distributed()
    try:
        out = dict(rank=rank, world=world, backend=dist.get_backend(),
                   device=torch.cuda.current_device())
        out["sharded"] = sharded_checks(spec, rank, world)
        out["farm"] = farm_run(support_argv(
            "nt", spec["aln"], spec["tree"], "gpu", FARM_REPLICATES,
            "--distributed", "--quiet"))
        small = default_argv("nt", spec["small"], "gpu") + [
            "--distributed", "--quiet"]
        small[small.index("-b") + 1] = str(FARM_REPLICATES)
        out["small"] = farm_run(small)
    finally:
        dist.destroy_process_group()
    with open(f"{spec['out']}.{rank}.json", "w") as fh:
        json.dump(out, fh)
    return 0


def distributed_phase(tmp, cuda):
    """--distributed on the card: DIST_RANKS ranks on the one card (gloo),
    launched with torchrun after the kernels are built (rank_worker),
    each on a copy of the DNA problem and the default run's final tree.
    Checks: the sharded engine's site lnL against the unsharded K3 at
    B = 1 (SITE_TOL), its lnL against the host lnL (F64_TOL), one
    branch-length round against the unsharded one (E2E_TOL), K3 at B = 1
    launched on every rank and K1 never by the sharded path; the farmed
    `-u final -o lr -b 4` with supports in [0, 4]; and at 16 x 500 the
    farmed default run with `-b 4` equal, count for count, to the
    single-process `-b 4` on the card.  Returns (numbers, K3 per shard
    row)."""
    import shutil
    import signal

    import torch
    from phyml_tpu_torch import cli

    t0 = time.time()
    d = os.path.join(tmp, "dist")
    os.makedirs(d)
    for name in ("aln.phy", "final_tree.nwk"):
        shutil.copy(os.path.join(tmp, "nt", name), os.path.join(d, name))
    aln_path = os.path.join(d, "aln.phy")
    small = {tag: write_problem(os.path.join(tmp, f"dist_small_{tag}"),
                                "nt", 16, 500, SEED + 2)[0]
             for tag in ("single", "farmed")}
    argv = default_argv("nt", small["single"], "gpu") + ["--quiet"]
    argv[argv.index("-b") + 1] = str(FARM_REPLICATES)
    t = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv)
    single_s = time.time() - t
    if rc != 0:
        fail(f"the 16 x 500 -b {FARM_REPLICATES} run returned {rc}")

    spec_path = os.path.join(d, "spec.json")
    spec = dict(aln=aln_path, tree=os.path.join(d, "final_tree.nwk"),
                small=small["farmed"], out=os.path.join(d, "rank"))
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(DIST_RANKS), os.path.abspath(__file__),
           "--rank-worker", spec_path]
    log_path = os.path.join(d, "ranks.log")
    t = time.time()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=DIST_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    world_s = time.time() - t
    if rc != 0:
        with open(log_path) as fh:
            sys.stderr.write(fh.read()[-6000:])
        fail(f"the {DIST_RANKS}-rank world ended with {rc}")
    res = []
    for r in range(DIST_RANKS):
        with open(f"{spec['out']}.{r}.json") as fh:
            res.append(json.load(fh))

    names = [f"T{i:04d}" for i in range(16)]
    labels = {tag: tree_labels(f"{small[tag]}_phyml_tree.txt", names)
              for tag in small}
    big_names = [f"T{i:04d}" for i in range(N_TAXA)]
    vals = np.asarray([int(v) for v in tree_labels(
        f"{aln_path}_phyml_tree.txt", big_names).values()])
    sh = [x["sharded"] for x in res]
    k3 = sh[0]["k3_shard"]
    out = dict(
        ranks=DIST_RANKS, backend=res[0]["backend"],
        devices=[x["device"] for x in res], world_wall_s=world_s,
        P=sh[0]["P"], P_padded=sh[0]["P_padded"], P_local=sh[0]["P_local"],
        site_max_abs_diff=max(x["site_max_abs_diff"] for x in sh),
        lnl_sharded=sh[0]["lnl_sharded"],
        lnl_unsharded=sh[0]["lnl_unsharded"],
        round_sharded=sh[0]["round_sharded"],
        round_unsharded=sh[0]["round_unsharded"],
        ms_sharded_lnl=[x["ms_sharded_lnl"] for x in sh],
        ms_all_reduce=[x["ms_all_reduce"] for x in sh],
        ms_unsharded_lnl=sh[0]["ms_unsharded_lnl"],
        sharded_launches=[x["launches"] for x in sh],
        sharded_k3_by_batch=[x["k3_by_batch"] for x in sh],
        farm=dict(replicates=FARM_REPLICATES,
                  wall_s=[x["farm"]["wall_s"] for x in res],
                  launches=[x["farm"]["launches"] for x in res],
                  supports_min=int(vals.min()), supports_max=int(vals.max())),
        small_farm=dict(single_wall_s=single_s,
                        farmed_wall_s=[x["small"]["wall_s"] for x in res],
                        counts_equal=labels["farmed"] == labels["single"],
                        single=sorted(labels["single"].values()),
                        farmed=sorted(labels["farmed"].values())))
    print(f". [dist] {DIST_RANKS} ranks ({out['backend']}, devices "
          f"{out['devices']}), world {world_s:.1f} s; 128 x 4096: "
          f"{out['P']} patterns padded to {out['P_padded']}, "
          f"{out['P_local']} a rank")
    print(f". [dist] sharded site lnL vs unsharded K3 B=1: max|d|="
          f"{out['site_max_abs_diff']:.3e} (tol {SITE_TOL['nt']:g}); lnL "
          f"{out['lnl_sharded']:.6f} vs host {out['lnl_unsharded']:.6f} "
          f"(tol {F64_TOL:g}); one round {out['round_sharded']:.6f} vs "
          f"{out['round_unsharded']:.6f} (tol {E2E_TOL:g})")
    print(f". [dist] ms a sharded lnL {out['ms_sharded_lnl']} (all_reduce "
          f"alone {out['ms_all_reduce']}), unsharded {out['ms_unsharded_lnl']:.4f}"
          f"; sharded launches {out['sharded_launches']}, K3 by batch "
          f"{out['sharded_k3_by_batch']}")
    print(f". [dist] farmed -u final -o lr -b {FARM_REPLICATES}: wall "
          f"{out['farm']['wall_s']} s, launches {out['farm']['launches']}, "
          f"supports {out['farm']['supports_min']}..."
          f"{out['farm']['supports_max']}")
    print(f". [dist] 16 x 500 -b {FARM_REPLICATES}: single {single_s:.1f} s, "
          f"farmed {out['small_farm']['farmed_wall_s']} s, counts equal "
          f"{out['small_farm']['counts_equal']} ({out['small_farm']['single']}"
          f" / {out['small_farm']['farmed']})")
    if not out["site_max_abs_diff"] <= SITE_TOL["nt"]:
        fail("the sharded site lnL disagrees with the unsharded K3")
    if not abs(out["lnl_sharded"] - out["lnl_unsharded"]) <= F64_TOL:
        fail("the sharded lnL disagrees with the host lnL")
    if not abs(out["round_sharded"] - out["round_unsharded"]) <= E2E_TOL:
        fail("the sharded branch-length round disagrees with the unsharded")
    for r, (c, kb) in enumerate(zip(out["sharded_launches"],
                                    out["sharded_k3_by_batch"])):
        if not kb.get("1", 0) or c["K1"] or c["K4"] or not c["K2"]:
            fail(f"rank {r}: the sharded path launched {c} (K3 by batch "
                 f"{kb}): K3 at B = 1 and K2 expected, K1 and K4 never")
    if not k3["max_abs_err"] <= SITE_TOL["nt"]:
        fail(f"K3 on the shard disagrees with its plain version: "
             f"{k3['max_abs_err']}")
    if any(x["farm"]["rc"] or x["small"]["rc"] for x in res):
        fail("a rank's farmed CLI run returned nonzero")
    if len(vals) != N_TAXA - 3 or vals.min() < 0 or \
            vals.max() > FARM_REPLICATES:
        fail(f"farmed supports outside [0, {FARM_REPLICATES}]")
    if not out["small_farm"]["counts_equal"]:
        fail("the farmed 16 x 500 counts differ from the single process's")
    out["wall_s"] = time.time() - t0
    print(f". [dist] phase wall {out['wall_s']:.1f} s")
    row = dict(
        name="K3 uppass_site_lse (B=1, per shard)", route="cuda",
        source=f"phyml_tpu_torch/csrc/{SOURCE['K3']}",
        replaces=TPU_KERNEL["K3"],
        launches=out["sharded_k3_by_batch"][0]["1"],
        launches_per_rank=[kb["1"] for kb in out["sharded_k3_by_batch"]],
        max_abs_err=k3["max_abs_err"], ms=k3["ms"], plain_ms=k3["plain_ms"],
        bound_ms=k3["bound_ms"], bound_by=k3["bound_by"], library_ms=None,
        ns=4, path="nt", B=1, P_local=out["P_local"], cell="distributed")
    return out, row


# K6 (ops/newton.py, csrc/edge_newton.cu) at the benchmark cells' shapes
# and the default run's SPR scorer's
NEWTON_CELLS = ("nt120x10240.abayes", "aa120x10240.abayes")
NEWTON_SEED = 2026101820
# K6 held to the plain version as tests/test_torch_newton.py holds it
# (reasons there): each row's float64 lnL at K6's length within
# NEWTON_LNL_TOL of its |lnL| plus NEWTON_SLOPE_LEN of |t dlnL/dt| (at
# the float64 plain version's length) of that at the float32 plain
# version's; the median relative gap of the lengths to that version's at
# most NEWTON_LEN_TOL; the median and 99th percentile of the lengths'
# gaps to the float64 plain version's within NEWTON_F64_TIMES of the
# float32 plain version's; rows under a False mask keep t0 exactly
NEWTON_LNL_TOL = 1e-8
NEWTON_SLOPE_LEN = 1e-3
NEWTON_LEN_TOL = 1e-5
NEWTON_F64_TIMES = 4.0
# K6's time at the NNI shapes at most this many times its bound
NEWTON_OF_BOUND = 3.0


def newton_check(eng, name, solves):
    """Hold K6's lengths to the plain version's, float32 and float64,
    over every solve in `solves` [(d, sc, aux, t, iters, mask, got)];
    fail() when they are off.  Returns the readings."""
    import torch
    from phyml_tpu_torch.ops import newton

    rel, lnl_over, to64 = [], 0.0, ([], [])
    for d, sc, aux, t, iters, mask, got in solves:
        plain = newton.solve_plain(eng, d, sc, aux, t, iters, mask)
        d64, sc64 = d.double(), sc.double()
        aux64 = {k: v.double() for k, v in aux.items()}
        exact = newton.solve_plain(eng, d64, sc64, aux64, t.double(), iters,
                                   mask)
        if mask is not None:
            keep = ~mask.expand(t.shape)
            if not torch.equal(got[keep], t[keep]):
                fail(f"[{name}] K6 moved lengths that its row mask keeps")
        lnl_k, lnl_p = (eng.edge_lnl_terms(d64, sc64, aux64, x.double())[0]
                        for x in (got, plain))
        lnl_x, d1_x, _ = eng.edge_lnl_terms(d64, sc64, aux64, exact)
        tol = (NEWTON_LNL_TOL * lnl_x.abs()
               + NEWTON_SLOPE_LEN * (exact * d1_x).abs())
        lnl_over = max(lnl_over, float(((lnl_k - lnl_p).abs() / tol).max()))
        rel.append(((got.double() - plain.double()).abs()
                    / plain.double().abs()).flatten())
        for out, x in zip(to64, (got, plain)):
            out.append(((x.double() - exact).abs() / exact).flatten())
        del d64, sc64, aux64, exact, plain
    rel = torch.cat(rel)
    q = torch.tensor([0.5, 0.99], dtype=torch.float64, device=rel.device)
    qk, qp = (torch.quantile(torch.cat(x), q).tolist() for x in to64)
    res = dict(max_rel_gap=float(rel.max()),
               median_rel_gap=float(rel.median()), lnl_over=lnl_over,
               to_f64_median=[qk[0], qp[0]], to_f64_p99=[qk[1], qp[1]])
    print(f"  K6 [{name}] against the plain version over {rel.numel()} "
          f"rows: lengths max {res['max_rel_gap']:.3e} median "
          f"{res['median_rel_gap']:.3e} (tol {NEWTON_LEN_TOL:g}); lnL "
          f"gap at most {lnl_over:.3e} of its tolerance; to "
          f"float64, median / 99th percentile K6 {qk[0]:.3e} / "
          f"{qk[1]:.3e}, float32 plain {qp[0]:.3e} / {qp[1]:.3e} (K6 "
          f"within {NEWTON_F64_TIMES:g}x)")
    if not lnl_over <= 1.0:
        fail(f"[{name}] K6's lengths lose {lnl_over:.3g} times the lnL "
             "tolerance against the plain version's")
    if not res["median_rel_gap"] <= NEWTON_LEN_TOL:
        fail(f"[{name}] K6's lengths are off the plain version's by a "
             f"median {res['median_rel_gap']:.3e}")
    if not (qk[0] <= NEWTON_F64_TIMES * qp[0]
            and qk[1] <= NEWTON_F64_TIMES * qp[1]):
        fail(f"[{name}] K6's lengths are further from float64 than the "
             f"float32 plain version's: {qk} against {qp}")
    return res


def captured_solves(eng, run):
    """The newton_solve calls `run()` makes on `eng`, each with its
    result: [(d, sc, aux, t, iters, mask, got)]."""
    calls, real = [], eng.newton_solve

    def keep(d, sc, aux, t, iters, mask=None):
        got = real(d, sc, aux, t, iters, mask)
        calls.append((d, sc, aux, t, iters, mask, got))
        return got

    eng.newton_solve = keep
    try:
        run()
    finally:
        del eng.newton_solve
    return calls


def newton_time(eng, name, solve, nni):
    """One row: K6's median of REPS windows of LAUNCHES launches on
    `solve`, the bound (the iterations' reads of d over HBM bandwidth),
    the plain loop's time on the same card tensors (launches=1) and the
    launch geometry (the cluster a row is split over, the blocks the
    card holds at once, rows an SM).  fail() when K6 is not faster than
    the plain loop, or at the NNI shapes (`nni`) more than
    NEWTON_OF_BOUND times its bound."""
    from phyml_tpu_torch.ops import newton

    d, sc, aux, t, iters, mask = solve[:6]
    n_rows = int(np.prod(d.shape[:-3]))
    _, ms = timed(lambda: eng.newton_solve(d, sc, aux, t, iters, mask))
    _, plain_ms = timed(lambda: newton.solve_plain(
        eng, d, sc, aux, t, iters, mask), launches=1)
    bound_ms = iters * d.numel() * 4 / PEAK_BYTES * 1e3
    geo = newton.geometry(n_rows, eng.P, eng.C, eng.ns)
    print(f"  K6 [{name}] {tuple(d.shape)} x {iters}: {ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({100 * bound_ms / ms:.1f} %), plain "
          f"{plain_ms:.3f} ms; cluster {geo['cluster']}, {geo['slots']} "
          f"slots, {geo['rows_per_sm']:.2f} rows an SM")
    if not ms < plain_ms:
        fail(f"[{name}] K6 takes {ms:.3f} ms, the plain loop {plain_ms:.3f}")
    if nni and not ms <= NEWTON_OF_BOUND * bound_ms:
        fail(f"[{name}] K6 takes {ms:.3f} ms, more than "
             f"{NEWTON_OF_BOUND:g}x its bound {bound_ms:.3f} ms")
    return dict(name=f"K6 {name}", shape=list(d.shape), iters=iters, ms=ms,
                bound_ms=bound_ms, bound="bytes", of_bound=bound_ms / ms,
                plain_ms=plain_ms, **geo)


def newton_phase(workdir, cuda):
    """K6 where the port runs it.  Each benchmark cell set up as
    portbench/harness.py sets it up (the seed's inputs, the set-up fit):
    its NNI scorer's 8 solves captured from one support unit (the
    central edge's: [117, 3, C, ns, P], 5 iterations, stride-0 scales),
    and the fit's branch-length solve on the fitted tree ([239, C, ns,
    P], 10 iterations, the row mask).  And the default run's SPR scorer
    (DEFAULT_RUN_TAXA, one call of spr.default_batch_k candidates on the
    simulating tree): its 6 solves ([N, K, C, ns, P], 6 iterations).
    Every solve is held to the plain version (newton_check); the first
    of each kind is timed (newton_time).  Returns the rows, with the K6
    launches of the support unit."""
    import torch
    from portbench import gen, harness, units
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.ops import newton
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.search import spr
    from phyml_tpu_torch.topology import Topology
    from phyml_tpu_torch.utils import trace

    bench = harness.manifest()
    rows = []
    for cell in NEWTON_CELLS:
        _, _, config, traffic, _ = harness.cell_of(bench, cell)
        aln, tree_path = gen.write_problem(config, NEWTON_SEED,
                                           os.path.join(workdir, cell))
        unit = units.unit_of(traffic, config, aln, tree_path, "gpu",
                             NEWTON_SEED % (2 ** 31))
        unit.setup()
        eng, model, params, topo = unit.state
        before = trace.snapshot()
        calls = captured_solves(eng, unit.run)
        torch.cuda.synchronize()
        unit_launches = trace.since(before).get("launch.K6", 0)
        if unit_launches != 8 or len(calls) != 8:
            fail(f"[{cell}] {unit_launches} K6 launches, {len(calls)} "
                 "solves in a unit (want 8)")
        checks = {"nni": newton_check(eng, f"{cell} nni", calls)}
        nni_solve = calls[0]
        del calls
        rv = topo.rooted()
        tree = tree_arrays(rv, dtype=torch.float32, device=eng.device)
        d, sc, aux = eng.edge_dotprods_sys(eng.system_of(params), tree)
        idx = torch.arange(eng.n_nodes, device=eng.device)
        mask = (idx != eng.n_nodes - 1) & (idx != int(tree.child[-1, 1]))
        t = torch.clamp(tree.blen, newton.BL_MIN, newton.BL_MAX)
        blen_solve = (d, sc, aux, t, 10, mask,
                      eng.newton_solve(d, sc, aux, t, 10, mask))
        checks["blen"] = newton_check(eng, f"{cell} blen", [blen_solve])
        for label, solve in (("nni", nni_solve), ("blen", blen_solve)):
            rows.append(dict(newton_time(eng, f"{cell} {label}", solve,
                                         label == "nni"),
                             unit_launches=unit_launches, **checks[label]))
        unit.free()
        del nni_solve, blen_solve, d, sc, aux
        torch.cuda.empty_cache()
    for dt in ("nt", "aa"):
        n_taxa = DEFAULT_RUN_TAXA[dt]
        aln_path, tree_path = write_problem(
            os.path.join(workdir, f"spr_{dt}{n_taxa}"), dt, n_taxa, N_SITES,
            SEED)
        args = cli.build_parser().parse_args(default_argv(dt, aln_path,
                                                          "gpu"))
        aln = read_alignment(aln_path, datatype=dt)
        model = cli._build_model(args, aln)
        params = cli._init_params(args, model, aln)
        eng = LikelihoodEngine(aln, model, dtype=torch.float32, device=cuda)
        with open(tree_path) as fh:
            rv = Topology.from_newick(fh.read(), aln.names).rooted()
        tree = tree_arrays(rv, dtype=torch.float32, device=cuda)
        vs = spr.prune_candidates(rv)[:spr.default_batch_k(eng, rv)]
        moves = [spr.spr_move_arrays(rv, v) for v in vs]
        calls = captured_solves(eng, lambda: spr.spr_scores_batched(
            eng, params, tree, np.stack([m for m, _ in moves]), vs,
            np.stack([v for _, v in moves])))
        if len(calls) != 6:
            fail(f"[{dt} SPR] {len(calls)} solves in a scorer call (want 6)")
        name = f"{dt}{n_taxa} default run SPR"
        check = newton_check(eng, name, calls)
        rows.append(dict(newton_time(eng, name, calls[0], False),
                         candidates=len(vs), **check))
        del calls, eng
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--rank-worker"]:
        return rank_worker(sys.argv[2])
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
    regs = ptxas_regs(log_path)
    sass = big_sass(so)

    rows, runs, supports, mix = [], {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        newton_rows = newton_phase(tmp, cuda)
        torch.cuda.empty_cache()
        for dt in ("nt", "aa"):
            aln_path, tree_path = write_problem(
                os.path.join(tmp, dt), dt, N_TAXA, N_SITES, SEED)
            dt_rows = kernel_phases(dt, aln_path, tree_path, cuda, regs)
            torch.cuda.empty_cache()
            fit_counts, fit_k3, _ = main_path(dt, aln_path, tree_path, cuda)
            torch.cuda.empty_cache()
            # the default run and the supports on a problem of their own
            # depth (DEFAULT_RUN_TAXA)
            if DEFAULT_RUN_TAXA[dt] != N_TAXA:
                run_aln, run_tree = write_problem(
                    os.path.join(tmp, f"{dt}{DEFAULT_RUN_TAXA[dt]}"), dt,
                    DEFAULT_RUN_TAXA[dt], N_SITES, SEED)
            else:
                run_aln, run_tree = aln_path, tree_path
            batch_k = distance_check(dt, run_aln, cuda)
            counts, res = default_run(dt, run_aln, run_tree, cuda, batch_k)
            runs[dt] = res
            torch.cuda.empty_cache()
            s_counts, stacked, supports[dt] = supports_phase(dt, run_aln,
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
            if dt == "nt":
                mix["partitioned"] = partitioned_phase(aln_path, tree_path,
                                                       cuda)[2]
                torch.cuda.empty_cache()
                rows += mixture_rows(aln_path, tree_path, cuda, regs)
            else:
                rows += lg4x_phase(aln_path, tree_path, run_aln, run_tree,
                                   cuda, regs, mix)
            torch.cuda.empty_cache()
        phytime, phytime_rows = phytime_phase(tmp, cuda)
        rows += phytime_rows
        torch.cuda.empty_cache()
        t_states = time.time()
        states_rows, states = states_phase(tmp, cuda, regs)
        states["wall_s"] = time.time() - t_states
        states["big_sass"] = sass
        rows += states_rows
        torch.cuda.empty_cache()
        aux, aux_fit = aux_phase(tmp, cuda)
        # the tools runs' fits beside each main row's launches
        for r in rows:
            kname = r["name"].split()[0]
            if r.get("path") in aux_fit and "cell" not in r \
                    and "launches_by_stack" not in r:
                r["launches_aux_tools_fit"] = aux_fit[r["path"]][kname]
        torch.cuda.empty_cache()
        phyrex, phyrex_rows = phyrex_phase(tmp, cuda)
        rows += phyrex_rows
        torch.cuda.empty_cache()
        distributed, dist_row = distributed_phase(tmp, cuda)
        rows.append(dist_row)
        torch.cuda.empty_cache()
        supports["small_abayes_gap"], mix["small"], phytime["small"], \
            states["small"], aux["small"], phyrex["small"] = \
            small_checks(tmp)

    print(f". chip_smoke: {time.time() - t_all:.0f} s in all, the kernels' "
          "build included")
    print(json.dumps({"default_runs": runs}))
    print(json.dumps({"supports": supports}, default=str))
    print(json.dumps({"mixtures_partitions_flags": mix}, default=str))
    print(json.dumps({"phytime": phytime}, default=str))
    print(json.dumps({"state_counts": states}, default=str))
    print(json.dumps({"aux_tools": aux}, default=str))
    print(json.dumps({"phyrex": phyrex}, default=str))
    print(json.dumps({"distributed": distributed}, default=str))
    print(json.dumps({"newton": newton_rows}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
