#!/usr/bin/env python3
"""Where the time of the search's scorers goes, on one GPU.

    python3 tools/profile_search.py [nt] [aa]     # from the repo root

For each problem (chip_smoke.py's bench problems from the same seed:
128 taxa x 4096 sites under GTR+G4 or LG+G4), on the BioNJ tree at the
starting parameters, as the default run (chip_smoke.py) calls them:

1. the NNI scorer (`search/nni.py::nni_scores`, every internal edge's
   three configurations), the SPR scorer (`search/spr.py::
   spr_scores_batched`, one block of batch_k prune candidates) and the
   masked passes it starts with (`_up_pass` + `_down_pass` over the
   block): wall-clock per call (the card synchronized, median of 5);
2. the same calls under torch.profiler: device busy time and kernel
   launches per call, and the idle share within a call;
3. the card's utilization as nvidia-smi samples it (NVML: the share of
   each ~100 ms period in which a kernel ran) over 20 back-to-back SPR
   scorer calls, beside the profiler's busy share of the same calls:
   chip_smoke.py reads the whole default run's idle share this way.

Prints a summary per problem and one JSON line with its numbers.
Without a CUDA device it exits nonzero.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the bench problems, the CLI flags)


def wall_ms(fn, reps=5):
    import torch

    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.time()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.time() - t))
    return statistics.median(out)


def profiled(fn, reps=3):
    """(device busy ms, kernel launches, [(ms, launches, kernel name)] of
    the four largest kernels) per call under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy, n, rows = 0.0, 0, []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            ms = e.self_device_time_total / 1e3
            busy += ms
            n += e.count
            rows.append((ms / reps, e.count / reps, e.key))
    if not n:
        sys.exit("profile_search: the profiler recorded no device time")
    return busy / reps, n / reps, sorted(rows, reverse=True)[:4]


def nvml_busy(fn, calls=20):
    """(mean utilization over `calls` calls as nvidia-smi samples it,
    samples); the sampler is stopped before this returns."""
    import torch

    torch.cuda.synchronize()
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.3)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.2)
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    vals = [float(x) for x in out.split() if x.replace(".", "").isdigit()]
    # the first and last samples straddle the window's edges
    vals = vals[2:-1]
    return (statistics.mean(vals) / 100 if vals else None), len(vals)


def profile_problem(dt, tmp, cuda):
    import numpy as np
    import torch
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.io.alignment import read_alignment
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.search import nni, spr
    from phyml_tpu_torch.search.bionj import bionj_start

    aln_path, _ = chip_smoke.write_problem(
        os.path.join(tmp, dt), dt, chip_smoke.N_TAXA, chip_smoke.N_SITES,
        chip_smoke.SEED)
    args = cli.build_parser().parse_args(
        chip_smoke.default_argv(dt, aln_path, "gpu"))
    aln = read_alignment(aln_path, datatype=dt)
    model = cli._build_model(args, aln)
    params = cli._init_params(args, model, aln)
    eng = LikelihoodEngine(aln, model, dtype=torch.float32, device=cuda)
    rv = bionj_start(eng, params).rooted()
    tree = tree_arrays(rv, device=cuda)
    cand = nni.candidate_arrays(rv)
    batch_k = spr.default_batch_k(eng, rv)
    prunable = [v for v in spr.prune_candidates(rv)
                if int(rv.parent[v]) != rv.n_nodes - 1]
    block = prunable[:batch_k]
    mv = [spr.spr_move_arrays(rv, v) for v in block]
    masks = np.stack([m for m, _ in mv])
    valids = np.stack([va for _, va in mv])
    sys_ = eng.system_of(params)
    pm = eng._pmats(sys_[0], sys_[1], sys_[2], tree.blen)

    def passes():
        pup, _, sc = eng._up_pass(pm, tree.child, masks)
        eng._down_pass(pm, tree.child, pup, sc, sys_[3], masks)

    calls = {
        "NNI scorer": lambda: nni.nni_scores(eng, params, tree, cand),
        "SPR scorer": lambda: spr.spr_scores_batched(
            eng, params, tree, masks, np.asarray(block), valids),
        "masked passes": passes,
    }
    res = dict(problem=dt, batch_k=batch_k, n_prunable=len(prunable))
    for name, fn in calls.items():
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = wall_ms(fn)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        busy, n, top = profiled(fn)
        res[name] = dict(wall_ms=ms, busy_ms=busy, launches=n,
                         idle=1 - busy / ms, peak_gib=peak,
                         top=[[t, c, k[:80]] for t, c, k in top])
        print(f". [{dt}] {name}: {ms:.1f} ms a call (wall), device busy "
              f"{busy:.1f} ms in {n:.0f} kernel launches, idle share "
              f"{1 - busy / ms:.3f}; peak {peak:.2f} GiB beyond its "
              "inputs")
        for t, c, k in top:
            print(f"      {t:8.2f} ms  x{c:<6.0f} {k[:90]}")
    util, n_samples = nvml_busy(calls["SPR scorer"])
    res["nvml_busy_spr"] = util
    if util is None:
        print(f". [{dt}] nvidia-smi gave no utilization samples: not "
              "measured")
    else:
        print(f". [{dt}] 20 SPR scorer calls: nvidia-smi busy share "
              f"{util:.3f} ({n_samples} samples) beside the profiler's "
              f"{1 - res['SPR scorer']['idle']:.3f}")
    return res


def main() -> int:
    import torch
    from phyml_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        sys.exit("profile_search: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f". card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    cuda = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        for dt in sys.argv[1:] or ["nt", "aa"]:
            out = profile_problem(dt, tmp, cuda)
            out["card"] = smi
            print(json.dumps(out))
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
