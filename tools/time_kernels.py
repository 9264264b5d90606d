#!/usr/bin/env python3
"""Time the port's CUDA kernels at the bench shapes, on one GPU.

    python3 tools/time_kernels.py [--root DIR] [--label NAME] [nt] [aa]

For each problem (a random 128-taxon tree and 4096 random sites; nt:
GTR+G4 at ns=4, aa: LG+G4 at ns=20, C=4) it times every kernel the
tree at DIR has (default: this checkout): K1, K2, K3 at the optimizer's
batch sizes (B = 1, 2 and the line-search grid: 65 systems for DNA, 13
for protein, each at its own rate scale) and, where present, K4 and K5.
It runs K3 through either wrapper signature: with the slot schedule
(`sched=`, `n_slots=`) or, on an older tree, without. Each time is the median over 7 windows of 50
launches back to back between two CUDA events, divided by 50, so the
host's launch overhead overlaps the card's work. To compare two
versions of the kernels, run this script on both trees one after the
other on one card (for example parent, change, change, parent), since
the card's clocks and power limit vary between machines. Without a CUDA
device it exits nonzero.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys


def window_ms(fn, reps=7, n=50):
    import torch

    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b) / n)
    return statistics.median(ms)


def time_problem(dt: str, seed: int = 7) -> dict:
    import numpy as np
    import torch
    from phyml_tpu_torch.io.alignment import compact
    from phyml_tpu_torch.models.substitution import SubstModel
    from phyml_tpu_torch.ops import clv, clv_slots, edotp
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.topology import Topology

    cuda = torch.device("cuda")
    rng = np.random.default_rng(seed)
    n, sites = 128, 4096
    ns = 4 if dt == "nt" else 20
    enc = np.zeros((n, sites, ns), np.float32)
    enc[np.arange(n)[:, None], np.arange(sites)[None],
        rng.integers(0, ns, size=(n, sites))] = 1
    aln = compact(enc, [f"t{i}" for i in range(n)], dt)
    m = SubstModel(datatype=dt, name="GTR" if dt == "nt" else "LG",
                   n_classes=4)
    eng = LikelihoodEngine(aln, m, dtype=torch.float32, device=cuda)
    tree = tree_arrays(Topology.random(n, rng, mean_blen=0.08).rooted(),
                       device=cuda)
    lam, V, Vinv, pi, w, _ = eng.system_of(m.init_params(
        aln.obs_state_freqs))
    pm = eng._pmats(lam, V, Vinv, tree.blen)
    topo = eng._topology(tree.child)
    child, sched = topo[:2]
    logw = eng._logw(w)
    k = eng.slot_count
    out = {
        "K1": window_ms(lambda: clv_slots.uppass_site_lse_slots(
            sched, eng.tips, pm, pi, logw, n_slots=k)),
        "K2": window_ms(lambda: edotp.edge_dotprods(
            child, eng.tips, pm, V, Vinv, pi)),
    }
    k3_kw = dict(sched=sched, n_slots=topo[2]) if len(topo) > 2 else {}
    for B in (1, 2, 65 if dt == "nt" else 13):
        if B == 1:
            args = (child, eng.tips, pm, pi, logw)
        else:
            pmb = torch.stack([eng._pmats(lam * f, V, Vinv, tree.blen)
                               for f in np.linspace(0.5, 2.0, B)])
            args = (child, eng.tips, pmb, pi.expand(B, *pi.shape).contiguous(),
                    logw.expand(B, *logw.shape).contiguous())
        out[f"K3(B={B})"] = window_ms(
            lambda: clv.uppass_site_lse(*args, **k3_kw))
        del args
    if hasattr(clv_slots, "uppass_site_lse_slots_stream"):
        out["K4"] = window_ms(lambda: clv_slots.uppass_site_lse_slots_stream(
            sched, eng.tips, pm, pi, logw, n_slots=k))
        out["K5"] = window_ms(lambda: edotp.edge_dotprods_stream(
            child, eng.tips, pm, V, Vinv, pi))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="tree holding phyml_tpu_torch")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("problems", nargs="*", default=["nt", "aa"])
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import phyml_tpu_torch

    if not phyml_tpu_torch.__file__.startswith(root):
        sys.exit(f"time_kernels: imported {phyml_tpu_torch.__file__}, "
                 f"not the tree at {root}")
    if not torch.cuda.is_available():
        sys.exit("time_kernels: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    for dt in args.problems:
        times = time_problem(dt)
        print(f"{args.label} {dt}: " + "  ".join(
            f"{name} {ms:.4f}" for name, ms in times.items())
            + f" ms  ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
