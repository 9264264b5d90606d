#!/usr/bin/env python3
"""Time the port's CUDA kernels at the bench shapes, on one GPU.

    python3 tools/time_kernels.py [--root DIR] [--label NAME]
        [--kernels K2,K5] [--data random|smoke] [--taxa N]
        [--compare PARENT] [nt] [aa]

For each problem (nt: GTR+G4 at ns=4, aa: LG+G4 at ns=20, C=4; with
--data random, the default, a random tree of --taxa taxa (128) and 4096
random sites under the model's initial parameters; with --data smoke,
chip_smoke.py's bench problem, the sequences simulated down its tree,
3767 and 3945 patterns, under the simulation's parameters) it times
every kernel the
tree at DIR has (default: this checkout): K1, K2, K3 at the optimizer's
batch sizes (B = 1, 2 and the line-search grid: 65 systems for DNA, 13
for protein, each at its own rate scale) and, where present, K4 and K5.
It runs K3 through either wrapper signature: with the slot schedule
(`sched=`, `n_slots=`) or, on an older tree, without. Each time is the median over 7 windows of 50
launches back to back between two CUDA events, divided by 50, so the
host's launch overhead overlaps the card's work. To compare two
versions of the kernels, run this script on both trees one after the
other on one card, since the card's clocks and power limit vary between
machines: `--compare PARENT` does so in one call, in the order parent,
this tree, this tree, parent (one process each). `--kernels` times only
the named kernels (K3 names all its batch sizes). K1 and K4 walk the
slot count the tree's engine passes them (the schedule's own since
the slot kernels' redesign, the bound ceil(log2 n)+2 before); a kernel
that refuses the shape (K1 where one class's P-matrices of the whole
tree do not fit a block) is reported as "refused". Without a CUDA
device it exits nonzero.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys


HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def load_problem(dt: str, data: str, tmp: str, seed: int = 7, n: int = 128):
    """(alignment, rooted tree, model, params) of one timing problem."""
    import numpy as np
    from phyml_tpu_torch.io.alignment import compact, read_alignment
    from phyml_tpu_torch.models.substitution import SubstModel
    from phyml_tpu_torch.topology import Topology

    sites = 4096
    if data == "smoke":
        sys.path.insert(1, HERE)
        import chip_smoke

        aln_path, tree_path = chip_smoke.write_problem(
            os.path.join(tmp, dt), dt, n, sites, chip_smoke.SEED)
        aln = read_alignment(aln_path, datatype=dt)
        with open(tree_path) as fh:
            rv = Topology.from_newick(fh.read(), aln.names).rooted()
        if dt == "nt":
            m = SubstModel(datatype="nt", name="GTR", n_classes=4,
                           freqs_mode="fixed", fixed_freqs=chip_smoke.FREQS)
        else:
            m = SubstModel(datatype="aa", name="LG", n_classes=4,
                           freqs_mode="model")
        return aln, rv, m, chip_smoke.true_params(dt, m.init_params())
    rng = np.random.default_rng(seed)
    ns = 4 if dt == "nt" else 20
    enc = np.zeros((n, sites, ns), np.float32)
    enc[np.arange(n)[:, None], np.arange(sites)[None],
        rng.integers(0, ns, size=(n, sites))] = 1
    aln = compact(enc, [f"t{i}" for i in range(n)], dt)
    m = SubstModel(datatype=dt, name="GTR" if dt == "nt" else "LG",
                   n_classes=4)
    rv = Topology.random(n, rng, mean_blen=0.08).rooted()
    return aln, rv, m, m.init_params(aln.obs_state_freqs)


def time_problem(dt: str, want, data: str = "random", n: int = 128) -> dict:
    import tempfile

    import numpy as np
    import torch
    from phyml_tpu_torch.ops import clv, clv_slots, edotp
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays

    cuda = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        aln, rv, m, params = load_problem(dt, data, tmp, n=n)
    eng = LikelihoodEngine(aln, m, dtype=torch.float32, device=cuda)
    tree = tree_arrays(rv, device=cuda)
    lam, V, Vinv, pi, w, _ = eng.system_of(params)
    pm = eng._pmats(lam, V, Vinv, tree.blen)
    topo = eng._topology(tree.child)
    child, sched = topo[:2]
    logw = eng._logw(w)
    k = topo[2] if hasattr(eng, "_slot_site_lse") else eng.slot_count
    out = {}

    # the tips as the tree's engine hands them to K1/K4
    tips = getattr(eng, "slot_tips", eng.tips)

    def slot_ms(fn):
        try:
            return window_ms(lambda: fn(sched, tips, pm, pi, logw,
                                        n_slots=k))
        except NotImplementedError:
            return "refused"

    if "K1" in want:
        out["K1"] = slot_ms(clv_slots.uppass_site_lse_slots)
    if "K2" in want:
        out["K2"] = window_ms(lambda: edotp.edge_dotprods(
            child, eng.tips, pm, V, Vinv, pi))
    k3_kw = dict(sched=sched, n_slots=topo[2]) if len(topo) > 2 else {}
    for B in (1, 2, 65 if dt == "nt" else 13) if "K3" in want else ():
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
    if "K4" in want:
        out["K4"] = slot_ms(clv_slots.uppass_site_lse_slots_stream)
    if "K5" in want:
        out["K5"] = window_ms(lambda: edotp.edge_dotprods_stream(
            child, eng.tips, pm, V, Vinv, pi))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="tree holding phyml_tpu_torch")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--kernels", default="K1,K2,K3,K4,K5")
    ap.add_argument("--data", choices=["random", "smoke"], default="random")
    ap.add_argument("--taxa", type=int, default=128,
                    help="taxa of the random tree (--data random)")
    ap.add_argument("--compare", metavar="PARENT",
                    help="tree to time against: parent, this, this, parent")
    ap.add_argument("problems", nargs="*", default=["nt", "aa"])
    args = ap.parse_args()
    if args.compare:
        rc = 0
        for root, label in ((args.compare, "parent"), (args.root, "change"),
                            (args.root, "change"), (args.compare, "parent")):
            rc |= subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--root", root,
                 "--label", label, "--kernels", args.kernels,
                 "--data", args.data, "--taxa", str(args.taxa),
                 *args.problems]).returncode
        return rc
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
        times = time_problem(dt, args.kernels.split(","), args.data,
                             args.taxa)
        print(f"{args.label} {dt} ({args.data}, {args.taxa} taxa): "
              + "  ".join(f"{name} {ms:.4f}" if isinstance(ms, float)
                          else f"{name} {ms}" for name, ms in times.items())
            + f" ms  ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
