"""Sequence simulation along a tree (the reference's `evolve` binary,
evolve.c:16 EVOLVE_Main / :1197 EVOLVE_Seq).

Port of phyml_tpu/evolve.py.  Host-side numpy, with P(t) from the
port's models.eigen.pmat in float64 on the host: sample the root
state from the stationary distribution, walk the rooted tree sampling
child states from P(t) rows, with per-site rate classes drawn from the
model's mixture (discrete Gamma / FreeRate) and optional invariant
sites.
"""

from __future__ import annotations

import numpy as np
import torch

from phyml_tpu_torch.datatypes import AA_STATES, NT_STATES
from phyml_tpu_torch.models.eigen import pmat


def simulate_alignment(
    topo,
    model,
    params,
    n_sites: int,
    rng: np.random.Generator,
):
    """Returns (names, seqs: list[str]) simulated under the model.

    Reference parity: per-site rate class sampling mirrors
    EVOLVE_Seq's use of the RAS distribution; +I sites are constant.
    """
    params = {k: torch.as_tensor(v, dtype=torch.float64)
              for k, v in params.items()}
    lam, V, Vinv, pi, w, pinv = model.class_system(params)
    pi = pi.numpy()
    w = w.numpy()
    pinv = float(pinv)
    C, ns = lam.shape

    rv = topo.rooted()
    n = rv.n_otu

    # per-site class (C = invariant sentinel) and root state
    cls = rng.choice(C, size=n_sites, p=w / w.sum())
    invar = rng.random(n_sites) < pinv
    root_pi = (pi * w[:, None]).sum(0)
    root_pi /= root_pi.sum()
    states = np.zeros((2 * n - 1, n_sites), dtype=np.int64)
    root = rv.n_nodes - 1
    states[root] = rng.choice(ns, size=n_sites, p=root_pi)

    # per-node, per-class transition matrices (class rate folded in lam)
    t = torch.as_tensor(np.asarray(rv.node_blen, dtype=np.float64))
    P = pmat(lam, V, Vinv, t[:, None].expand(rv.n_nodes, C)).numpy()
    # [N, C, ns, ns]
    P = np.clip(P, 0.0, None)
    P /= P.sum(-1, keepdims=True)

    # preorder: parents before children = reverse postorder
    order = list(range(rv.n_internal - 1, -1, -1))
    for i in order:
        u = n + i
        for child in rv.child[i]:
            child = int(child)
            # cumulative-prob sampling vectorized over sites
            probs = P[child, cls, states[u], :]       # [n_sites, ns]
            cum = probs.cumsum(axis=1)
            r = rng.random(n_sites)[:, None]
            s = (r > cum).sum(axis=1)
            s = np.where(invar, states[u], s)
            states[child] = np.clip(s, 0, ns - 1)

    alphabet = NT_STATES if ns == 4 else AA_STATES
    names = [f"T{i:04d}" for i in range(n)]
    seqs = ["".join(alphabet[s] for s in states[i]) for i in range(n)]
    return names, seqs


def write_phylip(path: str, names, seqs) -> None:
    """Sequential PHYLIP (readable by both frameworks)."""
    with open(path, "w") as fh:
        fh.write(f" {len(names)} {len(seqs[0])}\n")
        for nm, sq in zip(names, seqs):
            fh.write(f"{nm:<10s}  {sq}\n")


def main(argv=None) -> int:
    """CLI matching the reference's `evolve` binary surface
    (EVOLVE_Main evolve.c:16): simulate sequences along a user tree
    (-u) or a simulated coalescent tree (EVOLVE_Coalescent
    evolve.c:1070, --coalescent N), writing <prefix>.phy and the
    true tree <prefix>_true_tree.txt.

        python -m phyml_tpu_torch.evolve -u tree.nwk -m GTR -l 500 \\
            --r_seed 1 -o sim"""
    import argparse

    from phyml_tpu_torch.models.substitution import SubstModel
    from phyml_tpu_torch.topology import Topology

    p = argparse.ArgumentParser(
        prog="phyml-tpu-torch-evolve",
        description="simulate alignments along trees "
                    "(reference: the evolve binary)")
    p.add_argument("-u", "--user_tree", default=None,
                   help="newick tree to simulate along")
    p.add_argument("--coalescent", type=int, default=None,
                   metavar="N_TAXA",
                   help="simulate an N-taxon coalescent tree instead")
    p.add_argument("--theta", type=float, default=1.0,
                   help="coalescent population size parameter")
    p.add_argument("-m", "--model", default="HKY85")
    p.add_argument("-d", "--datatype", choices=["nt", "aa"],
                   default="nt")
    p.add_argument("-l", "--n_sites", type=int, default=1000)
    p.add_argument("-c", "--n_classes", type=int, default=4)
    p.add_argument("-a", "--alpha", type=float, default=1.0)
    p.add_argument("-t", "--ts_tv", type=float, default=4.0)
    p.add_argument("-f", "--frequencies", default=None,
                   help="'fA,fC,fG,fT' (default: uniform)")
    p.add_argument("--r_seed", type=int, default=None)
    p.add_argument("-o", "--output", default="evolve_out",
                   help="output prefix")
    args = p.parse_args(argv)

    import time as _time
    seed = args.r_seed if args.r_seed is not None else \
        int(_time.time()) % (2 ** 31)
    rng = np.random.default_rng(seed)

    if args.user_tree:
        from phyml_tpu_torch.io.newick import leaf_names, parse_newick
        text = open(args.user_tree).read()
        names = leaf_names(parse_newick(text))
        topo = Topology.from_newick(text, names)
    elif args.coalescent:
        from phyml_tpu_torch.bayes.chrono import TimeTree
        tt = TimeTree.coalescent(args.coalescent, rng,
                                 theta=args.theta)
        names = [f"t{i}" for i in range(args.coalescent)]
        tt.names = names
        topo = tt.to_topology()
    else:
        p.error("need -u TREE or --coalescent N")

    ns = 4 if args.datatype == "nt" else 20
    if args.frequencies:
        fixed = np.asarray([float(x)
                            for x in args.frequencies.split(",")])
    else:
        # simulation has no data to take empirical freqs from;
        # default to uniform (reference: Print_Settings shows the
        # model's default freqs, uniform for simulated runs)
        fixed = np.full(ns, 1.0 / ns)
    model = SubstModel(
        datatype=args.datatype, name=args.model,
        n_classes=args.n_classes,
        freqs_mode="fixed", fixed_freqs=fixed)
    params = model.init_params()
    if "kappa" in params:
        params["kappa"] = torch.tensor(args.ts_tv, dtype=torch.float64)
    if "alpha" in params:
        params["alpha"] = torch.tensor(args.alpha, dtype=torch.float64)

    _, seqs = simulate_alignment(topo, model, params, args.n_sites,
                                 rng)
    write_phylip(f"{args.output}.phy", names, seqs)
    with open(f"{args.output}_true_tree.txt", "w") as fh:
        fh.write(topo.to_newick(names) + "\n")
    print(f". Simulated {len(names)} x {args.n_sites} "
          f"({args.model}) with seed {seed}.")
    print(f". Alignment: {args.output}.phy")
    print(f". True tree: {args.output}_true_tree.txt")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
