"""The benchmark's inputs, made from the seed: a random tree and an
alignment simulated down it.

A frozen copy of the recipe of chip_smoke.py's `write_problem` and
`simulate`, rewritten on NumPy with the models of `reference/model.py`:

* the tree: sequential random addition of taxa to a three-taxon star,
  each new taxon on an edge drawn uniformly, branch lengths exponential
  with the configuration's mean (0.08);
* the sequences: a rate category per site drawn with equal weights, the
  state at the root drawn from the frequencies, each child's state drawn
  from the row of P(rate x length) of its parent's state;
* the model's classes (`reference/models/<name>.py` at the values the
  configuration states): DNA under GTR with the configuration's rates
  and frequencies; amino acids under LG with its own frequencies; a
  discrete Gamma of shape alpha over the configuration's categories.

The data set is one per configuration: the tree and the sequences are
drawn from one `numpy.random.default_rng` of the configuration's
`data_seed`, the tree first, so both configurations share it.  The
run's seed draws the order in which the columns are written: every seed
asks for the same work, since a fit's path (its rounds, its steps)
depends on the data and not on the order of the columns, and one seed
gives the same files byte for byte on any machine.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench.reference import model as M
from portbench.reference import models


def rng_of(seed: int) -> np.random.Generator:
    """The generator of a seed; any whole number, negative or past 64
    bits, maps to one stream."""
    return np.random.default_rng(int(seed) % (2 ** 64))


def random_tree(n: int, rng: np.random.Generator, mean_blen: float):
    """(edges int [2n - 3, 2], blen [2n - 3]): tips 0..n-1, internal
    nodes n..2n-3 in the order they were made."""
    edges = [[n, 0], [n, 1], [n, 2]]
    nxt = n + 1
    for tip in range(3, n):
        k = int(rng.integers(0, len(edges)))
        p, q = edges[k]
        edges[k] = [p, nxt]
        edges.append([nxt, q])
        edges.append([nxt, tip])
        nxt += 1
    blen = rng.exponential(mean_blen, size=len(edges))
    return np.asarray(edges, dtype=np.int64), blen


def classes_of(config: dict):
    """(S [C, ns, ns], pi [C, ns], rate [C], weight [C]) NumPy float64:
    the classes of the configuration's model at the values it states
    (`reference/models/<name>.py`)."""
    mod = models.of(config)
    x, freqs = mod.truth(config["model"])
    with torch.no_grad():
        return tuple(t.numpy() for t in mod.mixture(
            torch.as_tensor(x, dtype=torch.float64),
            torch.as_tensor(freqs, dtype=torch.float64), config["model"]))


def simulate(edges, blen, n_taxa, config, n_sites, rng):
    """States [n_taxa, n_sites] (int) simulated down the tree from the
    internal node n_taxa."""
    S, pi, rate, w = classes_of(config)
    K, ns = len(w), pi.shape[-1]
    # classes that share one matrix and one set of frequencies (a
    # Gamma model) share one eigen system, the rate folded into t
    shared = bool((S == S[0]).all() and (pi == pi[0]).all())
    systems = [M.eigen(S[0], pi[0])] if shared else \
        [M.eigen(S[c], pi[c]) for c in range(K)]
    n_nodes = 2 * n_taxa - 2
    adj = [[] for _ in range(n_nodes)]
    for k, (a, b) in enumerate(edges):
        adj[a].append((b, k))
        adj[b].append((a, k))
    cls = rng.choice(K, size=n_sites) if (w == w[0]).all() else \
        rng.choice(K, size=n_sites, p=w)
    states = np.zeros((n_nodes, n_sites), dtype=np.int64)
    root = n_taxa
    if (pi == pi[0]).all():
        states[root] = rng.choice(ns, size=n_sites, p=pi[0])
    else:
        for c in range(K):
            at = cls == c
            states[root, at] = rng.choice(ns, size=int(at.sum()), p=pi[c])
    stack = [(root, -1)]
    while stack:                                   # preorder
        u, came = stack.pop()
        for v, k in adj[u]:
            if v == came:
                continue
            if shared:
                P = M.pmat(*systems[0], rate * blen[k])     # [K, ns, ns]
            else:
                P = np.stack([M.pmat(*systems[c], rate[c] * blen[k])
                              for c in range(K)])
            P = np.clip(P, 0.0, None)
            cum = np.cumsum(P / P.sum(-1, keepdims=True), axis=-1)
            rows = cum[cls, states[u]]                       # [sites, ns]
            r = rng.random(n_sites)[:, None]
            states[v] = np.minimum((r > rows).sum(axis=1), ns - 1)
            stack.append((v, u))
    return states[:n_taxa]


def taxon_names(n: int) -> list[str]:
    return [f"T{i:04d}" for i in range(n)]


def newick(edges, blen, names) -> str:
    """Unrooted newick, a trifurcation at tip 0's neighbour."""
    n = len(names)
    adj = [[] for _ in range(2 * n - 2)]
    for k, (a, b) in enumerate(edges):
        adj[a].append((b, k))
        adj[b].append((a, k))

    def rec(u, came, k):
        if u < n:
            return f"{names[u]}:{blen[k]:.10f}"
        kids = [rec(v, u, e) for v, e in adj[u] if v != came]
        return "(" + ",".join(kids) + f"):{blen[k]:.10f}"

    start = adj[0][0][0]
    parts = [rec(0, start, adj[0][0][1])]
    parts += [rec(v, start, e) for v, e in adj[start] if v != 0]
    return "(" + ",".join(parts) + ");"


def write_problem(config: dict, seed: int, dirname: str):
    """Write `aln.phy` (sequential PHYLIP, the columns in the seed's
    order) and `tree.nwk` (the tree the data were simulated on) for a
    configuration; returns their paths."""
    data = config["data"]
    n, sites = int(data["taxa"]), int(data["sites"])
    rng = rng_of(data["data_seed"])
    edges, blen = random_tree(n, rng, float(data["mean_branch_length"]))
    states = simulate(edges, blen, n, config, sites, rng)
    states = states[:, rng_of(seed).permutation(sites)]
    alphabet = np.frombuffer(models.of(config).ALPHABET.encode(),
                             dtype=np.uint8)
    names = taxon_names(n)
    os.makedirs(dirname, exist_ok=True)
    aln = os.path.join(dirname, "aln.phy")
    tree = os.path.join(dirname, "tree.nwk")
    with open(aln, "wb") as fh:
        fh.write(f" {n} {sites}\n".encode())
        for name, row in zip(names, states):
            fh.write(f"{name:<10s}  ".encode() + alphabet[row].tobytes()
                     + b"\n")
    with open(tree, "w") as fh:
        fh.write(newick(edges, blen, names) + "\n")
    return aln, tree
