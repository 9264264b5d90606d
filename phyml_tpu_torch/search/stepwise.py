"""Stepwise-addition parsimony starting trees (reference:
Stepwise_Add_Pars pars.c:948 — prune all but 3 tips, then greedily
regraft each remaining tip at its most parsimonious position).

Design difference: the reference rescopes every candidate edge with a
full incremental Fitch pass per (tip, edge) pair.  Here the candidate
scan is vectorized over patterns with the directional Fitch state
sets (up = below-subtree set, down = rest-of-tree set): the insertion
cost of tip x on edge e is the standard Wagner rule
  cost(x, e) = sum_p w_p * [S_x(p) & (U_e(p) | D_e(p)) == 0].
All bit-parallel numpy on host; no device round-trips (a per-edge
device scan would pay a ~40 ms host sync per insertion here).
"""

from __future__ import annotations

import numpy as np

from phyml_tpu_torch.ops.parsimony import _tip_masks
from phyml_tpu_torch.topology import Topology


def _combine(sets):
    s = sets[0]
    for k in sets[1:]:
        inter = s & k
        s = np.where(inter != 0, inter, s | k)
    return s


def _fitch_sets(adj, root, masks):
    """(up, down, parent): up[v] = Fitch set of the subtree below v
    (v seen from its parent); down[v] = set of the rest of the tree.
    `root` must be an INTERNAL node (no own observed state)."""
    up: dict[int, np.ndarray] = {}
    parent: dict[int, int] = {root: -1}
    order = []
    stack = [(root, -1, False)]
    while stack:
        u, came, done = stack.pop()
        if not done:
            parent[u] = came
            stack.append((u, came, True))
            for v, _ in adj[u]:
                if v != came:
                    stack.append((v, u, False))
        else:
            order.append(u)
            kids = [up[v] for v, _ in adj[u] if v != came]
            up[u] = masks[u] if not kids else _combine(kids)

    down: dict[int, np.ndarray] = {root: None}
    for u in reversed(order):
        came = parent[u]
        for v, _ in adj[u]:
            if v == came:
                continue
            msgs = ([] if down[u] is None else [down[u]]) + \
                [up[s] for s, _ in adj[u] if s != came and s != v]
            down[v] = _combine(msgs) if msgs else None
    return up, down, parent


def stepwise_addition_tree(
    aln, rng: np.random.Generator | None = None,
    order=None, blen: float = 0.1,
) -> Topology:
    """Greedy most-parsimonious-insertion starting tree; taxa added
    in `order` (default: random permutation, matching the reference's
    Permutate shuffle)."""
    n = aln.n_otu
    assert n >= 3
    rng = rng or np.random.default_rng(0)
    if order is None:
        order = rng.permutation(n)
    order = [int(x) for x in order]
    masks = _tip_masks(aln, aln.n_patterns).astype(np.int64)
    w = np.asarray(aln.weights, dtype=np.float64)

    t0, t1, t2 = order[:3]
    hub = n  # first internal node id; always internal -> pass root
    edges: list[list[int]] = [[hub, t0], [hub, t1], [hub, t2]]
    next_internal = n + 1

    for t in order[3:]:
        adj: dict[int, list[tuple[int, int]]] = {}
        for eid, (a, b) in enumerate(edges):
            adj.setdefault(a, []).append((b, eid))
            adj.setdefault(b, []).append((a, eid))
        up, down, parent = _fitch_sets(adj, hub, masks)

        S_x = masks[t]
        best_eid, best_cost = -1, np.inf
        for eid, (a, b) in enumerate(edges):
            c = a if parent[a] == b else b   # child side of the edge
            M = up[c] if down[c] is None else \
                _combine([up[c], down[c]])
            cost = float(np.sum(w * ((S_x & M) == 0)))
            if cost < best_cost:
                best_cost, best_eid = cost, eid
        # commit: split the best edge with a new internal node
        a, b = edges[best_eid]
        link = next_internal
        next_internal += 1
        edges[best_eid] = [a, link]
        edges.append([link, b])
        edges.append([link, t])

    topo = Topology(n, np.asarray(edges, dtype=np.int32),
                    np.full(len(edges), blen))
    topo.validate()
    return topo
