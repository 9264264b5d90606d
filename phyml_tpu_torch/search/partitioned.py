"""Partitioned (multi-gene) analysis: one topology, per-partition
models and branch lengths.

Port of phyml_tpu/search/partitioned.py.  The reference implements
partitions as chained trees (mixt.c: `next_mixt` links over t_tree,
MIXT_Lk mixt.c:730 summing partition log-likelihoods; the XML front
end assembles one <partitionelem> per gene, xml.c).  Topology moves
are scored on the combined likelihood; each partition keeps its own
branch lengths and model parameters (PhyML's unlinked-lengths default
for distinct partition elements).

Each partition is an independent `LikelihoodEngine` (its own pattern
axis, its own kernel launches); the shared object is the host-side
edge-list `Topology` STRUCTURE.  Per-partition branch lengths ride
per-partition `Topology` copies with identical edge arrays, so the
same surgery (edge-id based) applies to every copy.  Joint NNI/SPR
selection sums the per-partition candidate scores: the per-partition
scorers already jointly optimize their own local branch lengths,
which is exactly the unlinked-lengths semantics.
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np

from phyml_tpu_torch.ops.likelihood import tree_arrays
from phyml_tpu_torch.optim.blen import optimize_branch_lengths
from phyml_tpu_torch.optim.round import optimize_scalars
from phyml_tpu_torch.search.nni import (
    _apply_swaps, _host_blen, _select_disjoint, candidate_arrays, nni_scores,
)
from phyml_tpu_torch.search.spr import (
    apply_spr, prune_candidates, spr_move_arrays, spr_scores,
)


class Partition(NamedTuple):
    engine: object       # LikelihoodEngine
    model: object        # SubstModel
    params: dict


def _tree(rv, engine):
    return tree_arrays(rv, dtype=engine.dtype, device=engine.device)


def reorder_taxa(aln, names: list[str]):
    """Return a copy of `aln` with rows permuted into `names` order
    (partitions must agree on tip ids; the reference requires
    identical taxon sets across partition elements too)."""
    if list(aln.names) == list(names):
        return aln
    if set(aln.names) != set(names):
        missing = set(names) ^ set(aln.names)
        raise ValueError(
            f"partitions disagree on taxa (difference: {sorted(missing)})")
    perm = [aln.names.index(nm) for nm in names]
    out = copy.copy(aln)
    out.names = list(names)
    out.partials = aln.partials[perm]
    return out


def joint_loglik(parts: list[Partition], topos) -> float:
    """Sum of per-partition log-likelihoods at the current trees."""
    tot = 0.0
    for (eng, _, prm), topo in zip(parts, topos):
        tot += float(eng.loglik(prm, _tree(topo.rooted(), eng)))
    return tot


def _opt_blens(parts, topos, tol=1e-4):
    """Per-partition parallel-Newton branch lengths; returns total."""
    tot = 0.0
    for (eng, _, prm), topo in zip(parts, topos):
        rv = topo.rooted()
        ta, lnl = optimize_branch_lengths(eng, prm, _tree(rv, eng), tol=tol)
        topo.set_blen_from_rooted(rv, _host_blen(ta))
        tot += lnl
    return tot


def nni_round_partitioned(parts: list[Partition], topos,
                          min_gain: float = 1e-4):
    """One simultaneous-NNI round on the COMBINED likelihood
    (≙ MIXT_Lk-scored Simu): per-partition candidate scores summed,
    the best node-disjoint improving swaps applied to every copy.
    Returns (topos, joint_lnL, n_applied)."""
    lnl = _opt_blens(parts, topos)

    cand = candidate_arrays(topos[0].rooted())
    lnl_sum = 0.0
    per_part = []
    for (eng, _, prm), topo in zip(parts, topos):
        rv = topo.rooted()
        lnl_cfg, t_opt = nni_scores(eng, prm, _tree(rv, eng), cand)
        lnl_sum = lnl_sum + lnl_cfg
        per_part.append((rv, t_opt))
    gains = lnl_sum[:, 1:] - lnl_sum[:, [0]]
    chosen = _select_disjoint(cand, gains, min_gain)
    if not chosen:
        return topos, lnl, 0

    def apply_to_all(sel):
        return [
            _apply_swaps(topo.copy(), rv, cand, sel, t_opt)
            for topo, (rv, t_opt) in zip(topos, per_part)
        ]

    new = apply_to_all(chosen)
    lnl2 = _opt_blens(parts, new)
    if lnl2 <= lnl and len(chosen) > 1:
        chosen = chosen[:1]
        new = apply_to_all(chosen)
        lnl2 = _opt_blens(parts, new)
    if lnl2 <= lnl:
        return topos, lnl, 0
    return new, lnl2, len(chosen)


def spr_round_partitioned(parts: list[Partition], topos,
                          min_gain: float = 1e-3,
                          rng: np.random.Generator | None = None):
    """One SPR sweep on the combined likelihood: per-partition target
    scores summed, improving regrafts applied to every copy (each
    partition keeping its own optimized junction lengths).  One scorer
    call per prune candidate and partition.
    Returns (topos, joint_lnL, n_applied)."""
    rng = rng or np.random.default_rng(0)
    n_applied = 0
    rvs = [t.rooted() for t in topos]
    tas = [_tree(rv, p.engine) for rv, p in zip(rvs, parts)]
    lnl_cur = sum(
        float(p.engine.loglik(p.params, ta))
        for p, ta in zip(parts, tas))
    order = rng.permutation(prune_candidates(rvs[0]))
    stale = False
    for v in order:
        v = int(v)
        if stale:
            rvs = [t.rooted() for t in topos]
            tas = [_tree(rv, p.engine) for rv, p in zip(rvs, parts)]
            if v not in set(prune_candidates(rvs[0])):
                continue
            stale = False
        rv0 = rvs[0]
        if int(rv0.parent[v]) == rv0.n_nodes - 1:
            continue
        mask, valid = spr_move_arrays(rv0, v)
        lnl_t = 0.0
        triples = []
        for p, ta in zip(parts, tas):
            l_k, t1, t2, tp = spr_scores(p.engine, p.params, ta, mask,
                                         v, valid)
            lnl_t = lnl_t + l_k
            triples.append((t1, t2, tp))
        best = int(np.argmax(lnl_t))
        u = int(rv0.parent[v])
        s_row = rv0.child[u - rv0.n_otu]
        sib = int(s_row[1] if int(s_row[0]) == v else s_row[0])
        link_edges = {int(rv0.node_to_edge[u]),
                      int(rv0.node_to_edge[sib])}
        if int(rv0.node_to_edge[best]) in link_edges:
            continue
        if lnl_t[best] - lnl_cur < min_gain:
            continue
        topos = [
            apply_spr(topo, rv, v, best, float(t1[best]),
                      float(t2[best]), float(tp[best]))
            for topo, rv, (t1, t2, tp) in zip(topos, rvs, triples)
        ]
        lnl_cur = float(lnl_t[best])
        n_applied += 1
        stale = True
    return topos, lnl_cur, n_applied


def partitioned_search(
    parts: list[Partition],
    topo0,
    search: str = "SPR",
    opt_params: bool = True,
    tol: float = 1e-3,
    max_outer: int = 15,
    seed: int = 0,
    verbose: bool = False,
):
    """Joint topology search over all partitions (≙ the reference's
    partitioned run: one tree chain, MIXT-combined scores).  Returns
    (topos, parts-with-updated-params, joint lnL)."""
    rng = np.random.default_rng(seed)
    topos = [topo0.copy() for _ in parts]
    lnl = -np.inf
    for outer in range(max_outer):
        n_moves = 0
        if search.upper() in ("SPR", "BEST"):
            topos, lnl_new, n_moves = spr_round_partitioned(
                parts, topos, rng=rng)
            if verbose:
                print(f"  spr[{outer}]: joint lnL {lnl_new:.5f} "
                      f"({n_moves} moves)")
        for _ in range(30):
            topos, lnl_new, n_swaps = nni_round_partitioned(parts, topos)
            n_moves += n_swaps
            if verbose and n_swaps:
                print(f"  nni[{outer}]: joint lnL {lnl_new:.5f} "
                      f"({n_swaps} swaps)")
            if n_swaps == 0:
                break
        if opt_params:
            new_parts = []
            lnl_new = 0.0
            for (eng, mdl, prm), topo in zip(parts, topos):
                prm, lnl_k = optimize_scalars(eng, mdl, prm,
                                              _tree(topo.rooted(), eng))
                new_parts.append(Partition(eng, mdl, prm))
                lnl_new += lnl_k
            parts = new_parts
            if verbose:
                print(f"  params[{outer}]: joint lnL {lnl_new:.5f}")
        if n_moves == 0 and lnl_new - lnl < tol:
            lnl = max(lnl, lnl_new)
            break
        lnl = lnl_new
    lnl = _opt_blens(parts, topos)
    return topos, parts, lnl
