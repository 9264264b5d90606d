"""Branch supports: bootstrap, aLRT family, aBayes, SH, TBE.

PyTorch port of phyml_tpu/search/support.py.  Reference: Bootstrap
(utilities.c:3884) resamples site weights and re-runs the whole search
per replicate; aLRT/aBayes/SH (alrt.c:172 aLRT, :918
Statistics_To_Probabilities, :1091 Statistics_to_RELL, :1148
Statistics_To_SH) compare each internal edge's best NNI configuration
against the alternatives; TBE (tbe.c) replaces presence/absence with
transfer distance.

As in phyml_tpu:
  * A bootstrap replicate is a different pattern-weight vector, drawn
    with numpy from seed + rep, so both packages (and any farming
    layout) draw the same replicates.
  * All three NNI-configuration likelihoods of every edge, and their
    per-site vectors, come from the one batched NNI scorer.
  * RELL/SH resampling: one [n_rell, P] multinomial weight matrix drawn
    with numpy (the same draws as phyml_tpu's, `rell_weights`), moved to
    the engine's device once; the products with every edge's three site
    vectors run there in float64.
  * The rapid bootstrap advances all replicates of a chunk together:
    the branch lengths of a stack of replicate trees in one launch per
    evaluation (K3 with a schedule per tree, K2/K5 with a tree axis),
    model parameters frozen.  The chunk is sized by the card's free
    memory (`rep_chunk_for`), not by phyml_tpu's TPU rule.
"""

from __future__ import annotations

from math import erfc, sqrt

import numpy as np
import torch

from phyml_tpu_torch.ops.likelihood import TreeArrays, tree_arrays
from phyml_tpu_torch.search.nni import candidate_arrays, nni_scores
from phyml_tpu_torch.utils import trace


# ----------------------------------------------------------------------
# aLRT / aBayes / SH (alrt.c)
# ----------------------------------------------------------------------

def _chi2_sf_1df(x):
    """Survival function of chi^2 with 1 df (no scipy dependency)."""
    return erfc(sqrt(max(x, 0.0) / 2.0))


# phyml_tpu's engine pads the pattern axis with zero-weight patterns to
# a multiple of this lane width (phyml_tpu/ops/likelihood.py:175-178, its
# CPU path); the RELL draws run over that padded vector
RELL_PAD = 128


def rell_weights(w, n_rell: int, seed: int) -> np.ndarray:
    """The RELL/SH resampling matrix [n_rell, P] float64: multinomial
    draws of the alignment's sites over the patterns (numpy,
    default_rng(seed)), one matrix shared by all edges (alrt.c draws
    fresh samples per edge; sharing only correlates edges, not the
    per-edge marginal distribution).  numpy's multinomial consumes its
    stream category by category, so the draws run over the pattern
    weights padded as phyml_tpu pads them (RELL_PAD): both packages draw
    the same matrix.  The padding columns are dropped (their patterns
    contribute nothing)."""
    P = len(w)
    wp = np.zeros(max(RELL_PAD, -(-P // RELL_PAD) * RELL_PAD))
    wp[:P] = w
    rng = np.random.default_rng(seed)
    W = rng.multinomial(int(round(wp.sum())), wp / wp.sum(), size=n_rell)
    return W[:, :P].astype(np.float64)


@trace.traced("support.alrt")
def alrt_supports(
    engine,
    model,
    params,
    topo,
    method: str = "abayes",
    n_rell: int = 10000,
    seed: int = 0,
    weights=None,
):
    """Per-internal-edge supports; returns {unrooted edge id: value}.

    method: 'alrt-stat' (raw 2*delta lnL), 'alrt-chi2' (1 - p under
    the 0.5 chi2_0 + 0.5 chi2_1 mixture), 'abayes', 'sh' (SH-aLRT),
    'rell'.
    """
    if method not in ("alrt-stat", "alrt-chi2", "abayes", "sh", "rell"):
        raise ValueError(f"unknown aLRT method {method!r}")
    rv = topo.rooted()
    ta = tree_arrays(rv, dtype=engine.dtype, device=engine.device)
    cand = candidate_arrays(rv)
    lnl_cfg, _, site = nni_scores(engine, params, ta, cand,
                                  weights=weights, return_site=True)
    w = trace.to_host(engine.gather_sites(engine._w(weights)),
                      "support.weights").numpy()
    out: dict[int, float] = {}

    if method in ("sh", "rell"):
        W = rell_weights(w, n_rell, seed)
        f64 = dict(dtype=torch.float64, device=engine.device)
        site_d = torch.as_tensor(site, **f64)                # [E, 3, P]
        # every edge's resampled totals [E, n_rell, 3], on the device
        sums = torch.einsum("bp,ekp->ebk", torch.as_tensor(W, **f64),
                            site_d)
        if method == "rell":
            rell = (sums[..., 0] >= sums[..., 1:].amax(-1)).double()
            frac = trace.to_host(rell.mean(-1), "support.frac").numpy()
        else:
            c = (site_d * torch.as_tensor(w, **f64)).sum(-1)  # [E, 3]
            srt = torch.sort(c, dim=-1, descending=True).values
            delta_obs = srt[:, 0] - srt[:, 1]
            s_srt = torch.sort(sums - c[:, None, :], dim=-1).values
            delta_local = s_srt[..., 2] - s_srt[..., 1]
            frac = trace.to_host((delta_obs[:, None] > delta_local)
                                 .double().mean(-1), "support.frac").numpy()
        del sums

    for k, row in enumerate(cand):
        v = int(row[0])
        eid = int(rv.node_to_edge[v])
        l0, l1, l2 = (float(x) for x in lnl_cfg[k])
        best_alt = max(l1, l2)
        stat = 2.0 * (l0 - best_alt)
        if l0 < best_alt - 1e-9 and method in ("alrt-stat",
                                               "alrt-chi2"):
            # NNI scoring re-optimized the five local branch lengths
            # (the scorer's joint Newton ≙ alrt.c:338 NNI_Neigh_BL);
            # if the current config STILL loses, the LRT statistic is
            # 0 by definition (aLRT assumes NNI-optimality, alrt.c).
            out[eid] = 0.0
            continue
        if method == "alrt-stat":
            out[eid] = stat
        elif method == "alrt-chi2":
            out[eid] = 1.0 - 0.5 * _chi2_sf_1df(stat)
        elif method == "abayes":
            m = max(l0, l1, l2)
            e = np.exp([l0 - m, l1 - m, l2 - m])
            out[eid] = float(e[0] / e.sum())
        else:
            out[eid] = float(frac[k])
    return out


# ----------------------------------------------------------------------
# Bootstrap (utilities.c:3884 / mpi_boot.c)
# ----------------------------------------------------------------------

def replicate_weights(engine, seed: int, rep: int,
                      bayesian: bool) -> np.ndarray:
    """Pattern weights [P] of replicate `rep`, drawn from seed + rep
    (≙ srand(seed+rank), main.c:84): multinomial over the original
    sites, or Dirichlet site weights (Bayesian bootstrap,
    stats.c:5236)."""
    aln = engine.aln
    rng = np.random.default_rng(seed + rep)
    if bayesian:
        site_w = rng.dirichlet(np.ones(aln.n_sites)) * aln.n_sites
        pat_w = np.zeros(aln.n_patterns)
        np.add.at(pat_w, aln.site_to_pattern, site_w)
        return pat_w
    return aln.resample_weights(rng)


def _count(counts, ref_bips, ref_masks, topo, n, tbe):
    """Add one replicate tree's support to counts: recovered
    bipartitions (Compare_Bip utilities.c:4972), or transfer distances
    (tbe=True)."""
    if tbe:
        rep_masks = _all_bip_masks(topo, n)
        for eid, mask in ref_masks.items():
            psz = min(mask.sum(), n - mask.sum())
            if psz <= 1:
                continue
            d = _min_transfer_dist(mask, rep_masks, n)
            counts[eid] += max(0.0, 1.0 - d / (psz - 1))
    else:
        rep_bips = set(topo.bipartitions().keys())
        for bip, eid in ref_bips.items():
            if bip in rep_bips:
                counts[eid] += 1.0


def bootstrap_supports(
    engine,
    model,
    params,
    best_topo,
    n_replicates: int = 100,
    search: str = "nni",
    seed: int = 0,
    bayesian: bool = False,
    tbe: bool = False,
    verbose: bool = False,
    keep_trees: bool = False,
    replicate_indices=None,
):
    """Bootstrap branch supports for best_topo's internal edges.

    Per replicate: resample pattern weights (replicate_weights), rebuild
    a BioNJ start, run the chosen search with the replicate's weights,
    count recovered bipartitions or accumulate transfer distances.
    Returns {edge id: support in [0, 1]} (plus the replicate trees if
    keep_trees).

    replicate_indices (optional): run only this subset of replicate
    ids; supports are then COUNTS (not divided) over that subset — the
    farming primitive of a distributed run."""
    from phyml_tpu_torch.search.bionj import bionj_start
    from phyml_tpu_torch.search.driver import nni_search, spr_search

    ref_bips = best_topo.bipartitions()
    counts = {eid: 0.0 for eid in ref_bips.values()}
    n = best_topo.n_otu
    trees = []
    partial = replicate_indices is not None
    reps = (range(n_replicates) if replicate_indices is None
            else list(replicate_indices))
    ref_masks = _bip_masks(best_topo, ref_bips, n)
    searcher = spr_search if search == "spr" else nni_search

    for rep in reps:
        wrep = torch.as_tensor(replicate_weights(engine, seed, rep, bayesian),
                               dtype=torch.float64, device=engine.device)
        p_rep = dict(params)
        topo = bionj_start(engine, p_rep, weights=wrep)
        topo, p_rep, lnl = searcher(engine, model, p_rep, topo,
                                    weights=wrep)
        if keep_trees:
            trees.append(topo)
        _count(counts, ref_bips, ref_masks, topo, n, tbe)
        if verbose:
            print(f"  bootstrap replicate {rep + 1}/{n_replicates}: "
                  f"lnL {lnl:.3f}")

    if partial:
        return (counts, trees) if keep_trees else counts
    support = {eid: c / n_replicates for eid, c in counts.items()}
    return (support, trees) if keep_trees else support


def _bip_masks(topo, bips, n):
    out = {}
    for bip, eid in bips.items():
        m = np.zeros(n, dtype=bool)
        m[list(bip)] = True
        out[eid] = m
    return out


def _all_bip_masks(topo, n):
    return np.stack([
        _mask_of(bip, n) for bip in topo.bipartitions().keys()
    ]) if topo.n_otu > 3 else np.zeros((0, n), dtype=bool)


def _mask_of(bip, n):
    m = np.zeros(n, dtype=bool)
    m[list(bip)] = True
    return m


def _min_transfer_dist(mask, rep_masks, n):
    """Transfer distance of one reference bipartition to a replicate
    tree = min Hamming distance over the replicate's bipartitions and
    their complements (tbe.c; Lemoine et al. 2018)."""
    if len(rep_masks) == 0:
        return min(mask.sum(), n - mask.sum())
    xor = rep_masks ^ mask
    h = xor.sum(axis=1)
    return int(np.minimum(h, n - h).min())


# the rapid bootstrap's working set per replicate, in [n_nodes, C, ns, P]
# tensors of the engine's dtype: the NNI scorer's peak, ~17 of them
# (0.99 / 5.04 GiB a 128 x 4096 tree, DNA / protein, PERF.md §5), above
# the branch-length Newton's ~12 (d, the terms' temporaries, K2/K5's
# workspace)
REP_TENSORS = 18
# the share of free memory a chunk may take
REP_MEMORY_SHARE = 0.5
# the budget on the CPU, which has no free-memory query of its own
CPU_REP_BUDGET = 4 * 2 ** 30


def rep_chunk_for(engine, n_replicates: int) -> int:
    """Replicates one batch of the rapid bootstrap holds: the card's
    free memory (torch.cuda.mem_get_info) times REP_MEMORY_SHARE, or
    CPU_REP_BUDGET on the CPU, over the per-replicate working set of
    REP_TENSORS [n_nodes, C, ns, P] tensors."""
    per_rep = REP_TENSORS * engine.n_nodes * engine.C * engine.ns \
        * engine.P * torch.finfo(engine.dtype).bits // 8
    if engine.device.type == "cuda":
        budget = torch.cuda.mem_get_info(engine.device)[0] \
            * REP_MEMORY_SHARE
    else:
        budget = CPU_REP_BUDGET
    return max(1, min(n_replicates, int(budget // per_rep)))


def bootstrap_supports_batched(
    engine,
    model,
    params,
    best_topo,
    n_replicates: int = 100,
    seed: int = 0,
    bayesian: bool = False,
    tbe: bool = False,
    verbose: bool = False,
    keep_trees: bool = False,
    max_rounds: int = 25,
    min_gain: float = 1e-4,
    rep_chunk: int | None = None,
):
    """Batched bootstrap: all replicates of a chunk advance together.

    Per round, every replicate's branch-length optimization runs as one
    stacked optimization (optimize_branch_lengths_batched) and every
    replicate's NNI candidates are scored (nni_scores_batched); the
    host applies each replicate's best node-disjoint swaps.  Model
    parameters stay FROZEN at the ML estimates — the rapid-bootstrap
    approximation; bootstrap_supports re-estimates them per replicate
    (the reference's exact behavior) at serial cost.  Returns {edge id:
    support in [0, 1]}.

    rep_chunk bounds how many replicates ride in one batch (default
    rep_chunk_for); per-replicate seeding makes the chunked result
    identical to the single-batch one.
    """
    from phyml_tpu_torch.optim.blen import optimize_branch_lengths_batched
    from phyml_tpu_torch.search.bionj import bionj_start
    from phyml_tpu_torch.search.nni import (
        _apply_swaps, _select_disjoint, nni_scores_batched,
    )

    if rep_chunk is None:
        rep_chunk = rep_chunk_for(engine, n_replicates)
    if rep_chunk < n_replicates:
        counts_all: dict = {}
        trees_all: list = []
        done = 0
        while done < n_replicates:
            m = min(rep_chunk, n_replicates - done)
            out = bootstrap_supports_batched(
                engine, model, params, best_topo, n_replicates=m,
                seed=seed + done, bayesian=bayesian, tbe=tbe,
                verbose=verbose, keep_trees=keep_trees,
                max_rounds=max_rounds, min_gain=min_gain,
                rep_chunk=m)
            sup = out[0] if keep_trees else out
            for eid, s in sup.items():
                counts_all[eid] = counts_all.get(eid, 0.0) + s * m
            if keep_trees:
                trees_all.extend(out[1])
            done += m
        supports = {eid: c / n_replicates
                    for eid, c in counts_all.items()}
        return (supports, trees_all) if keep_trees else supports

    n = best_topo.n_otu
    ref_bips = best_topo.bipartitions()
    counts = {eid: 0.0 for eid in ref_bips.values()}
    ref_masks = _bip_masks(best_topo, ref_bips, n)

    # replicate weight matrix (per-replicate seeding as in the serial
    # path, so both paths draw identical replicates)
    W = torch.as_tensor(
        np.stack([replicate_weights(engine, seed, rep, bayesian)
                  for rep in range(n_replicates)]),
        dtype=torch.float64, device=engine.device)

    # starting trees (BioNJ per replicate; distances on the device)
    topos = [bionj_start(engine, params, weights=W[r])
             for r in range(n_replicates)]
    active = np.ones(n_replicates, dtype=bool)
    dev = dict(dtype=engine.dtype, device=engine.device)

    for rnd in range(max_rounds):
        # only the replicates still climbing ride in the batch: a
        # finished one's tree no longer changes (phyml_tpu scores it on
        # and discards the result)
        live = np.flatnonzero(active)
        rvs = [topos[r].rooted() for r in live]
        tas = [tree_arrays(rv, **dev) for rv in rvs]
        trees = TreeArrays(child=torch.stack([t.child for t in tas]),
                           blen=torch.stack([t.blen for t in tas]))
        W_live = W[torch.as_tensor(live, device=W.device)]
        trees, _ = optimize_branch_lengths_batched(engine, params, trees,
                                                   W_live)
        blens = trace.to_host(trees.blen.double(), "support.blen").numpy()
        cands = np.stack([candidate_arrays(rv) for rv in rvs])
        lnl_cfg, t_opt = nni_scores_batched(engine, params, trees, cands,
                                            W_live)
        n_changed = 0
        for j, r in enumerate(live):
            topos[r].set_blen_from_rooted(rvs[j], blens[j])
            gains = lnl_cfg[j][:, 1:] - lnl_cfg[j][:, [0]]
            chosen = _select_disjoint(cands[j], gains, min_gain)
            if not chosen:
                active[r] = False
                continue
            topos[r] = _apply_swaps(
                topos[r].copy(), rvs[j], cands[j], chosen,
                tuple(t[j] for t in t_opt))
            n_changed += 1
        if verbose:
            print(f"  boot round {rnd}: {int(active.sum())} active, "
                  f"{n_changed} changed")
        if not active.any():
            break

    for topo in topos:
        _count(counts, ref_bips, ref_masks, topo, n, tbe)
    supports = {eid: c / n_replicates for eid, c in counts.items()}
    return (supports, topos) if keep_trees else supports
