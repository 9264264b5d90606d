"""Branch-length optimization: all edges at once.

The reference optimizes one edge at a time with Newton steps on the
eigen-LR reparameterized likelihood (Br_Len_Opt optimiz.c:607,
Br_Len_Spline optimiz.c:2244, dLk lk.c:655), sweeping edges in post-
order (Optimize_Br_Len_Serie optimiz.c:714).  Here, as in phyml_tpu,
each round is:

  1. one up+down pass producing every edge's eigen-basis dot products
     (LikelihoodEngine.edge_dotprods_sys, kernel K2),
  2. a fixed number of safeguarded Newton iterations on ALL edge
     lengths in parallel (each edge maximizing the tree likelihood as
     a function of its own length, others held fixed - block-Jacobi),
  3. a global backtracking line search toward the previous lengths if
     the joint update overshot (the reference instead error-exits on
     non-monotonicity, optimiz.c:656-661; Jacobi coupling makes a
     safeguard mandatory here); each probe is one single-parameter-set
     pass (K1, or K4 when streamed; K3 at B = 1 where K4's block does
     not fit, `likelihood.single_pass_kernel`).

Rounds repeat until the gain is below tol.  The backtracking and the
round loop run on the host, reading one lnL per evaluation.

`optimize_branch_lengths_batched` runs the same optimization for a
stack of R replicate trees, each with its own pattern weights (the rapid
bootstrap; phyml_tpu vmaps its on-device loop over them).  Each
evaluation is one launch for the trees still running: K2/K5 with a tree
axis, K3 with a slot schedule per tree.
"""

from __future__ import annotations

import numpy as np
import torch

from phyml_tpu_torch.ops.likelihood import TreeArrays
from phyml_tpu_torch.ops.newton import BL_MAX, BL_MIN
from phyml_tpu_torch.utils import trace

_N_NEWTON = 10
_MAX_BACKTRACK = 15


@trace.traced("blen.newton")
def _newton_all_edges(engine, d, sc_d, aux, t0, mask):
    trace.count("blen.newton_iters", _N_NEWTON)
    return engine.newton_solve(d, sc_d, aux, t0, _N_NEWTON, mask)


@trace.traced("blen.round")
def _round(engine, sys, tree: TreeArrays, lnl0: float, weights):
    """One Newton round with backtracking; returns (tree, lnL) and
    never a worse tree than it started from."""
    trace.count("blen.rounds")
    d, sc_d, aux = engine.edge_dotprods_sys(sys, tree, weights)
    n_nodes = engine.n_nodes
    idx = torch.arange(n_nodes, device=tree.blen.device)
    zero_child = int(tree.child[-1, 1])  # root's zero-length side
    mask = (idx != n_nodes - 1) & (idx != zero_child)

    t0 = tree.blen
    t1 = _newton_all_edges(engine, d, sc_d, aux,
                           torch.clamp(t0, BL_MIN, BL_MAX), mask)
    t = torch.where(mask, t1, t0)

    def lnl_at(t):
        return float(trace.to_host(engine._loglik_sys(
            sys, TreeArrays(tree.child, t), weights), "blen.probe"))

    lnl = lnl_at(t)
    k = 0
    while lnl < lnl0 and k < _MAX_BACKTRACK:
        t = torch.where(mask, 0.5 * (t + t0), t0)
        lnl = lnl_at(t)
        k += 1
        trace.count("blen.backtracks")
    if lnl < lnl0:
        return tree, lnl0
    return TreeArrays(tree.child, t), lnl


@trace.traced("blen.optimize")
def optimize_branch_lengths(
    engine,
    params,
    tree: TreeArrays,
    tol: float = 1e-4,
    max_rounds: int = 32,
    weights=None,
):
    """Maximize lnL over all branch lengths; returns (tree, lnL).

    tol: stop when a full parallel-Newton round gains less than this
    many log units (reference default min_diff_lk_local = 1e-5 with
    per-edge Brent tolerances much looser).
    """
    sys = engine.system_of(params)
    weights = engine.weights if weights is None else weights
    lnl0 = float(trace.to_host(engine._loglik_sys(sys, tree, weights),
                               "blen.start"))
    tree, lnl = _round(engine, sys, tree, lnl0, weights)
    prev, i = lnl0, 1
    while i < max_rounds and lnl - prev >= tol:
        prev = lnl
        tree, lnl = _round(engine, sys, tree, lnl, weights)
        i += 1
    return tree, lnl


@trace.traced("blen.round")
def _round_batched(engine, sys, tree: TreeArrays, lnl0, weights):
    """_round for a stack of trees (weights [R, P], lnl0 [R] host
    float64), each replicate with its own backtracking and guard, as
    phyml_tpu's jax.vmap of one round: a replicate whose probe no longer
    loses stops backtracking while the others go on.  Returns (stacked
    tree, lnL [R] host float64)."""
    trace.count("blen.rounds")
    d, sc_d, aux = engine.edge_dotprods_sys(sys, tree, weights)
    n_nodes = engine.n_nodes
    dev = tree.blen.device
    idx = torch.arange(n_nodes, device=dev)
    zero_child = torch.as_tensor(tree.child[:, -1, 1].long(), device=dev)
    mask = (idx != n_nodes - 1)[None] & (idx[None] != zero_child[:, None])

    t0 = tree.blen
    t1 = _newton_all_edges(engine, d, sc_d, aux,
                           torch.clamp(t0, BL_MIN, BL_MAX), mask)
    del d, sc_d
    t = torch.where(mask, t1, t0)

    def lnl_at(rows, t_rows):
        sub = TreeArrays(tree.child[torch.as_tensor(rows)], t_rows)
        w = weights[torch.as_tensor(rows, device=weights.device)]
        return trace.to_host(engine._loglik_sys(sys, sub, w).double(),
                             "blen.probe").numpy()

    all_rows = np.arange(t.shape[0])
    lnl = lnl_at(all_rows, t)
    for _ in range(_MAX_BACKTRACK):
        rows = np.flatnonzero(lnl < lnl0)
        if rows.size == 0:
            break
        r = torch.as_tensor(rows, device=dev)
        t[r] = torch.where(mask[r], 0.5 * (t[r] + t0[r]), t0[r])
        lnl[rows] = lnl_at(rows, t[r])
        trace.count("blen.backtracks")
    # final guard: never a worse tree than a replicate started from
    worse = lnl < lnl0
    if worse.any():
        r = torch.as_tensor(np.flatnonzero(worse), device=dev)
        t[r] = t0[r]
        lnl = np.where(worse, lnl0, lnl)
    return TreeArrays(tree.child, t), lnl


@trace.traced("blen.optimize")
def optimize_branch_lengths_batched(engine, params, trees: TreeArrays,
                                    weights, tol: float = 1e-4,
                                    max_rounds: int = 32):
    """All replicates' branch-length optimization: trees is a stack of
    TreeArrays (child [R, n_int, 2], blen [R, n_nodes]), weights [R, P].
    Each replicate runs optimize_branch_lengths's rounds under its own
    weights and stops on its own gain; the replicates still running
    share every launch.  Returns (stacked trees, lnL [R] numpy)."""
    sys = engine.system_of(params)
    weights = torch.as_tensor(weights, dtype=torch.float64,
                              device=engine.device)
    dev = trees.blen.device
    lnl0 = trace.to_host(engine._loglik_sys(sys, trees, weights).double(),
                         "blen.start").numpy()
    trees, lnl = _round_batched(engine, sys, trees, lnl0, weights)
    child, blen = trees
    prev, i = lnl0, 1
    active = (lnl - prev) >= tol
    while i < max_rounds and active.any():
        rows = np.flatnonzero(active)
        r = torch.as_tensor(rows, device=dev)
        sub, lnl_sub = _round_batched(
            engine, sys, TreeArrays(child[torch.as_tensor(rows)], blen[r]),
            lnl[rows],
            weights[torch.as_tensor(rows, device=weights.device)])
        blen = blen.clone()
        blen[r] = sub.blen
        prev = prev.copy()
        prev[rows] = lnl[rows]
        lnl = lnl.copy()
        lnl[rows] = lnl_sub
        i += 1
        active = active & ((lnl - prev) >= tol)
    return TreeArrays(child, blen), lnl
