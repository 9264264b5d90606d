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
"""

from __future__ import annotations

import torch

from phyml_tpu_torch.ops.likelihood import TreeArrays

BL_MIN = 1e-8   # utilities.h:483
BL_MAX = 100.0  # utilities.h:484
_N_NEWTON = 10
_MAX_BACKTRACK = 15


def _newton_all_edges(engine, d, sc_d, aux, t0, mask):
    t = t0
    for _ in range(_N_NEWTON):
        _, d1, d2 = engine.edge_lnl_terms(d, sc_d, aux, t)
        newton = t - d1 / torch.where(d2 < 0, d2, -1.0)
        # fall back to a multiplicative probe when curvature is
        # useless; clamp each step to a factor-of-3 move
        probe = torch.where(d1 > 0, t * 3.0, t / 3.0)
        t_new = torch.where(d2 < -1e-12, newton, probe)
        t_new = torch.minimum(torch.maximum(t_new, t / 3.0), t * 3.0)
        t_new = torch.clamp(t_new, BL_MIN, BL_MAX)
        # edge_lnl_terms accumulates in float64; keep t at the engine
        # dtype
        t = torch.where(mask, t_new, t0).to(t0.dtype)
    return t


def _round(engine, sys, tree: TreeArrays, lnl0: float, weights):
    """One Newton round with backtracking; returns (tree, lnL) and
    never a worse tree than it started from."""
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
        return float(engine._loglik_sys(sys, TreeArrays(tree.child, t),
                                        weights))

    lnl = lnl_at(t)
    k = 0
    while lnl < lnl0 and k < _MAX_BACKTRACK:
        t = torch.where(mask, 0.5 * (t + t0), t0)
        lnl = lnl_at(t)
        k += 1
    if lnl < lnl0:
        return tree, lnl0
    return TreeArrays(tree.child, t), lnl


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
    lnl0 = float(engine._loglik_sys(sys, tree, weights))
    tree, lnl = _round(engine, sys, tree, lnl0, weights)
    prev, i = lnl0, 1
    while i < max_rounds and lnl - prev >= tol:
        prev = lnl
        tree, lnl = _round(engine, sys, tree, lnl, weights)
        i += 1
    return tree, lnl
