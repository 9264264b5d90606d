"""Simultaneous NNI hill-climbing, all edges scored in one pass.

PyTorch port of phyml_tpu/search/nni.py.  The reference's NNI
machinery (Simu simu.c:30, Check_NNI_Five_Branches alrt.c:32) walks
edges one at a time, each evaluation touching the tree in place.  Here
every internal edge's three configurations are scored from ONE up+down
likelihood pass (the engine's scan path): for the edge (u, v) with
children a, b of v and sibling s, using the cached inside partials
(pup) and outside partials (out),

    L_cfg(t) = sum_i (Vinv x_cfg)_i (V^T y_cfg)_i e^{lam_i t}

with (x, y) = (A.B, G.S) | (A.S, G.B) | (B.S, G.A) - the eigen-LR
dot-product trick applied to all three NNI configurations of all
edges at once, as tensors [E, 3, C, ns, P], followed by vectorized
Newton on every configuration's four local branch lengths (the
reference optimizes the central edge per NNI too: NNI_Neigh_BL
alrt.c:338).

Swap application follows the reference's "simultaneous NNI" strategy
(Make_N_Swap simu.c:229): sort positive-gain swaps, greedily apply a
node-disjoint subset, re-optimize branch lengths, and fall back to
the single best swap if the joint application hurt the likelihood.
"""

from __future__ import annotations

import numpy as np
import torch

from phyml_tpu_torch.models.eigen import pmat
from phyml_tpu_torch.ops.likelihood import TreeArrays, tree_arrays
from phyml_tpu_torch.optim.blen import BL_MAX, BL_MIN, optimize_branch_lengths
from phyml_tpu_torch.utils import trace


def candidate_arrays(rv):
    """Host-side: for each internal unrooted edge, the rooted ids
    (v, u, a, b, s).  Shape is always [n_otu - 3, 5]."""
    n = rv.n_otu
    rows = []
    for v in range(n, rv.n_nodes - 1):
        u = int(rv.parent[v])
        if u == rv.root:
            continue
        i_v = v - n
        a, b = (int(x) for x in rv.child[i_v])
        i_u = u - n
        c0, c1 = (int(x) for x in rv.child[i_u])
        s = c1 if c0 == v else c0
        rows.append((v, u, a, b, s))
    out = np.asarray(rows, dtype=np.int32)
    assert out.shape == (n - 3, 5)
    return out


@trace.traced("nni.newton")
def _newton(engine, d, sc_d, aux, t, iters=5):
    """Safeguarded Newton on every configuration's length t [E, 3]."""
    return engine.newton_solve(d, sc_d, aux, t, iters)


@trace.traced("nni.score")
def _nni_scorer(engine, sys, tree: TreeArrays, cand, weights):
    """Scores every internal edge's 3 configurations with the FOUR
    local branch lengths (central + the three adjacent pendants)
    jointly optimized by coordinate Newton - the batched equivalent
    of the reference's 5-branch NNI evaluation (alrt.c:32
    Check_NNI_Five_Branches; only the grandparent edge u stays
    fixed).  Returns (lnl [E, 3] float64, (t1, t2, t3, tc), site
    [E, 3, P]).

    A stack of R trees (the rapid bootstrap's replicates: child
    [R, n_int, 2], blen [R, n_nodes], cand [R, E, 5], weights [R, P])
    runs the passes once for all trees (_up_pass's stacked form) and
    scores the R * E edges as one batch of rows; results [R, E, ...]."""
    lam, V, Vinv, pi, w, pinv = sys
    blen = tree.blen.to(engine.dtype)
    pmats = engine._pmats(lam, V, Vinv, blen)
    pup, clv, sc = engine._up_pass(pmats, tree.child)
    out, sc_out = engine._down_pass(pmats, tree.child, pup, sc, pi)
    del pup

    C, ns = engine.C, engine.ns
    lead = np.shape(cand)[:-1]              # (E,), or (R, E) for a stack
    E = int(np.prod(lead))

    def newton(d, t):
        sc_d = sc_tot[:, None].expand(d.shape[:2] + sc_tot.shape[1:])
        return _newton(engine, d, sc_d, aux, t)

    def dots(x, y):
        bx = torch.einsum("ciy,ekcyp->ekcip", Vinv, x)
        ay = torch.einsum("czi,ekczp->ekcip", V, y)
        return ay * bx

    def P_of(t):
        """t [E, 3] -> P [E, 3, C, ns, ns]."""
        p = pmat(lam, V, Vinv, t.reshape(-1)[:, None].expand(-1, C))
        return p.reshape(E, 3, C, ns, ns)

    def push(P, x):
        return torch.einsum("ekcxy,ekcyp->ekcxp", P, x)

    def pushT(P, x):
        return torch.einsum("ekcyx,ekcyp->ekcxp", P, x)

    with trace.span("nni.outside"):
        cand = torch.as_tensor(np.asarray(cand), dtype=torch.long,
                               device=engine.device).reshape(-1, 5)
        aux = engine._aux(sys, weights)
        if len(lead) == 2:
            # row r * E + e is edge e of tree r
            rows = torch.arange(lead[0], device=engine.device) \
                .repeat_interleave(lead[1])
            at = lambda x, k: x[rows, k]
            aux["weights"] = aux["weights"][rows][:, None, :]
        else:
            at = lambda x, k: x[k]
        v, u, a, b, s = (cand[:, k] for k in range(5))
        # out[v] = (P_u^T out[u]) . pup[s]: the config-independent
        # outside factor above the central edge
        G = torch.einsum("ecwz,ecwp->eczp", at(pmats, u), at(out, u))
        sc_tot = at(sc, a) + at(sc, b) + at(sc, s) + at(sc_out, u)
        # per-config subtree roles: children (x1, x2) and sibling x3
        ca, cb, cs = at(clv, a), at(clv, b), at(clv, s)
        C1 = torch.stack([ca, ca, cb], 1)                # [E, 3, C, ns, P]
        C2 = torch.stack([cb, cs, cs], 1)
        C3 = torch.stack([cs, cb, ca], 1)
        del clv, out, ca, cb, cs
        la, lb, ls = at(blen, a), at(blen, b), at(blen, s)
        t1 = torch.stack([la, la, lb], 1)
        t2 = torch.stack([lb, ls, ls], 1)
        t3 = torch.stack([ls, lb, la], 1)
        tc = at(blen, v)[:, None].expand(E, 3)
        t1, t2, t3, tc = (torch.clamp(t, BL_MIN, BL_MAX)
                          for t in (t1, t2, t3, tc))
        Gb = G[:, None]                                  # [E, 1, C, ns, P]

    for _ in range(2):
        with trace.span("nni.sweep"):
            Q1 = push(P_of(t1), C1)
            Q2 = push(P_of(t2), C2)
            Q3 = push(P_of(t3), C3)
            # central edge
            tc = newton(dots(Q1 * Q2, Gb * Q3), tc)
            Pc = P_of(tc)
            # pendant 1: W = Pc^T (G.Q3)
            W = pushT(Pc, Gb * Q3)
            t1 = newton(dots(C1, W * Q2), t1)
            Q1 = push(P_of(t1), C1)
            # pendant 2
            t2 = newton(dots(C2, W * Q1), t2)
            Q2 = push(P_of(t2), C2)
            # pendant 3 (sibling)
            t3 = newton(dots(C3, Gb * push(Pc, Q1 * Q2)), t3)
            del W, Q3
    with trace.span("nni.final"):
        Q1 = push(P_of(t1), C1)
        Q2 = push(P_of(t2), C2)
        Q3 = push(P_of(t3), C3)
        d = dots(Q1 * Q2, Gb * Q3)
        sc_d = sc_tot[:, None].expand(d.shape[:2] + sc_tot.shape[1:])
        site, _, _ = engine.edge_site_terms(d, sc_d, aux, tc)
        lnl = engine._sum_sites(torch.sum(site.double() * aux["weights"],
                                          dim=-1))                # [E, 3]
    return lnl.reshape(lead + (3,)), \
        tuple(t.reshape(lead + (3,)) for t in (t1, t2, t3, tc)), \
        site.reshape(lead + (3, -1))


def nni_scores(engine, params, tree: TreeArrays, cand: np.ndarray,
               weights=None, return_site=False):
    """(lnl [E, 3], (t1, t2, t3, tc) each [E, 3][, site [E, 3, P]]):
    likelihood of the current config (col 0) and both NNI alternatives
    (cols 1, 2) of every internal edge, the four local branch lengths
    optimized, as numpy.  return_site=True adds the per-site
    log-likelihoods (the reference's log_lks_aLRT; a sharded engine's
    gathered over its ranks)."""
    lnl, ts, site = _nni_scorer(engine, engine.system_of(params), tree,
                                cand, engine._w(weights))
    out = (trace.to_host(lnl, "nni.lnl").numpy(),
           tuple(trace.to_host(t, "nni.lengths").numpy() for t in ts))
    if return_site:
        out = out + (trace.to_host(engine.gather_sites(site),
                                   "nni.site").numpy(),)
    return out


def nni_scores_batched(engine, params, trees: TreeArrays, cands, weights):
    """NNI scoring for a stack of R replicates: trees stacked TreeArrays
    (child [R, n_int, 2], blen [R, n_nodes]), cands [R, E, 5], weights
    [R, P].  Returns (lnl [R, E, 3], t_opt tuple of [R, E, 3]) as numpy.

    phyml_tpu vmaps its scorer over the replicates; here one call of
    the scorer takes the stack (its scan passes gather each tree's
    children step by step, and the R * E edges are scored as one
    batch)."""
    lnl, ts, _ = _nni_scorer(engine, engine.system_of(params), trees,
                             cands, weights)
    return trace.to_host(lnl, "nni.lnl").numpy(), \
        tuple(trace.to_host(t, "nni.lengths").numpy() for t in ts)


def _apply_swaps(topo, rv, cand, chosen, t_opt):
    """Apply the chosen (edge_index, cfg) swaps on the host topology.
    cfg 1 swaps b<->s, cfg 2 swaps a<->s.  t_opt = (t1, t2, t3, tc)
    arrays from nni_scores; all four local branch lengths are written
    (per-config role order: cfg1 -> (a, s | b), cfg2 -> (b, s | a),
    cfg0 -> (a, b | s))."""
    t1, t2, t3, tc = t_opt
    uid = rv.unrooted_id
    roles = {0: ("a", "b", "s"), 1: ("a", "s", "b"), 2: ("b", "s", "a")}
    for ei, cfg in chosen:
        v, u, a, b, s = (int(x) for x in cand[ei])
        mover = b if cfg == 1 else a
        topo = topo.swap_across(
            int(rv.node_to_edge[mover]), int(uid[mover]),
            int(rv.node_to_edge[s]), int(uid[s]),
        )
        # post-swap, each moved subtree hangs on the OTHER's edge id
        e_a, e_b, e_s = (int(rv.node_to_edge[x]) for x in (a, b, s))
        if cfg == 1:        # b <-> s
            edge_of = {"a": e_a, "b": e_s, "s": e_b}
        else:               # a <-> s
            edge_of = {"a": e_s, "b": e_b, "s": e_a}
        r1, r2, r3 = roles[cfg]
        topo.blen[int(rv.node_to_edge[v])] = float(tc[ei, cfg])
        topo.blen[edge_of[r1]] = float(t1[ei, cfg])
        topo.blen[edge_of[r2]] = float(t2[ei, cfg])
        topo.blen[edge_of[r3]] = float(t3[ei, cfg])
    return topo


def _select_disjoint(cand, gains, min_gain):
    """Greedy best-first selection of node-disjoint positive swaps.
    Returns list of (edge_index, cfg)."""
    order = np.dstack(np.unravel_index(
        np.argsort(-gains, axis=None), gains.shape
    ))[0]
    used: set[int] = set()
    chosen = []
    for ei, k in order:
        cfg = k + 1
        if gains[ei, k] <= min_gain:
            break
        nodes = set(int(x) for x in cand[ei])
        if nodes & used:
            continue
        used |= nodes
        chosen.append((int(ei), int(cfg)))
    return chosen


def _host_blen(tree: TreeArrays) -> np.ndarray:
    return trace.to_host(tree.blen.double(), "nni.blen").numpy()


def nni_round(engine, params, topo, lnl0=None, min_gain: float = 1e-4,
              blen_tol: float = 1e-4, weights=None, accept_topo=None):
    """One simultaneous-NNI round: optimize branch lengths, score all
    edges, apply the best node-disjoint set of improving swaps (with
    single-swap fallback).  Returns (topo, lnL, n_applied).

    accept_topo (optional): predicate on the post-swap Topology;
    swaps whose application would violate it are dropped."""
    dev = dict(dtype=engine.dtype, device=engine.device)
    rv = topo.rooted()
    ta = tree_arrays(rv, **dev)
    ta, lnl = optimize_branch_lengths(engine, params, ta, tol=blen_tol,
                                      weights=weights)
    topo.set_blen_from_rooted(rv, _host_blen(ta))

    cand = candidate_arrays(rv)
    lnl_cfg, t_opt = nni_scores(engine, params, ta, cand,
                                weights=weights)
    gains = lnl_cfg[:, 1:] - lnl_cfg[:, [0]]
    chosen = _select_disjoint(cand, gains, min_gain)
    if accept_topo is not None:
        chosen = [
            mv for mv in chosen
            if accept_topo(_apply_swaps(topo.copy(), rv, cand, [mv],
                                        t_opt))
        ]
    if not chosen:
        return topo, lnl, 0

    new_topo = _apply_swaps(topo.copy(), rv, cand, chosen, t_opt)
    ta2 = tree_arrays(new_topo.rooted(), **dev)
    ta2, lnl2 = optimize_branch_lengths(engine, params, ta2,
                                        tol=blen_tol, weights=weights)
    if lnl2 <= lnl and len(chosen) > 1:
        # joint application hurt: fall back to the best single swap
        # (reference: Mov_Backward_Topo_Bl simu.c:395)
        chosen = chosen[:1]
        new_topo = _apply_swaps(topo.copy(), rv, cand, chosen, t_opt)
        ta2 = tree_arrays(new_topo.rooted(), **dev)
        ta2, lnl2 = optimize_branch_lengths(engine, params, ta2,
                                            tol=blen_tol,
                                            weights=weights)
    if lnl2 <= lnl:
        return topo, lnl, 0
    new_topo.set_blen_from_rooted(new_topo.rooted(), _host_blen(ta2))
    return new_topo, lnl2, len(chosen)
