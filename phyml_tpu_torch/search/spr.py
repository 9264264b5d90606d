"""SPR search: exact all-target regraft scoring from one masked pass.

PyTorch port of phyml_tpu/search/spr.py.  The reference's SPR cycle
(spr.c:136 Spr, :226 Spr_Subtree, :369 Test_All_Spr_Targets) prunes a
subtree, walks candidate regraft edges out to a depth bound, and
rescopes each by updating partials along the path.  Here the walk is
replaced by closed-form batch scoring:

  * "Prune" is a mask, not surgery: the likelihood pass treats the
    pruned child as a unit factor, which (because P(a)P(b) = P(a+b))
    yields exactly the healed tree's inside partials I_e and outside
    partials O_e at EVERY edge in one up+down pass (the engine's
    masked scan path).
  * Inserting the pruned subtree (root partial clv_p, pendant length
    t_p) into edge e, splitting its length t_e into halves, scores as

      L(e, t_p) = sum_i (Vinv clv_p)_i (V^T M_e)_i exp(lam_i t_p),
      M_e = (P(t_e/2)^T O_e) . (P(t_e/2) I_e)

    for ALL edges e simultaneously, followed by vectorized Newton on
    every target's three junction lengths.
  * Regrafting onto the pruned edge's two remnant half-edges scores
    the current topology, so "best target" >= "stay" falls out of the
    same computation.
  * A block of prune candidates shares one child table and one set of
    P-matrices: the masked passes and the Newton steps carry a
    candidate axis, so one call scores the block.

A sweep visits every prunable subtree in random order (the reference
randomizes edge order too, spr.c:764) and applies improving moves
block by block.
"""

from __future__ import annotations

import numpy as np
import torch

from phyml_tpu_torch.models.eigen import pmat
from phyml_tpu_torch.ops.likelihood import TreeArrays, tree_arrays
from phyml_tpu_torch.optim.blen import BL_MAX, BL_MIN


def _spr_scorer(engine, sys, tree: TreeArrays, masks, vs, valids,
                weights):
    """Per (candidate k, target edge e) the regraft lnL with the triple
    lengths optimized, for K candidates in one call: masks [K, n_int,
    2], vs [K], valids [K, n_nodes].  The candidates share the tree's
    P-matrices; the work runs node-major ([n_nodes, K, ...], the masked
    passes' storage).  Returns (lnl, t1, t2, tp) [K, n_nodes]."""
    lam, V, Vinv, pi, w, pinv = sys
    blen = tree.blen.to(engine.dtype)
    pmats = engine._pmats(lam, V, Vinv, blen)
    pup, clv, sc = engine._up_pass(pmats, tree.child, masks)
    out, sc_out = engine._down_pass(pmats, tree.child, pup, sc, pi,
                                    masks)
    del pup
    clv, sc, out, sc_out = (x.movedim(1, 0) for x in (clv, sc, out,
                                                      sc_out))
    aux = engine._aux(sys, weights)
    C, ns, N = engine.C, engine.ns, engine.n_nodes
    K = len(vs)
    kk = torch.arange(K, device=engine.device)
    v = torch.as_tensor(np.asarray(vs), dtype=torch.long,
                        device=engine.device)
    sc_base = sc + sc_out + sc[v, kk][None]              # [N, K, C, P]
    P_v = clv[v, kk]                                     # [K, C, ns, P]
    del sc, sc_out
    # Vinv clv_p, the pruned subtree's side of every target's dots
    b_v = torch.einsum("ciy,kcyp->kcip", Vinv, P_v)[None]

    def P_of(t):
        """t [N, K] -> P [N, K, C, ns, ns]."""
        p = pmat(lam, V, Vinv,
                 t.to(engine.dtype).reshape(-1)[:, None].expand(-1, C))
        return p.reshape(N, K, C, ns, ns)

    def dots(x, y):
        """d such that sum_i d_i e^{lam_i t} = sum_z y . P(t) x,
        batched over targets and candidates."""
        bx = torch.einsum("ciy,ekcyp->ekcip", Vinv, x)
        return torch.einsum("czi,ekczp->ekcip", V, y) * bx

    def dots_v(y):
        return torch.einsum("czi,ekczp->ekcip", V, y) * b_v

    def newton(d, t):
        return engine.newton_solve(d, sc_base, aux, t, 6)

    def inside(t1):
        return torch.einsum("ekcxy,ekcyp->ekcxp", P_of(t1), clv)

    def outside(t2):
        return torch.einsum("ekcwz,ekcwp->ekczp", P_of(t2), out)

    # "triple" optimization (reference spr.c:1139): coordinate Newton
    # over (t1 inside-half, t2 outside-half, tp pendant) for every
    # target edge of every candidate at once
    half = torch.clamp(blen * 0.5, BL_MIN, BL_MAX)[:, None]
    t1 = half.expand(N, K)
    t2 = half.expand(N, K)
    tp = torch.clamp(blen[v], BL_MIN, BL_MAX)[None].expand(N, K)
    for _ in range(2):
        I1 = inside(t1)
        O2 = outside(t2)
        # pendant length tp: y = O2 . I1, x = clv_p
        tp = newton(dots_v(O2 * I1), tp)
        Pp = torch.einsum("ekcxy,kcyp->ekcxp", P_of(tp), P_v)
        # inside half t1: y = O2 . Pp, x = I_e
        t1 = newton(dots(clv, O2 * Pp), t1)
        I1 = inside(t1)
        # outside half t2: y = O_e, x = I1 . Pp
        t2 = newton(dots(I1 * Pp, out), t2)
        del I1, O2, Pp
    lnl, _, _ = engine.edge_lnl_terms(dots_v(outside(t2) * inside(t1)),
                                      sc_base, aux, tp)
    valid = torch.as_tensor(np.asarray(valids), dtype=torch.bool,
                            device=engine.device).T
    lnl = torch.where(valid, lnl, -torch.inf)
    return tuple(x.T for x in (lnl, t1, t2, tp))


def spr_scores_batched(engine, params, tree: TreeArrays, masks, vs,
                       valids, weights=None):
    """Per (candidate k, target edge e): exact regraft lnL with the
    triple lengths optimized.  masks [K, n_int, 2]; vs [K];
    valids [K, n_nodes].  Returns (lnl [K, N], t1, t2, tp [K, N]) as
    numpy."""
    res = _spr_scorer(engine, engine.system_of(params), tree, masks, vs,
                      valids, engine._w(weights))
    return tuple(x.cpu().numpy() for x in res)


def spr_scores(engine, params, tree: TreeArrays, mask, v, valid,
               weights=None):
    """Per target edge e: exact lnL of regrafting subtree v onto e
    with the three junction lengths (inside half t1, outside half t2,
    pendant tp) jointly optimized.  Returns (lnl, t1, t2, tp) [N]."""
    res = spr_scores_batched(engine, params, tree, np.asarray(mask)[None],
                             [int(v)], np.asarray(valid)[None], weights)
    return tuple(x[0] for x in res)


def _descendants(rv, v: int) -> np.ndarray:
    """Boolean [n_nodes]: nodes in subtree(v) inclusive."""
    from phyml_tpu_torch import native
    nat = native.descendants(rv.n_otu, rv.child, v)
    if nat is not None:
        return nat
    n = rv.n_otu
    below = np.zeros(rv.n_nodes, dtype=bool)
    below[v] = True
    # children have lower indices than parents (postorder), so a
    # downward sweep propagates the flag to the whole subtree
    for i in range(rv.n_internal - 1, -1, -1):
        u = n + i
        if below[u]:
            below[rv.child[i, 0]] = True
            below[rv.child[i, 1]] = True
    return below


def prune_candidates(rv) -> list[int]:
    """Rooted nodes whose subtree can be pruned: everything except the
    root and its two children (pruning a root child is re-rooting)."""
    r0, r1 = (int(x) for x in rv.child[-1])
    return [x for x in range(rv.n_nodes - 1) if x not in (r0, r1)]


def spr_move_arrays(rv, v: int):
    """(mask [n_int, 2], valid [n_nodes]) for pruning subtree v."""
    n = rv.n_otu
    u = int(rv.parent[v])
    i_u = u - n
    slot = 0 if int(rv.child[i_u, 0]) == v else 1
    mask = np.zeros((rv.n_internal, 2), dtype=np.float32)
    mask[i_u, slot] = 1.0
    below = _descendants(rv, v)
    valid = ~below
    valid[rv.n_nodes - 1] = False        # root has no edge
    # the zero-length root child duplicates the root edge (the tip-0
    # side carries the full length); scoring it would use a different
    # split point than apply_spr produces
    valid[int(rv.child[-1, 1])] = False
    valid[u] = True                      # remnant half-edge: "stay"
    valid[v] = False
    return mask, valid


def apply_spr(topo, rv, v: int, target: int, t1: float, t2: float,
              t_p: float):
    """Host surgery: regraft subtree v onto target's edge.  t1 is the
    inside (child-of-target) half, t2 the outside half, t_p the
    pruned pendant edge length."""
    uid = rv.unrooted_id
    u = int(rv.parent[v])
    prune_edge = int(rv.node_to_edge[v])
    # which endpoint of prune_edge is the link (= u's unrooted id)?
    link_unrooted = int(uid[u])
    e0, e1 = (int(x) for x in topo.edges[prune_edge])
    # side indexes the MOVING subtree's endpoint; link sits at side^1
    side = 0 if e1 == link_unrooted else 1
    assert topo.edges[prune_edge][side ^ 1] == link_unrooted
    regraft_edge = int(rv.node_to_edge[target])
    inside_unrooted = int(uid[target])
    p_end = int(topo.edges[regraft_edge][0])
    new, ey = topo.spr(prune_edge, side, regraft_edge,
                       return_new_edge=True)
    # regraft_edge now carries (p, link); ey carries (link, q);
    # the inside node sat at endpoint p or q of the original edge
    if p_end == inside_unrooted:
        e_in, e_out = regraft_edge, ey
    else:
        e_in, e_out = ey, regraft_edge
    new.blen[e_in] = float(np.clip(t1, BL_MIN, BL_MAX))
    new.blen[e_out] = float(np.clip(t2, BL_MIN, BL_MAX))
    new.blen[prune_edge] = float(np.clip(t_p, BL_MIN, BL_MAX))
    return new


def default_batch_k(engine, rv) -> int:
    """Prune candidates per scorer call in spr_round: the reference's
    rule (phyml_tpu/search/spr.py), ~10 [n_nodes, C, ns, P] float32
    temporaries per candidate within 4 GiB, at most 128, and no more
    than the candidates rounded up to a multiple of 32.  The rule was
    set by TPU memory, but it decides which moves share a block and so
    the search's trajectory; it is kept as it is, on the port's own
    (unpadded) pattern count."""
    per_cand = engine.n_nodes * engine.C * engine.ns * engine.P * 4 * 10
    mem_k = (4 << 30) // max(per_cand, 1)
    want_k = len(prune_candidates(rv))
    return int(max(1, min(mem_k, 128, -(-want_k // 32) * 32)))


def _tree_logliks(engine, params, trees, weights=None) -> np.ndarray:
    """lnL of each tree, one single-parameter-set pass each (the
    engine's slot kernel, K1 or K4): the SPR joint guard's two trees."""
    sys = engine.system_of(params)
    w = engine._w(weights)
    return np.asarray([float(engine._loglik_sys(sys, t, w))
                       for t in trees])


def _move_footprint(topo, rv, v: int, target: int):
    """(edge ids, unrooted node ids) a v->target regraft edits: the
    prune edge, the two heal edges at the link, and the split target
    edge, plus their endpoints.  Two moves with disjoint footprints
    commute on the edge list (each edits only its own entries)."""
    uid = rv.unrooted_id
    u = int(rv.parent[v])
    link = int(uid[u])
    prune_edge = int(rv.node_to_edge[v])
    regraft_edge = int(rv.node_to_edge[target])
    edges = {prune_edge, regraft_edge}
    nodes = {link, int(uid[v])}
    for eid, (a, b) in enumerate(topo.edges):
        if eid != prune_edge and (int(a) == link or int(b) == link):
            edges.add(eid)
            nodes.update((int(a), int(b)))
    p, q = (int(x) for x in topo.edges[regraft_edge])
    nodes.update((p, q))
    return edges, nodes


def _move_still_valid(cur_topo, rv, v: int, target: int) -> bool:
    """Recheck a scored move against the CURRENT edge list.

    Footprint-disjoint moves commute on the edge *entries*, but an
    earlier move in the block can relocate a subtree so that this
    move's regraft edge is now inside its own pruned component (the
    regraft would create a cycle), or adjacent to the link (a no-op
    split).  BFS from the moving endpoint of the prune edge, without
    crossing it, and reject if the regraft edge is reachable."""
    uid = rv.unrooted_id
    u = int(rv.parent[v])
    link = int(uid[u])
    moving = int(uid[v])
    prune_edge = int(rv.node_to_edge[v])
    regraft_edge = int(rv.node_to_edge[target])
    p, q = (int(x) for x in cur_topo.edges[regraft_edge])
    if p == link or q == link:
        return False                    # degenerate: regraft at link
    adj: dict[int, list[tuple[int, int]]] = {}
    for eid, (a, b) in enumerate(cur_topo.edges):
        if eid == prune_edge:
            continue
        adj.setdefault(int(a), []).append((eid, int(b)))
        adj.setdefault(int(b), []).append((eid, int(a)))
    seen_nodes = {moving}
    stack = [moving]
    while stack:
        n0 = stack.pop()
        for eid, n1 in adj.get(n0, ()):
            if eid == regraft_edge:
                return False            # target inside moving subtree
            if n1 not in seen_nodes:
                seen_nodes.add(n1)
                stack.append(n1)
    return True


def spr_round(
    engine,
    params,
    topo,
    min_gain: float = 1e-3,
    rng: np.random.Generator | None = None,
    weights=None,
    accept_topo=None,
    batch_k: int | None = None,
    max_apply: int | None = None,
):
    """One SPR sweep: prunable subtrees in random order, scored in
    BLOCKS of batch_k per scorer call (masked passes with a candidate
    axis, default_batch_k);
    each block's improving moves are applied greedily when their
    footprints are disjoint, guarded by a joint re-evaluation with
    single-best fallback (the reference applies one move at a time,
    spr.c:1380 Try_One_Spr_Move_Triple; blocking amortizes the
    per-call host sync).  Returns (topo, lnL, n_applied).

    accept_topo (optional): predicate on the post-move Topology
    (constraint search)."""
    rng = rng or np.random.default_rng(0)
    dev = dict(dtype=engine.dtype, device=engine.device)
    n_applied = 0
    rv = topo.rooted()
    ta = tree_arrays(rv, **dev)
    lnl_cur = float(engine.loglik(params, ta, weights))
    if batch_k is None:
        batch_k = default_batch_k(engine, rv)
    if max_apply is None:
        # applying every footprint-disjoint improving move of a big
        # block is too greedy (all were scored against the pre-block
        # tree): cap the applies per block and let the outer sweep
        # loop rescore (phyml_tpu's cap, part of the trajectory)
        max_apply = 8
    order = [int(x) for x in rng.permutation(prune_candidates(rv))]
    pos = 0
    while pos < len(order):
        cands_now = set(prune_candidates(rv))
        block = []
        while pos < len(order) and len(block) < batch_k:
            v = order[pos]
            pos += 1
            if v in cands_now and int(rv.parent[v]) != rv.n_nodes - 1:
                block.append(v)
        if not block:
            continue
        # the reference pads a block to batch_k with copies of block[0]
        # (one compiled program shape); that changes no score, so only
        # the real candidates are scored here
        mv = [spr_move_arrays(rv, v) for v in block]
        lnl_t, t1, t2, tp = spr_scores_batched(
            engine, params, ta, np.stack([m for m, _ in mv]),
            np.asarray(block), np.stack([va for _, va in mv]),
            weights=weights)

        # per candidate: the best non-"stay" target above min_gain
        proposals = []
        for k, v in enumerate(block):
            u = int(rv.parent[v])
            s_row = rv.child[u - rv.n_otu]
            sib = int(s_row[1] if int(s_row[0]) == v else s_row[0])
            link_edges = {int(rv.node_to_edge[u]),
                          int(rv.node_to_edge[sib])}
            for best in np.argsort(-lnl_t[k]):
                best = int(best)
                if int(rv.node_to_edge[best]) in link_edges:
                    break          # best remaining position = current
                if lnl_t[k, best] - lnl_cur < min_gain:
                    break
                proposals.append((float(lnl_t[k, best]), k, v, best))
                break
        if not proposals:
            continue
        proposals.sort(reverse=True)

        # greedy footprint-disjoint application on the host edge list
        new_topo = topo
        used_edges: set[int] = set()
        used_nodes: set[int] = set()
        applied_block = []
        for score, k, v, best in proposals:
            if max_apply is not None and \
                    len(applied_block) >= max_apply:
                break
            edges, nodes = _move_footprint(topo, rv, v, best)
            if (edges & used_edges) or (nodes & used_nodes):
                continue
            if not _move_still_valid(new_topo, rv, v, best):
                continue
            try:
                cand = apply_spr(new_topo, rv, v, best,
                                 float(t1[k, best]),
                                 float(t2[k, best]),
                                 float(tp[k, best]))
            except (ValueError, AssertionError):
                continue                 # stale move on edited tree
            if accept_topo is not None and not accept_topo(cand):
                continue
            new_topo = cand
            used_edges |= edges
            used_nodes |= nodes
            applied_block.append((score, k, v, best))
        if not applied_block:
            continue

        # joint guard: evaluate the joint application AND the single
        # best move, keep the better (or the current tree if neither
        # improves)
        rv2 = new_topo.rooted()
        ta2 = tree_arrays(rv2, **dev)
        if len(applied_block) > 1:
            score, k, v, best = applied_block[0]
            single_topo = apply_spr(topo, rv, v, best,
                                    float(t1[k, best]),
                                    float(t2[k, best]),
                                    float(tp[k, best]))
            rv_s = single_topo.rooted()
            ta_s = tree_arrays(rv_s, **dev)
            vals = _tree_logliks(engine, params, (ta2, ta_s), weights)
            if vals[1] > vals[0]:
                new_topo, rv2, ta2 = single_topo, rv_s, ta_s
                applied_block = applied_block[:1]
                lnl_new = float(vals[1])
            else:
                lnl_new = float(vals[0])
        else:
            lnl_new = float(engine.loglik(params, ta2, weights))
        if lnl_new <= lnl_cur:
            continue                     # keep the current tree
        topo, rv, ta = new_topo, rv2, ta2
        lnl_cur = lnl_new
        n_applied += len(applied_block)
    return topo, lnl_cur, n_applied
