"""Ancestral sequence reconstruction (reference: ancestral.c).

Port of phyml_tpu/ops/ancestral.py.  Three capabilities:

  * Marginal posteriors (ancestral.c:527 Ancestral_Sequences /
    :609 Ancestral_Sequences_One_Node): the engine's one up pass and
    one down pass (LikelihoodEngine._up_pass / _down_pass, the scan
    path's torch ops, on the engine's device) give the inside partials
    and the outside partials O[u] of every node, so the joint
    probability of state s at node u is one batched product
        joint[u, c, s, p] = (P(t_u)^T O[u])[c, s, p] * CLV[u][c, s, p]
    for all nodes, classes and sites at once.  The class mix runs in
    the engine's dtype (float32 on the card), the posterior's log in
    float64, as phyml_tpu's.
  * MPEE decoding (ancestral.c:906 MPEE_Infer / :995 MPEE_Score —
    Oliva et al. 2019 "minimum posterior expected error" ambiguity-
    aware state sets), vectorized over sites in NumPy on a float64
    host copy.
  * Joint sampling + stochastic mutation mapping
    (ancestral.c:15 Sample_Ancestral_Seq, :345 Map_Mutations): the rate
    class drawn from its per-site posterior, states drawn in one
    preorder walk over all sites at once on the engine's device (Gumbel
    max over phyml_tpu's log-weights, from a torch.Generator: the
    draws follow phyml_tpu's distribution, not its threefry stream),
    and substitution histories drawn per edge by rejection sampling
    with the first-jump conditioning of Hobolth & Stone (2009) on the
    host from a numpy Generator, exactly as phyml_tpu draws them.

No kernel runs here: the pruning kernels return site sums, not the
per-node partials these need.
"""

from __future__ import annotations

import numpy as np
import torch

from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, TreeArrays


def _host64(x) -> np.ndarray:
    """A float64 numpy copy of a tensor (on any device) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _inside(eng: LikelihoodEngine, params, tree: TreeArrays):
    """(system, P-matrices, pup, clv, sc) of one up pass of `tree` on
    the engine's device."""
    sys = eng._system(params)
    lam, V, Vinv = sys[:3]
    pmats = eng._pmats(lam, V, Vinv, tree.blen.to(eng.device, eng.dtype))
    pup, clv, sc = eng._up_pass(pmats, torch.as_tensor(tree.child))
    return sys, pmats, pup, clv, sc


# ---------------------------------------------------------------------------
# marginal posteriors
# ---------------------------------------------------------------------------
@torch.no_grad()
def marginal_posteriors(eng: LikelihoodEngine, params, tree: TreeArrays,
                        include_root: bool = False) -> torch.Tensor:
    """Posterior state probabilities at every internal node.

    Returns [n_internal, P, ns] float64 on the engine's device (rows
    ordered by rooted internal index n_otu..2n-2; the last row is the
    virtual root and is excluded unless include_root).  Probabilities
    mix rate classes by their posterior weight and fold in the +I
    invariant component exactly as the reference does
    (ancestral.c:873-877: p_i = (1-pinv) p_i + pinv * inv_lk * pi_i,
    normalized by the site likelihood).
    """
    probs = _marginals(eng, params, tree)
    return probs if include_root else probs[:-1]


def _marginals(eng: LikelihoodEngine, params, tree: TreeArrays):
    n = eng.n_otu
    (lam, V, Vinv, pi, w, pinv), pmats, pup, clv, sc = _inside(
        eng, params, tree)
    out, sc_out = eng._down_pass(pmats, torch.as_tensor(tree.child), pup,
                                 sc, pi)
    site = eng._root_site_loglik(pup, sc, pi, w, pinv)   # [P] log L

    # internal nodes only (rooted indices n..2n-2)
    # grand[u, c, s, p] = sum_w P[u][c, w, s] * O[u][c, w, p]
    grand = torch.einsum("ucws,ucwp->ucsp", pmats[n:], out[n:])
    joint = grand * clv[n:]                              # [I, C, ns, P]
    # the root row: O[root] is zero (unused); joint at the root is the
    # pi-weighted below-partials instead (pi [C, ns]: a mixture's
    # classes each their own frequencies)
    root = eng.n_nodes - 1
    joint[-1] = pi[:, :, None] * clv[root]
    scale = sc_out[n:] + sc[n:]                          # [I, C, P]
    scale[-1] = sc[root]

    m = torch.amax(scale, dim=1, keepdim=True)           # [I, 1, P]
    ew = w[None, :, None] * torch.exp(scale - m)         # [I, C, P]
    A = torch.einsum("ucsp,ucp->usp", joint, ew)
    A = torch.clamp(A, min=eng._tiny)
    log_p = torch.log(A) + m                             # [I, ns, P]
    if eng.model.invar:
        inv_lk = eng._inv_lk(pi, w)                      # [P]
        pi_mix = torch.einsum("c,cx->x", w, pi)
        log_var = torch.log1p(-pinv) + log_p
        inv_term = pinv * inv_lk[None, None, :] * pi_mix[None, :, None]
        log_inv = torch.log(torch.clamp(inv_term, min=eng._tiny))
        log_p = torch.where(eng.invar_ok[None, None, :] > 0,
                            torch.logaddexp(log_var, log_inv), log_var)
    log_post = log_p.double() - site.double()[None, None, :]
    return torch.exp(log_post).permute(0, 2, 1)          # [I, P, ns]


# ---------------------------------------------------------------------------
# MPEE decoding (ancestral.c:906 MPEE_Infer)
# ---------------------------------------------------------------------------
def mpee_decode(probs, mesh: int = 50) -> np.ndarray:
    """Minimum-posterior-expected-error state sets.

    probs [..., ns] (a tensor on any device, or an array; decoded on a
    float64 host copy) -> int bitmask array [...] where bit
    (ns-1-state) is set for every state included in the chosen
    ambiguity set (matching the reference's Integer_To_Bit convention,
    ancestral.c:1031-1034).
    """
    probs = _host64(probs)
    ns = probs.shape[-1]
    flat = probs.reshape(-1, ns)
    order = np.argsort(-flat, axis=1, kind="stable")     # idx[] of ref
    cdf = np.cumsum(np.take_along_axis(flat, order, axis=1), axis=1)

    levels = np.arange(ns, dtype=np.float64)             # i = 0..ns-1
    # candidate alpha grid: alpha_j(i) = j * (i/(i+1)) / mesh
    j = np.arange(mesh + 1, dtype=np.float64)[:, None]   # [mesh+1, 1]
    a = j * (levels / (levels + 1.0))[None, :] / mesh    # [mesh+1, ns]
    with np.errstate(divide="ignore", invalid="ignore"):
        b = (ns - 1.0 - a * (levels + 1.0)) / (ns - levels - 1.0)
        # score[g, n, i] = a + (b-a)(1 - cdf[n, i]); last level fixed
        score = a[:, None, :] + \
            (b - a)[:, None, :] * (1.0 - cdf[None, :, :])
    score[:, :, ns - 1] = (ns - 1.0) / ns
    best_level = np.argmin(score, axis=2)                # [mesh+1, N]

    # majority vote over the alpha grid (reference counts identical
    # best_state bitmasks; levels map 1-1 to bitmasks given the order)
    N = flat.shape[0]
    votes = np.zeros((N, ns), dtype=np.int32)
    np.add.at(votes, (np.arange(N)[None, :].repeat(mesh + 1, 0).ravel(),
                      best_level.ravel()), 1)
    chosen = np.argmax(votes, axis=1)                    # [N]

    masks = np.zeros(N, dtype=np.int64)
    for lvl in range(ns):
        sel = chosen >= lvl
        masks[sel] += (1 << (ns - 1 - order[sel, lvl])).astype(np.int64)
    return masks.reshape(probs.shape[:-1])


def mask_to_char(mask: int, datatype: str) -> str:
    """Bitmask -> ambiguity character (reference Bit_To_Character_String)."""
    if datatype == "nt":
        order = "ACGT"
        states = [order[i] for i in range(4) if mask & (1 << (4 - 1 - i))]
        key = frozenset(states)
        table = {
            frozenset("A"): "A", frozenset("C"): "C",
            frozenset("G"): "G", frozenset("T"): "T",
            frozenset("AG"): "R", frozenset("CT"): "Y",
            frozenset("AC"): "M", frozenset("GT"): "K",
            frozenset("AT"): "W", frozenset("CG"): "S",
            frozenset("CGT"): "B", frozenset("AGT"): "D",
            frozenset("ACT"): "H", frozenset("ACG"): "V",
            frozenset("ACGT"): "X",
        }
        return table.get(key, "X")
    order = "ARNDCQEGHILKMFPSTWYV"
    states = [order[i] for i in range(20) if mask & (1 << (20 - 1 - i))]
    return states[0] if len(states) == 1 else "X"


# ---------------------------------------------------------------------------
# joint sampling (ancestral.c:15 Sample_Ancestral_Seq)
# ---------------------------------------------------------------------------
def class_logits(eng, pi, w, pup_root, sc_root, from_prior=False):
    """[C, P] log-weights of each pattern's rate class: its posterior
    (ancestral.c:64-80), or the prior weights if from_prior."""
    lroot = torch.einsum("cx,cxp->cp", pi, pup_root)
    if from_prior:
        return torch.log(w)[:, None].expand(lroot.shape)
    return torch.log(w)[:, None] + sc_root + \
        torch.log(torch.clamp(lroot, min=eng._tiny))


def root_logits(eng, pi, clv_root, cls):
    """[P, ns] log-weights of the root state given each pattern's class:
    pi[class, s] * CLV_root[class, s, p]."""
    ar = torch.arange(cls.shape[0], device=cls.device)
    wgt = pi[cls] * clv_root[cls, :, ar]
    return torch.log(torch.clamp(wgt, min=eng._tiny))


def child_logits(eng, pm_c, clv_c, cls, parent_state):
    """[P, ns] log-weights of a node's state given each pattern's class
    and its parent's state: P_c[class, parent_state, s] * CLV_c[class,
    s, p]."""
    ar = torch.arange(cls.shape[0], device=cls.device)
    wgt = pm_c[cls, parent_state] * clv_c[cls, :, ar]
    return torch.log(torch.clamp(wgt, min=eng._tiny))


def _categorical(logits, generator):
    """One draw per row of [rows, k] log-weights (Gumbel max: the
    argmax of logits - log E, E ~ Exp(1))."""
    e = torch.empty(logits.shape, dtype=torch.float64,
                    device=logits.device).exponential_(generator=generator)
    return torch.argmax(logits.double() - torch.log(e), dim=-1)


@torch.no_grad()
def sample_ancestral(eng: LikelihoodEngine, params, tree: TreeArrays,
                     generator: torch.Generator, from_prior: bool = False):
    """One joint sample of (rate class, ancestral states) per pattern,
    on the engine's device from `generator` (a torch.Generator on that
    device).

    Returns (classes [P] int32, states [n_nodes, P] int32), on the
    device.  The rate class is drawn from its per-site posterior
    (ancestral.c:64-80; prior weights if from_prior), then states are
    sampled root-down: P(s_u = s | s_parent = w, data below u) ∝
    P_u[w, s] CLV_u[s] — one preorder walk for all sites at once.
    """
    n = eng.n_otu
    (lam, V, Vinv, pi, w, pinv), pmats, pup, clv, sc = _inside(
        eng, params, tree)
    root = eng.n_nodes - 1
    cls = _categorical(
        class_logits(eng, pi, w, pup[root], sc[root], from_prior).T,
        generator)                                       # [P]
    states = torch.zeros((eng.n_nodes, eng.P), dtype=torch.long,
                         device=eng.device)
    states[root] = _categorical(root_logits(eng, pi, clv[root], cls),
                                generator)
    # internal nodes in reverse index order = preorder
    rows = torch.as_tensor(tree.child).tolist()
    for i in range(eng.n_internal - 1, -1, -1):
        sw = states[n + i]
        for c in rows[i]:
            states[c] = _categorical(
                child_logits(eng, pmats[c], clv[c], cls, sw), generator)
    return cls.int(), states.int()


# ---------------------------------------------------------------------------
# stochastic mutation mapping (ancestral.c:345 Map_Mutations)
# ---------------------------------------------------------------------------
def map_mutations(eng: LikelihoodEngine, params, tree: TreeArrays,
                  classes, states, rng: np.random.Generator,
                  sites: np.ndarray | None = None,
                  max_iter: int = 1000):
    """Substitution histories per (edge, site) by endpoint-conditioned
    rejection sampling (Nielsen 2002 with the Hobolth-Stone 2009
    first-jump conditioning when the endpoints differ, exactly the
    scheme of ancestral.c:411-493).  Host numpy, phyml_tpu's loop and
    draws: the same (classes, states), system and rng give its events.

    Returns a list of (node, site, t, from_state, to_state) tuples,
    with t measured from the parent end of the node's edge.
    """
    lam, V, Vinv, *_ = (_host64(x) for x in eng._system(params))
    # per-class rate matrices (class rate folded into lam)
    Q = np.einsum("cij,cj,cjk->cik", V, lam, Vinv)
    classes = np.asarray(_host64(classes)).astype(np.int64)
    states = np.asarray(_host64(states)).astype(np.int64)
    blen = _host64(tree.blen)
    child = np.asarray(torch.as_tensor(tree.child))
    n = eng.n_otu
    if sites is None:
        sites = np.arange(eng.aln.n_patterns)

    # jump chains: off-diagonal rows normalized
    jump = Q.copy()
    for c in range(jump.shape[0]):
        np.fill_diagonal(jump[c], 0.0)
        rs = jump[c].sum(axis=1, keepdims=True)
        jump[c] = np.divide(jump[c], rs, out=np.zeros_like(jump[c]),
                            where=rs > 0)

    events = []
    root = eng.n_nodes - 1
    parent = np.full(eng.n_nodes, -1, dtype=np.int64)
    for i in range(eng.n_internal):
        parent[child[i, 0]] = n + i
        parent[child[i, 1]] = n + i

    for u in range(eng.n_nodes - 1):          # every node except root
        T = blen[u]
        if T <= 0:
            continue
        for p in sites:
            c = int(classes[p])
            sa = int(states[parent[u], p]) if parent[u] != root \
                else int(states[root, p])
            sd = int(states[u, p])
            qc = Q[c]
            for _ in range(max_iter):
                traj = _sample_path(qc, jump[c], sa, sd, T, rng)
                if traj is not None:
                    break
            else:
                continue
            for (t, s_from, s_to) in traj:
                events.append((u, int(p), float(t), s_from, s_to))
    return events


def _sample_path(Q, jump, sa, sd, T, rng):
    """One rejection-sampling attempt; returns list of jumps or None."""
    t = 0.0
    s = sa
    traj = []
    first = True
    while True:
        rate = -Q[s, s]
        if first and sa != sd:
            # first jump conditioned on >=1 mutation (Hobolth-Stone 2.1)
            u = rng.random()
            if rate <= 0:
                return None
            dt = -np.log(1.0 - u * (1.0 - np.exp(-rate * T))) / rate
        else:
            dt = rng.exponential(1.0 / rate) if rate > 0 else np.inf
        first = False
        if t + dt > T:
            break
        t += dt
        s_new = int(rng.choice(len(jump[s]), p=jump[s]))
        traj.append((t, s, s_new))
        s = s_new
    return traj if s == sd else None


def write_mutmap(path: str, events) -> None:
    """The mutation map file: one line per sampled substitution (node,
    site, time from the parent end, from, to), in phyml_tpu's format."""
    with open(path, "w") as fh:
        fh.write("# sampled substitution history "
                 "(node, site, time_from_parent, from, to)\n")
        for (u, p, t, s_from, s_to) in events:
            fh.write(f"{u}\t{p}\t{t:.6g}\t{s_from}\t{s_to}\n")


def m4_class_posteriors(eng: LikelihoodEngine, params,
                        tree: TreeArrays,
                        include_root: bool = True) -> np.ndarray:
    """Per-site posterior of the M4 hidden rate class at every
    internal node (the covarion decode report,
    M4_Post_Prob_H_Class_Edge_Site m4.c:679): the expanded-state
    marginals summed over the observed states within each hidden
    class.  Returns [n_internal(, -1 if not include_root), P,
    n_hidden] float64 on the host, rows ordered by rooted internal
    index."""
    model = eng.model
    if not getattr(model, "covarion", False):
        raise ValueError("m4_class_posteriors needs a covarion (M4) "
                         "model")
    probs = _host64(marginal_posteriors(eng, params, tree,
                                        include_root=include_root))
    n_h = model.n_hidden
    obs = eng.ns // n_h
    # expanded state index = h * obs_ns + o (tips are tiled with the
    # hidden class as the major axis, LikelihoodEngine.__init__)
    out = probs.reshape(probs.shape[0], probs.shape[1], n_h, obs)
    return out.sum(axis=3)


def write_m4_decode(path: str, eng: LikelihoodEngine, params,
                    tree: TreeArrays) -> None:
    """Site-wise hidden-class decode report (≙ the reference's
    M4_Compute_Posterior_Mean_Rates output, m4.c:807): for every
    SITE, the posterior hidden-class frequencies averaged over
    internal nodes and at the root, plus the MAP class."""
    post = m4_class_posteriors(eng, params, tree)   # [I, P, H]
    site_post = post.mean(axis=0)                   # [P, H]
    root_post = post[-1]                            # [P, H]
    s2p = eng.aln.site_to_pattern
    n_h = site_post.shape[1]
    with open(path, "w") as fh:
        fh.write("# M4 hidden-rate-class posterior decode "
                 "(per site)\n")
        fh.write("# site\tMAP_class\t"
                 + "\t".join(f"mean_P(class{j})"
                             for j in range(n_h))
                 + "\t"
                 + "\t".join(f"root_P(class{j})"
                             for j in range(n_h))
                 + "\n")
        for s, p in enumerate(s2p):
            mp = site_post[p]
            rp = root_post[p]
            fh.write(f"{s + 1}\t{int(np.argmax(mp))}\t"
                     + "\t".join(f"{x:.4f}" for x in mp) + "\t"
                     + "\t".join(f"{x:.4f}" for x in rp) + "\n")
