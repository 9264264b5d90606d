"""Plain reference of the NNI re-scoring behind aBayes supports.

For every internal edge (v, u) of the tree rooted as in `lnl.root` (v
below u, a and b v's children in order, s u's other child), the three
arrangements of the four subtrees around it: (a b | s) as the tree has
it, (a s | b) and (b s | a).  Each is scored with its four local branch
lengths (the central one and the three pendant ones under it; the
branch above u stays fixed) improved by two sweeps of safeguarded
Newton steps, five a length, in the order central, first pendant,
second pendant, third pendant, and the final lnL taken at the central
branch.  aBayes supports are exp(l0) / (exp(l0) + exp(l1) + exp(l2)).

The arithmetic is plain float64 PyTorch: P(t) from the model's eigen
system, the likelihood of one branch's length from the two vectors on
its ends, and its first two derivatives in closed form.  The control
runs the same code in `lnl.Arith("tf32")`.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import lnl as L

BL_MIN, BL_MAX = 1e-8, 100.0    # PhyML's branch-length bounds
SWEEPS, STEPS = 2, 5


def candidates(rt: L.Rooted) -> np.ndarray:
    """[n - 3, 5] rows (v, u, a, b, s) in rooted ids, v ascending."""
    n, rows = rt.n, []
    for v in range(n, 2 * n - 2):
        u = int(rt.parent[v])
        if u == 2 * n - 2:
            continue
        a, b = (int(x) for x in rt.child[v - n])
        c0, c1 = (int(x) for x in rt.child[u - n])
        rows.append((v, u, a, b, c1 if c0 == v else c0))
    return np.asarray(rows, dtype=np.int64)


def outside(rt: L.Rooted, P, D, sc, tips, pi, ar: L.Arith):
    """For every non-root node x: O[x] [C, Pn, ns], the likelihood of
    everything outside x's subtree as a function of the state of x's
    parent (pi at the root), scaled, and its log scale so[x]."""
    n, r = rt.n, 2 * rt.n - 2
    C = P.shape[1]
    O, so = {}, {}

    def below(c):
        x = ar.cast(tips[c]).expand(C, -1, -1) if c < n else D[c]
        return ar.mm(x, P[c].transpose(-1, -2)), \
            (sc[c] if c >= n else torch.zeros_like(sc[r]))

    for i in range(len(rt.child) - 1, -1, -1):          # preorder
        p = n + i
        if p == r:
            G = ar.cast(pi)[:, None, :].expand(C, tips.shape[1], -1)
            gs = torch.zeros_like(sc[r])
        else:
            G = ar.mm(O[p], P[p])
            gs = so[p]
        a, b = (int(x) for x in rt.child[i])
        for x, y in ((a, b), (b, a)):
            yb, ys = below(y)
            o = G * yb
            m = o.amax(dim=(0, 2))
            m = torch.where(m > 0, m, torch.ones_like(m))
            O[x] = o / m[None, :, None]
            so[x] = gs + ys + torch.log(m.to(torch.float64))
    return O, so


def nni_lnl(config: dict, data: L.Data, edges, blen, values: dict,
            precision: str = "float64", block: int = 8,
            lengths: list | None = None):
    """(cand [E, 5], eid [E], lnl [E, 3] float64): the three
    arrangements' lnL of every internal edge, as the module describes.
    A list passed as `lengths` receives each block's final (t1, t2, t3,
    tc), each [Eb, 3]."""
    ar = L.Arith(precision)
    dev = data.tips.device
    n = len(data.names)
    rt = L.root(edges, n)
    lam, V, Vinv, w, pi = (torch.as_tensor(np.asarray(x),
                                           dtype=torch.float64, device=dev)
                           for x in L.system(config, data, values))
    C = w.shape[0]
    t_node = torch.as_tensor(L.node_lengths(rt, blen), dtype=torch.float64,
                             device=dev)
    P = L.pmats(lam, V, Vinv, t_node, ar)
    D, sc = L.inside(rt, P, data.tips, ar)
    O, so = outside(rt, P, D, sc, data.tips, pi, ar)
    cand = candidates(rt)
    zero = torch.zeros(data.tips.shape[1], dtype=torch.float64, device=dev)

    def part(x):
        if x < n:
            return ar.cast(data.tips[x]).expand(C, -1, -1), zero
        return D[x], sc[x]

    lamr = lam                                           # [C, ns]
    Vc, Vic = ar.cast(V), ar.cast(Vinv)                  # [C, ns, ns]
    wc = w[:, None]                                      # [C, 1]
    wts = data.weights

    def P_of(t):                                         # t [Eb, 3]
        E = torch.exp(lamr[None, None] * t[..., None, None])
        left = ar.cast(V[None, None] * E[..., None, :])
        return torch.clamp(ar.mm(left, Vic.expand_as(left)),
                           min=1e-30 if ar.low else 1e-100)

    def push(Pm, x):         # (P x)_i = sum_j P_ij x_j, x [.., C, Pn, ns]
        return ar.mm(x, Pm.transpose(-1, -2))

    def pushT(Pm, x):        # (P^T x)_j = sum_i P_ij x_i
        return ar.mm(x, Pm)

    def terms(x, y, t, s_tot):
        """(site lnL, dlnL, d2lnL) summed over columns, of the branch of
        length t [Eb, 3] between lower vector x and upper vector y."""
        d = (ar.mm(y, Vc) * ar.mm(x, Vic.transpose(-1, -2))).to(
            torch.float64)                               # [Eb, 3, C, Pn, ns]
        lt = lamr[None, None] * t[..., None, None]       # [Eb, 3, C, ns]
        e = torch.exp(lt)[..., None, :]
        lb = lamr[None, None, :, None, :]
        s0 = ((d * e).sum(-1) * wc).sum(2)               # [Eb, 3, Pn]
        s1 = ((d * lb * e).sum(-1) * wc).sum(2)
        s2 = ((d * lb * lb * e).sum(-1) * wc).sum(2)
        site = torch.log(torch.clamp(s0, min=1e-300)) + s_tot[:, None, :]
        g1 = s1 / s0
        return ((site * wts).sum(-1), (g1 * wts).sum(-1),
                ((s2 / s0 - g1 * g1) * wts).sum(-1))

    def newton(x, y, t, s_tot):
        for _ in range(STEPS):
            _, d1, d2 = terms(x, y, t, s_tot)
            nt = t - d1 / torch.where(d2 < 0, d2, -torch.ones_like(d2))
            probe = torch.where(d1 > 0, t * 3.0, t / 3.0)
            tn = torch.where(d2 < -1e-12, nt, probe)
            tn = torch.minimum(torch.maximum(tn, t / 3.0), t * 3.0)
            t = torch.clamp(tn, BL_MIN, BL_MAX)
        return t

    out = []
    for lo in range(0, len(cand), block):
        rows = cand[lo:lo + block]
        parts = [[part(int(r[k])) for r in rows] for k in (2, 3, 4)]
        (ca, sa), (cb, sb), (cs, ss) = (
            (torch.stack([p[0] for p in ps]), torch.stack([p[1] for p in ps]))
            for ps in parts)
        us = [int(r[1]) for r in rows]
        G = torch.stack([ar.mm(O[u], P[u]) for u in us])[:, None]
        s_tot = sa + sb + ss + torch.stack([so[u] for u in us])
        C1 = torch.stack([ca, ca, cb], 1)
        C2 = torch.stack([cb, cs, cs], 1)
        C3 = torch.stack([cs, cb, ca], 1)
        la, lb, ls = (t_node[torch.as_tensor(rows[:, k], device=dev)]
                      for k in (2, 3, 4))
        t1 = torch.stack([la, la, lb], 1)
        t2 = torch.stack([lb, ls, ls], 1)
        t3 = torch.stack([ls, lb, la], 1)
        tc = t_node[torch.as_tensor(rows[:, 0], device=dev)][:, None] \
            .expand(-1, 3)
        t1, t2, t3, tc = (torch.clamp(t, BL_MIN, BL_MAX)
                          for t in (t1, t2, t3, tc))
        for _ in range(SWEEPS):
            Q1, Q2, Q3 = push(P_of(t1), C1), push(P_of(t2), C2), \
                push(P_of(t3), C3)
            tc = newton(Q1 * Q2, G * Q3, tc, s_tot)
            Pc = P_of(tc)
            W = pushT(Pc, G * Q3)
            t1 = newton(C1, W * Q2, t1, s_tot)
            Q1 = push(P_of(t1), C1)
            t2 = newton(C2, W * Q1, t2, s_tot)
            Q2 = push(P_of(t2), C2)
            t3 = newton(C3, G * push(Pc, Q1 * Q2), t3, s_tot)
        Q1, Q2, Q3 = push(P_of(t1), C1), push(P_of(t2), C2), \
            push(P_of(t3), C3)
        out.append(terms(Q1 * Q2, G * Q3, tc, s_tot)[0])
        if lengths is not None:
            lengths.append(tuple(t.cpu().numpy() for t in (t1, t2, t3, tc)))
    lnl = torch.cat(out).cpu().numpy()
    return cand, rt.node_edge[cand[:, 0]], lnl


def abayes(lnl: np.ndarray) -> np.ndarray:
    """aBayes support [E] of arrangement 0 from lnl [E, 3]."""
    e = np.exp(lnl - lnl.max(axis=1, keepdims=True))
    return e[:, 0] / e.sum(axis=1)
