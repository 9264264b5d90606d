"""Plain reference likelihood: Felsenstein pruning in float64 PyTorch.

Reads the alignment file itself, compresses its columns itself and
counts its own frequencies; takes a tree as an edge list with branch
lengths and the model's parameters as numbers.  It imports nothing of
the program under test.

`precision` selects the arithmetic: "float64" is the reference; "tf32"
is the benchmark's control, float32 storage with every contraction's
operands rounded to TF32 (10 mantissa bits, round to nearest even) and
float32 accumulation, which is what a TF32 tensor-core product does.

Rooting follows the convention the scorer's reference needs: a virtual
root on tip 0's edge (the whole length on tip 0's side), internal nodes
numbered in postorder of a depth-first walk from tip 0's neighbour that
visits a node's neighbours in the order of their edges in the list.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import model as M
from portbench.reference import models

F64 = torch.float64


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------

@dataclass
class Data:
    names: list
    tips: torch.Tensor        # [n, P, ns] one-hot, float64
    weights: torch.Tensor     # [P] column counts, float64
    freqs: np.ndarray         # [ns] empirical frequencies
    n_sites: int


def read_phylip(path: str):
    """(names, rows) of a sequential PHYLIP file: a header line, then
    one taxon a line, its name and its sequence."""
    with open(path) as fh:
        head = fh.readline().split()
        n, sites = int(head[0]), int(head[1])
        names, rows = [], []
        for _ in range(n):
            name, seq = fh.readline().split()
            if len(seq) != sites:
                raise ValueError(f"{name}: {len(seq)} sites, not {sites}")
            names.append(name)
            rows.append(seq)
    return names, rows


def load_data(path: str, alphabet: str, device="cpu") -> Data:
    """The alignment as one-hot tips over its distinct columns, their
    counts, and the frequencies counted over every cell."""
    names, rows = read_phylip(path)
    lut = np.full(256, -1, dtype=np.int64)
    for k, ch in enumerate(alphabet):
        lut[ord(ch)] = k
    states = lut[np.frombuffer("".join(rows).encode(), dtype=np.uint8)]
    if (states < 0).any():
        raise ValueError("the reference reads unambiguous states only")
    n, ns = len(names), len(alphabet)
    states = states.reshape(n, -1)
    cols, counts = np.unique(states.T, axis=0, return_counts=True)
    tips = np.zeros((n, cols.shape[0], ns))
    tips[np.arange(n)[:, None], np.arange(cols.shape[0])[None, :],
         cols.T] = 1.0
    freqs = np.bincount(states.ravel(), minlength=ns) / states.size
    return Data(names=names,
                tips=torch.as_tensor(tips, dtype=F64, device=device),
                weights=torch.as_tensor(counts, dtype=F64, device=device),
                freqs=freqs, n_sites=int(states.shape[1]))


# ----------------------------------------------------------------------
# tree
# ----------------------------------------------------------------------

@dataclass
class Rooted:
    n: int
    child: np.ndarray         # [n - 1, 2] rooted ids, postorder
    parent: np.ndarray        # [2n - 1]
    node_edge: np.ndarray     # [2n - 1] edge of the node's parent branch


def root(edges, n: int) -> Rooted:
    """The rooted numbering (see the module's notes)."""
    edges = np.asarray(edges, dtype=np.int64)
    adj = [[] for _ in range(2 * n - 2)]
    for k, (a, b) in enumerate(edges):
        adj[a].append((int(b), k))
        adj[b].append((int(a), k))
    n_nodes = 2 * n - 1
    parent = np.full(n_nodes, -1, dtype=np.int64)
    node_edge = np.full(n_nodes, -1, dtype=np.int64)
    child = []
    start, e0 = adj[0][0]
    # depth-first, a frame [node, came_from, next neighbour, kids, edge]
    stack = [[start, 0, 0, [], e0]]
    v_id = -1
    while stack:
        f = stack[-1]
        u, came = f[0], f[1]
        while f[2] < len(adj[u]) and adj[u][f[2]][0] == came:
            f[2] += 1
        if f[2] < len(adj[u]):
            v, k = adj[u][f[2]]
            f[2] += 1
            if v < n:
                node_edge[v] = k
                f[3].append(v)
            else:
                stack.append([v, u, 0, [], k])
            continue
        rid = n + len(child)
        child.append(f[3])
        parent[f[3]] = rid
        stack.pop()
        if stack:
            stack[-1][3].append(rid)
            node_edge[rid] = f[4]
        else:
            v_id = rid
    child.append([0, v_id])
    node_edge[0] = e0
    node_edge[v_id] = e0
    parent[0] = parent[v_id] = n_nodes - 1
    parent[n_nodes - 1] = n_nodes - 1
    return Rooted(n=n, child=np.asarray(child, dtype=np.int64),
                  parent=parent, node_edge=node_edge)


def node_lengths(rt: Rooted, blen) -> np.ndarray:
    """Length of each rooted node's parent branch: tip 0 carries its
    whole edge, its neighbour 0, the root 0."""
    blen = np.asarray(blen, dtype=np.float64)
    out = np.where(rt.node_edge >= 0, blen[np.maximum(rt.node_edge, 0)],
                   0.0)
    out[rt.child[-1][1]] = 0.0
    return out


# ----------------------------------------------------------------------
# arithmetic
# ----------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32's 10 mantissa bits, nearest even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class Arith:
    """Storage type and contraction of one precision."""

    def __init__(self, precision: str):
        if precision not in ("float64", "tf32"):
            raise ValueError(precision)
        self.low = precision == "tf32"
        self.dtype = torch.float32 if self.low else F64

    def mm(self, a, b):
        if self.low:
            return torch.matmul(tf32(a), tf32(b))
        return torch.matmul(a, b)

    def cast(self, x):
        return x.to(self.dtype)


def pmats(lam, V, Vinv, t, ar: Arith):
    """[N, C, ns, ns] P-matrices for lengths t [N] of the classes'
    eigen systems lam [C, ns] (the class rate folded in), V, Vinv
    [C, ns, ns] (float64 exponentials, the product in the precision's
    arithmetic)."""
    E = torch.exp(lam[None] * t[:, None, None])                # [N, C, ns]
    left = ar.cast(V[None] * E[..., None, :])
    # round-off can leave an entry a hair below 0; PhyML floors them
    # (SMALL_PIJ), here at a floor the storage type holds
    return torch.clamp(ar.mm(left, ar.cast(Vinv).expand_as(left)),
                       min=1e-30 if ar.low else 1e-100)


def inside(rt: Rooted, P, tips, ar: Arith):
    """Inside partials: ({rooted node: [C, Pn, ns]} scaled so that each
    pattern's largest entry is 1, {node: log scale [Pn]}) for every
    node up to the root, P [n_nodes, C, ns, ns] the parent branches'."""
    n = rt.n
    C = P.shape[1]
    D, sc = {}, {}
    zero = torch.zeros(tips.shape[1], dtype=F64, device=tips.device)
    for i, (a, b) in enumerate(rt.child):
        node = n + i
        prod = None
        s = zero
        for c in (int(a), int(b)):
            x = ar.cast(tips[c]).expand(C, -1, -1) if c < n else D[c]
            if c >= n:
                s = s + sc[c]
            y = ar.mm(x, P[c].transpose(-1, -2))
            prod = y if prod is None else prod * y
        m = prod.amax(dim=(0, 2))
        m = torch.where(m > 0, m, torch.ones_like(m))
        D[node] = prod / m[None, :, None]
        sc[node] = s + torch.log(m.to(F64))
    return D, sc


def site_loglik(rt: Rooted, lam, V, Vinv, w, pi, tips, blen,
                precision="float64"):
    """Per-column log-likelihood [Pn] (float64) of the tree with lengths
    blen (per edge) under the classes' eigen systems (lam [C, ns], V,
    Vinv [C, ns, ns]), weights w [C] and frequencies pi [C, ns]."""
    ar = Arith(precision)
    dev = tips.device
    lam, V, Vinv, w, pi = (torch.as_tensor(np.asarray(x), dtype=F64,
                                           device=dev) if not
                           isinstance(x, torch.Tensor) else x
                           for x in (lam, V, Vinv, w, pi))
    t = torch.as_tensor(node_lengths(rt, blen), dtype=F64, device=dev) \
        if not isinstance(blen, torch.Tensor) else blen
    P = pmats(lam, V, Vinv, t, ar)
    D, sc = inside(rt, P, tips, ar)
    r = rt.n * 2 - 2
    L = (D[r] * ar.cast(pi)[:, None, :]).sum(-1).to(F64)      # [C, Pn]
    return torch.log((w[:, None] * L).sum(0)) + sc[r]


def loglik(rt, lam, V, Vinv, w, pi, data: Data, blen,
           precision="float64") -> float:
    """Weighted lnL (float64 sum of the columns' terms)."""
    site = site_loglik(rt, lam, V, Vinv, w, pi, data.tips, blen,
                       precision)
    return float((site.double() * data.weights).sum())


# ----------------------------------------------------------------------
# the model of a configuration at given parameter values
# ----------------------------------------------------------------------

def data_of(path: str, config: dict, device="cpu") -> Data:
    """The alignment file read in the configuration's model's states."""
    mod = models.of(config)
    data = load_data(path, mod.ALPHABET, device)
    if hasattr(mod, "tips"):
        data.tips = mod.tips(data.tips, config["model"])
    return data


def _freqs(config: dict, data: Data) -> torch.Tensor:
    if config["model"]["fit_frequencies"] != "empirical":
        raise ValueError("the reference knows empirical frequencies only")
    return torch.as_tensor(data.freqs, dtype=F64, device=data.tips.device)


def q_matrices(S, pi, rate):
    """[C, ns, ns]: Q_ij = S_ij pi_j off the diagonal, rows summing to 0,
    each class scaled to one expected substitution a unit of time and
    then by its rate."""
    Q = S * pi[:, None, :]
    Q = Q - torch.diag_embed(torch.diagonal(Q, dim1=-2, dim2=-1))
    Q = Q - torch.diag_embed(Q.sum(-1))
    scale = -(pi * torch.diagonal(Q, dim1=-2, dim2=-1)).sum(-1)
    return Q / scale[:, None, None] * rate[:, None, None]


def system(config: dict, data: Data, values: dict):
    """(lam [C, ns], V [C, ns, ns], Vinv [C, ns, ns], w [C], pi [C, ns])
    as NumPy float64: the classes' eigen systems of a configuration's
    model at the values the program reported, with the frequencies the
    configuration states (counted from the data)."""
    mod = models.of(config)
    x = torch.as_tensor(mod.start(values, config["model"]), dtype=F64,
                        device=data.tips.device)
    with torch.no_grad():
        S, pi, rate, w = (t.cpu().numpy() for t in mod.mixture(
            x, _freqs(config, data), config["model"]))
    sys_ = [M.eigen(S[c], pi[c]) for c in range(len(w))]
    lam = np.stack([e[0] * rate[c] for c, e in enumerate(sys_)])
    V = np.stack([e[1] for e in sys_])
    Vinv = np.stack([e[2] for e in sys_])
    return lam, V, Vinv, w, pi


# ----------------------------------------------------------------------
# the optimum near a point: L-BFGS over every length and free parameter
# ----------------------------------------------------------------------

def refine(config: dict, data: Data, edges, blen, values: dict,
           max_iter: int = 80):
    """(the point's lnL, the highest lnL (float64) that L-BFGS finds
    from it, at least the point's own, and where: (branch lengths, the
    model's free parameters)), over the log of every branch length and
    every free parameter of the model."""
    mod = models.of(config)
    dev = data.tips.device
    n = len(data.names)
    rt = root(edges, n)
    freqs = _freqs(config, data)
    x_m = torch.tensor(mod.start(values, config["model"]), dtype=F64,
                       device=dev, requires_grad=True)
    x_t = torch.tensor(np.log(np.maximum(np.asarray(blen, np.float64),
                                         1e-12)), dtype=F64, device=dev,
                       requires_grad=True)
    edge_of = torch.as_tensor(np.maximum(rt.node_edge, 0), device=dev)
    keep = torch.ones(2 * n - 1, dtype=F64, device=dev)
    keep[rt.child[-1][1]] = 0.0
    keep[-1] = 0.0
    ar = Arith("float64")
    best = [-math.inf, None]

    def lnl():
        S, pi, rate, w = mod.mixture(x_m, freqs, config["model"])
        t = torch.exp(x_t)[edge_of] * keep
        # P = exp(Q t) directly: Q's spectrum can be degenerate (equal
        # rates), where an eigenvector's derivative is not
        Q = q_matrices(S, pi, rate)
        P = torch.clamp(torch.linalg.matrix_exp(Q[None] * t[:, None, None,
                                                             None]),
                        min=1e-100)
        D, sc = inside(rt, P, data.tips, ar)
        r = 2 * n - 2
        L = ((D[r] * pi[:, None, :]).sum(-1) * w[:, None]).sum(0)
        return ((torch.log(L) + sc[r]) * data.weights).sum()

    params = [x_t] + ([x_m] if x_m.numel() else [])
    opt = torch.optim.LBFGS(params, lr=1.0, max_iter=max_iter,
                            tolerance_grad=1e-12, tolerance_change=1e-14,
                            history_size=20, line_search_fn="strong_wolfe")

    def keep_best(v):
        if float(v) > best[0]:
            best[0] = float(v)
            best[1] = (torch.exp(x_t).detach().cpu().numpy().copy(),
                       x_m.detach().cpu().numpy().copy())

    def closure():
        opt.zero_grad()
        v = lnl()
        keep_best(v.detach())
        f = -v / data.n_sites
        f.backward()
        return f

    with torch.no_grad():
        start = float(lnl())
    keep_best(torch.tensor(start))
    opt.step(closure)
    return start, best[0], best[1]
