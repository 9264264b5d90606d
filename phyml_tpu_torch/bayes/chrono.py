"""Rooted time-trees (chronograms) for the Bayesian tier.

The reference represents dated trees by reusing the unrooted `t_tree`
with `t_node->anc` pointers plus a `times->nd_t[]` vector of node
times (utilities.h:1874-1956, times.c).  Here a chronogram is its own
small immutable object: a postorder child table (the exact layout the
likelihood engine consumes as `TreeArrays.child`) plus a node-height
vector, with heights measured backwards from the present (tips of a
contemporaneous alignment sit at height 0; serially-sampled tips carry
their own positive heights).  Edge durations and substitution branch
lengths are then pure functions of (heights, rates, clock) — see
`edge_durations` / `blen_from_times` — so the MCMC state is just the
internal-height vector and everything downstream is jit-traceable.

Reference anchors: TIMES_* (times.c), RATES_Update_One_Edge_Length
(rates.c:1244: l = clock_r * rate * (t_anc - t_des)).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TimeTree:
    """Rooted binary tree with node heights.

    Node ids: tips 0..n-1 (taxon order), internal nodes n..2n-2 in
    postorder (children always processed before parents); the root is
    node 2n-2.  `child[i]` are the two children of internal node n+i.
    """

    n_otu: int
    child: np.ndarray           # int32 [n-1, 2]
    heights: np.ndarray         # float64 [2n-1], time before present
    names: list[str] = field(default_factory=list)

    @property
    def n_nodes(self) -> int:
        return 2 * self.n_otu - 1

    @property
    def root(self) -> int:
        return self.n_nodes - 1

    @property
    def parent(self) -> np.ndarray:
        par = np.full(self.n_nodes, self.root, dtype=np.int32)
        for i in range(self.n_otu - 1):
            par[self.child[i, 0]] = self.n_otu + i
            par[self.child[i, 1]] = self.n_otu + i
        return par

    def validate(self) -> None:
        par = self.parent
        for u in range(self.n_nodes - 1):
            if self.heights[par[u]] < self.heights[u] - 1e-12:
                raise ValueError(
                    f"node {u} older than its parent "
                    f"({self.heights[u]} > {self.heights[par[u]]})"
                )

    # ------------------------------------------------------------------
    def edge_durations(self) -> np.ndarray:
        """dt[u] = heights[parent(u)] - heights[u]; dt[root] = 0."""
        dt = self.heights[self.parent] - self.heights
        dt[self.root] = 0.0
        return dt

    def to_topology(self):
        """Unrooted Topology with branch lengths = edge durations
        (the root node is suppressed; its two child edges merge)."""
        from phyml_tpu_torch.topology import Topology

        n = self.n_otu
        par = self.parent
        dt = self.edge_durations()
        edges, blen = [], []
        for u in range(self.n_nodes - 1):
            if par[u] == self.root:
                continue
            edges.append((u, int(par[u])))
            blen.append(dt[u])
        r0, r1 = (int(x) for x in self.child[-1])
        edges.append((r0, r1))
        blen.append(dt[r0] + dt[r1])
        topo = Topology(n, np.asarray(edges), np.asarray(blen))
        topo.validate()
        return topo

    def blen_from_times(self, clock_rate: float,
                        rates: np.ndarray | None = None) -> np.ndarray:
        """Substitution branch lengths l = clock_r * rate * dt
        (RATES_Update_One_Edge_Length rates.c:1244)."""
        dt = self.edge_durations()
        if rates is None:
            return clock_rate * dt
        return clock_rate * np.asarray(rates) * dt

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_topology(cls, topo, names=None, root_edge: int | None = None,
                      tip_heights=None) -> "TimeTree":
        """Root an unrooted Topology at `root_edge` (default: the last
        edge) and assign feasible starting heights:
        height(u) = max_children(height(c) + blen_in(c)), i.e. the
        input branch lengths read as durations where consistent and
        stretched to feasibility otherwise (the MCMC owns the heights
        after initialization; ≙ TIMES_Randomize_Node_Times'
        feasible-start role)."""
        n = topo.n_otu
        if root_edge is None:
            root_edge = topo.n_edges - 1
        adj = topo.adjacency()
        a, b = topo.edges[root_edge]

        child = np.zeros((n - 1, 2), dtype=np.int32)
        heights = np.zeros(2 * n - 1, dtype=np.float64)
        th = np.zeros(n) if tip_heights is None else np.asarray(
            tip_heights, dtype=np.float64)
        counter = [n]

        def build(u: int, came: int) -> tuple[int, float]:
            """Returns (new node id, height)."""
            stack = [(u, came, False, None)]
            results: dict[tuple[int, int], tuple[int, float]] = {}
            order: list[tuple[int, int]] = []
            # iterative postorder
            while stack:
                uu, cc, done, _ = stack.pop()
                if uu < n:
                    results[(uu, cc)] = (uu, float(th[uu]))
                    continue
                if done:
                    order.append((uu, cc))
                    continue
                stack.append((uu, cc, True, None))
                for v, eid in adj[uu]:
                    if v != cc:
                        stack.append((v, uu, False, None))
            for (uu, cc) in order:
                kids = []
                for v, eid in adj[uu]:
                    if v != cc:
                        nid, h = results[(v, uu)]
                        kids.append((nid, h + max(topo.blen[eid], 1e-8)))
                nid = counter[0]
                counter[0] += 1
                child[nid - n] = [kids[0][0], kids[1][0]]
                h = max(k[1] for k in kids)
                heights[nid] = h
                results[(uu, cc)] = (nid, h)
            return results[(u, came)]

        ra, ha = build(a, b)
        rb, hb = build(b, a)
        half = max(topo.blen[root_edge] / 2.0, 1e-8)
        root = 2 * n - 2
        child[n - 2] = [ra, rb]
        heights[root] = max(ha + half, hb + half)
        tt = cls(n_otu=n, child=child, heights=heights,
                 names=list(names) if names else
                 [f"t{i}" for i in range(n)])
        tt.validate()
        return tt

    @classmethod
    def coalescent(cls, n_otu: int, rng, theta: float = 1.0,
                   names=None) -> "TimeTree":
        """Simulate a Kingman coalescent tree (rate k(k-1)/theta while
        k lineages remain): used for tests and by the sequence
        simulator (≙ the coalescent tree simulator, evolve.c:1070)."""
        n = n_otu
        child = np.zeros((n - 1, 2), dtype=np.int32)
        heights = np.zeros(2 * n - 1, dtype=np.float64)
        active = list(range(n))
        t = 0.0
        nxt = n
        while len(active) > 1:
            k = len(active)
            t += rng.exponential(theta / (k * (k - 1)))
            i, j = sorted(rng.choice(k, size=2, replace=False))
            v = active.pop(j)
            u = active.pop(i)
            child[nxt - n] = [u, v]
            heights[nxt] = t
            active.append(nxt)
            nxt += 1
        tt = cls(n_otu=n, child=child, heights=heights,
                 names=list(names) if names else
                 [f"t{i}" for i in range(n)])
        tt.validate()
        return tt

    # ------------------------------------------------------------------
    def to_newick(self, rates: np.ndarray | None = None,
                  clock_rate: float = 1.0, time_units: bool = True,
                  ) -> str:
        """Newick chronogram.  time_units=True writes branch durations
        (the chronogram output of phytime); otherwise substitution
        lengths clock*rate*dt."""
        dt = self.edge_durations()
        if not time_units:
            dt = self.blen_from_times(clock_rate, rates)
        n = self.n_otu

        # iterative to avoid recursion limits on big trees
        memo = [""] * self.n_nodes
        for u in range(n):
            nm = self.names[u] if self.names else f"t{u}"
            memo[u] = f"{nm}:{dt[u]:.8f}"
        for i in range(n - 1):
            u = n + i
            c0, c1 = self.child[i]
            s = f"({memo[c0]},{memo[c1]})"
            memo[u] = s + ";" if u == self.root else s + f":{dt[u]:.8f}"
        return memo[self.root]

    def mrca(self, taxa: list[int]) -> int:
        """MRCA node id of a set of tip ids (clade targeting for
        calibrations, ≙ the <clade>/<calibration> handling of
        xml.c:2417 and Find_Clade)."""
        par = self.parent
        anc = []
        u = int(taxa[0])
        while True:
            anc.append(u)
            if u == self.root:
                break
            u = int(par[u])
        anc_set = set(anc)
        for v in taxa[1:]:
            u = int(v)
            while u not in anc_set:
                u = int(par[u])
            # drop ancestors strictly below the meeting point
            keep = set()
            w = u
            while True:
                keep.add(w)
                if w == self.root:
                    break
                w = int(par[w])
            anc_set &= keep
        return min(anc_set, key=lambda x: self.heights[x])
