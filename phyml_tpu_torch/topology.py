"""Unrooted phylogenetic tree as flat arrays + rooted device schedule.

This replaces the reference's pointer-based mutable object model
(t_tree / t_edge / t_node, utilities.h:635-1023, with surgery in
utilities.c:6152 Prune_Subtree / utilities.c:6539 Graft_Subtree and
NNI Swap utilities.c:2115).  Design differences, deliberate and
TPU-first:

  * The unrooted tree lives host-side as a plain edge list
    (numpy int32 [n_edges, 2] + float64 branch lengths).  Surgery is
    O(1) edits of the edge list; no pointer webs.
  * For device compute the tree is rooted at a virtual root placed on
    tip 0's edge, and internal nodes are *re-indexed into postorder*,
    so the likelihood scan is a `lax.scan` over a contiguous index
    range with a static-shape [n_internal, 2] child table.  Topology
    is pure data: every topology of the same taxon count compiles to
    the same XLA program.
  * Branch lengths are carried per rooted node (edge to parent) and
    are a continuous parameter vector, separate from the discrete
    topology.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class RootedView:
    """Static-shape device schedule for one topology.

    n_nodes = 2*n_otu - 1 (tips 0..n_otu-1, internal n_otu..2n-2,
    root = 2n-2).  Internal nodes are in postorder: children always
    have lower index than parents, so a scan over internal nodes in
    index order satisfies all dependencies.
    """

    n_otu: int
    child: np.ndarray        # int32 [n_internal, 2]
    parent: np.ndarray       # int32 [n_nodes] (root -> itself)
    node_blen: np.ndarray    # float64 [n_nodes] edge length to parent
    node_to_edge: np.ndarray  # int32 [n_nodes] unrooted edge id or -1
    unrooted_id: np.ndarray   # int32 [n_nodes] unrooted node id
    #                           (-1 for the virtual root)

    @property
    def n_nodes(self) -> int:
        return 2 * self.n_otu - 1

    @property
    def n_internal(self) -> int:
        return self.n_otu - 1

    @property
    def root(self) -> int:
        return self.n_nodes - 1


class Topology:
    """Unrooted binary tree over n_otu taxa (edge-list representation).

    Node ids: 0..n_otu-1 are tips (aligned with Alignment.names order),
    n_otu..2*n_otu-3 are internal (degree 3).  Edges: [n_edges, 2]
    int32 with n_edges = 2*n_otu - 3.
    """

    def __init__(self, n_otu: int, edges: np.ndarray, blen: np.ndarray):
        self.n_otu = int(n_otu)
        self.edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
        self.blen = np.asarray(blen, dtype=np.float64).reshape(-1)
        assert self.edges.shape[0] == 2 * self.n_otu - 3, (
            f"expected {2 * self.n_otu - 3} edges, got {self.edges.shape[0]}"
        )
        assert self.blen.shape[0] == self.edges.shape[0]

    # ------------------------------------------------------------------
    # basic structure
    # ------------------------------------------------------------------
    @property
    def n_edges(self) -> int:
        return self.edges.shape[0]

    @property
    def n_nodes_unrooted(self) -> int:
        return 2 * self.n_otu - 2

    def copy(self) -> "Topology":
        return Topology(self.n_otu, self.edges.copy(), self.blen.copy())

    def adjacency(self) -> list[list[tuple[int, int]]]:
        """adj[node] = [(neighbor, edge_id), ...]"""
        adj: list[list[tuple[int, int]]] = [
            [] for _ in range(self.n_nodes_unrooted)
        ]
        for eid, (a, b) in enumerate(self.edges):
            adj[a].append((int(b), eid))
            adj[b].append((int(a), eid))
        return adj

    def validate(self) -> None:
        adj = self.adjacency()
        for v in range(self.n_otu):
            assert len(adj[v]) == 1, f"tip {v} degree {len(adj[v])}"
        for v in range(self.n_otu, self.n_nodes_unrooted):
            assert len(adj[v]) == 3, f"internal {v} degree {len(adj[v])}"

    # ------------------------------------------------------------------
    # rooted view (device schedule)
    # ------------------------------------------------------------------
    def rooted(self) -> RootedView:
        """Root at a virtual node on tip 0's edge; postorder-index
        internal nodes.  The full length of tip 0's unrooted edge is
        carried on the tip-0 side (pulley principle: the split does
        not change the likelihood).

        Hot path: built by the native treekit (C++) when available —
        this runs once per applied search move — with the Python DFS
        as fallback (identical output)."""
        n = self.n_otu
        from phyml_tpu_torch import native
        nat = native.rooted_view_arrays(n, self.edges, self.blen)
        if nat is not None:
            child, parent, node_blen, node_to_edge, unrooted_id = nat
            return RootedView(
                n_otu=n, child=child, parent=parent,
                node_blen=node_blen, node_to_edge=node_to_edge,
                unrooted_id=unrooted_id,
            )
        n_nodes = 2 * n - 1
        root = n_nodes - 1
        adj = self.adjacency()
        tip0_nbr, tip0_edge = adj[0][0]

        parent = np.full(n_nodes, -1, dtype=np.int32)
        node_blen = np.zeros(n_nodes, dtype=np.float64)
        node_to_edge = np.full(n_nodes, -1, dtype=np.int32)
        # map unrooted internal node id -> rooted index (assigned in
        # postorder); tips keep their ids.
        rooted_id = np.full(self.n_nodes_unrooted, -1, dtype=np.int64)
        for t in range(n):
            rooted_id[t] = t

        child_rows: list[tuple[int, int]] = []
        next_internal = [n]

        def assign(u: int, came_from: int) -> int:
            """Postorder DFS from unrooted node u entered via edge from
            came_from; returns rooted index of u."""
            if u < n:
                return u
            kids = []
            for v, eid in adj[u]:
                if v == came_from:
                    continue
                rid = assign(v, u)
                node_to_edge[rid] = eid
                node_blen[rid] = self.blen[eid]
                kids.append(rid)
            my_id = next_internal[0]
            next_internal[0] += 1
            rooted_id[u] = my_id
            assert len(kids) == 2, f"internal node {u} arity {len(kids)}"
            child_rows.append((kids[0], kids[1]))
            for k in kids:
                parent[k] = my_id
            return my_id

        # Deep trees exceed Python's default recursion limit; use an
        # explicit stack version for safety on big n.
        if n > 400:
            v_id = self._assign_iterative(
                adj, tip0_nbr, parent, node_blen, node_to_edge,
                rooted_id, child_rows, next_internal,
            )
        else:
            import sys
            old = sys.getrecursionlimit()
            sys.setrecursionlimit(max(old, 4 * n + 100))
            v_id = assign(tip0_nbr, 0)
            sys.setrecursionlimit(old)

        # Root over (tip0, v): full length on tip-0 side, zero on v.
        node_to_edge[0] = tip0_edge
        node_blen[0] = self.blen[tip0_edge]
        node_to_edge[v_id] = tip0_edge
        node_blen[v_id] = 0.0
        parent[0] = root
        parent[v_id] = root
        parent[root] = root
        child_rows.append((0, v_id))

        child = np.asarray(child_rows, dtype=np.int32)
        assert child.shape == (n - 1, 2)
        unrooted_id = np.full(n_nodes, -1, dtype=np.int32)
        for uu in range(self.n_nodes_unrooted):
            if rooted_id[uu] >= 0:
                unrooted_id[rooted_id[uu]] = uu
        return RootedView(
            n_otu=n, child=child, parent=parent,
            node_blen=node_blen, node_to_edge=node_to_edge,
            unrooted_id=unrooted_id,
        )

    def _assign_iterative(
        self, adj, start, parent, node_blen, node_to_edge,
        rooted_id, child_rows, next_internal,
    ) -> int:
        n = self.n_otu
        # iterative postorder
        stack = [(start, 0, False)]
        kids_stack: dict[int, list[int]] = {}
        result: dict[tuple[int, int], int] = {}
        while stack:
            u, came, done = stack.pop()
            if u < n:
                result[(u, came)] = u
                continue
            if not done:
                stack.append((u, came, True))
                kids_stack[u] = []
                for v, eid in adj[u]:
                    if v != came:
                        stack.append((v, u, False))
            else:
                kids = []
                for v, eid in adj[u]:
                    if v == came:
                        continue
                    rid = result[(v, u)]
                    node_to_edge[rid] = eid
                    node_blen[rid] = self.blen[eid]
                    kids.append(rid)
                my_id = next_internal[0]
                next_internal[0] += 1
                rooted_id[u] = my_id
                child_rows.append((kids[0], kids[1]))
                for k in kids:
                    parent[k] = my_id
                result[(u, came)] = my_id
        return result[(start, 0)]

    def set_blen_from_rooted(
        self, rv: RootedView, node_blen: np.ndarray
    ) -> None:
        """Write optimized per-node branch lengths back to the unrooted
        edge list.  The two root children share one unrooted edge; sum
        their slots."""
        blen = np.zeros(self.n_edges, dtype=np.float64)
        for v in range(rv.n_nodes - 1):
            e = rv.node_to_edge[v]
            if e >= 0:
                blen[e] += float(node_blen[v])
        self.blen = blen

    # ------------------------------------------------------------------
    # surgery
    # ------------------------------------------------------------------
    def nni(self, edge_id: int, variant: int) -> "Topology":
        """One nearest-neighbor interchange across internal edge
        edge_id (reference: Swap utilities.c:2115).  variant in {0, 1}
        selects which pair of subtrees is exchanged."""
        t = self.copy()
        u, v = t.edges[edge_id]
        assert u >= t.n_otu and v >= t.n_otu, "NNI needs an internal edge"
        adj = t.adjacency()
        u_nbrs = [(w, e) for (w, e) in adj[u] if e != edge_id]
        v_nbrs = [(w, e) for (w, e) in adj[v] if e != edge_id]
        (a, ea) = u_nbrs[0]
        (b, eb) = v_nbrs[variant]
        # exchange subtrees a and b across the edge
        t.edges[ea] = [u, b]
        t.edges[eb] = [v, a]
        t.validate()
        return t

    def swap_across(
        self, ea: int, na: int, eb: int, nb: int
    ) -> "Topology":
        """Exchange the subtree hanging at endpoint `na` of edge `ea`
        with the subtree at endpoint `nb` of edge `eb` (an NNI when ea
        and eb are the two side edges of an internal edge).  Endpoint
        ids are unrooted node ids.  Each subtree carries its pendant
        branch length with it (reference Swap utilities.c:2115 moves
        nodes, keeping each subtree's edge length attached)."""
        t = self.copy()
        a0, a1 = (int(x) for x in t.edges[ea])
        b0, b1 = (int(x) for x in t.edges[eb])
        assert na in (a0, a1) and nb in (b0, b1)
        t.edges[ea] = [a0 if a1 == na else a1, nb]
        t.edges[eb] = [b0 if b1 == nb else b1, na]
        t.blen[ea], t.blen[eb] = t.blen[eb], t.blen[ea]
        t.validate()
        return t

    def spr(
        self, prune_edge: int, prune_side: int, regraft_edge: int,
        regraft_frac: float = 0.5, return_new_edge: bool = False,
    ) -> "Topology":
        """Subtree-prune-regraft (reference: Prune_Subtree
        utilities.c:6152 + Graft_Subtree utilities.c:6539).

        prune_edge (a,b): the subtree on side `prune_side` (0 -> keep a
        as the moving subtree's attachment... concretely: link node is
        edges[prune_edge][prune_side ^ 1]) is detached together with
        its link node; the link's two remaining edges are merged.  The
        link is then re-inserted into regraft_edge, splitting its
        length by regraft_frac."""
        t = self.copy()
        a, b = (int(x) for x in t.edges[prune_edge])
        link = b if prune_side == 0 else a   # internal node to excise
        sub = a if prune_side == 0 else b    # root of moving subtree
        assert link >= t.n_otu, "cannot prune at a tip-side link"
        adj = t.adjacency()
        rest = [(w, e) for (w, e) in adj[link] if e != prune_edge]
        assert len(rest) == 2
        (x, ex), (y, ey) = rest
        assert regraft_edge not in (prune_edge, ex, ey), (
            "regraft target must be outside the pruned region"
        )
        # heal: merge ex & ey into ex = (x, y); ey becomes the new
        # half-edge created by the graft split.
        merged_len = t.blen[ex] + t.blen[ey]
        t.edges[ex] = [x, y]
        t.blen[ex] = merged_len
        # graft: split regraft_edge (p, q) -> (p, link) + (link, q)
        p, q = (int(z) for z in t.edges[regraft_edge])
        old_len = t.blen[regraft_edge]
        t.edges[regraft_edge] = [p, link]
        t.blen[regraft_edge] = old_len * regraft_frac
        t.edges[ey] = [link, q]
        t.blen[ey] = old_len * (1.0 - regraft_frac)
        t.validate()
        if return_new_edge:
            # regraft_edge now holds (p, link); ey holds (link, q)
            return t, ey
        return t

    # ------------------------------------------------------------------
    # bipartitions (reference: Get_Bip utilities.c:4720 /
    # Compare_Bip utilities.c:4972)
    # ------------------------------------------------------------------
    def bipartitions(self) -> dict[frozenset, int]:
        """Map canonical tip-set (side not containing tip 0) ->
        edge id, for internal edges only."""
        rv = self.rooted()
        n = self.n_otu
        below: list[set] = [set() for _ in range(rv.n_nodes)]
        for t in range(n):
            below[t] = {t}
        for i in range(rv.n_internal):
            node = n + i
            c0, c1 = rv.child[i]
            below[node] = below[c0] | below[c1]
        out: dict[frozenset, int] = {}
        for v in range(rv.n_nodes - 1):
            eid = int(rv.node_to_edge[v])
            if eid < 0:
                continue
            u, w = self.edges[eid]
            if u < n or w < n:
                continue  # trivial bipartition
            side = below[v]
            if 0 in side:
                side = set(range(n)) - side
            out[frozenset(side)] = eid
        return out

    def rf_distance(self, other: "Topology") -> int:
        b1 = set(self.bipartitions().keys())
        b2 = set(other.bipartitions().keys())
        return len(b1 ^ b2)

    # ------------------------------------------------------------------
    # newick
    # ------------------------------------------------------------------
    @classmethod
    def from_newick(
        cls, text_or_node, names: list[str]
    ) -> "Topology":
        from phyml_tpu_torch.io.newick import NewickNode, parse_newick

        if isinstance(text_or_node, str):
            # native tokenizer fast path (treekit.cpp); identical
            # semantics to the Python parser below
            from phyml_tpu_torch import native
            try:
                arrs = native.parse_newick_arrays(text_or_node)
            except ValueError:
                arrs = None  # surface the error via the Python parser
            if arrs is not None:
                return cls._from_newick_arrays(*arrs, names=names)
        node = (
            text_or_node
            if isinstance(text_or_node, NewickNode)
            else parse_newick(text_or_node)
        )
        name_to_id = {nm: i for i, nm in enumerate(names)}
        n = len(names)
        edges: list[list[int]] = []
        blens: list[float] = []
        next_id = [n]

        def build(nw) -> tuple[int, float]:
            """Returns (node_id, pendant_length)."""
            if nw.is_leaf:
                if nw.name not in name_to_id:
                    raise ValueError(f"taxon {nw.name!r} not in alignment")
                return name_to_id[nw.name], (nw.length or 0.0)
            kids = [build(c) for c in nw.children]
            if len(kids) == 1:  # unary node: collapse
                cid, clen = kids[0]
                return cid, clen + (nw.length or 0.0)
            my = next_id[0]
            next_id[0] += 1
            for cid, clen in kids:
                edges.append([my, cid])
                blens.append(clen)
            return my, (nw.length or 0.0)

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 6 * n + 1000))
        kids = [build(c) for c in node.children]
        sys.setrecursionlimit(old)
        if len(kids) == 2:
            # rooted input: suppress the root (join its two children)
            (c0, l0), (c1, l1) = kids
            edges.append([c0, c1])
            blens.append(l0 + l1)
        else:
            my = next_id[0]
            next_id[0] += 1
            for cid, clen in kids:
                edges.append([my, cid])
                blens.append(clen)

        # Internal ids were assigned top-down; they may exceed the
        # unrooted budget when the root was suppressed.  Compact ids.
        e = np.asarray(edges, dtype=np.int64)
        used = np.unique(e[e >= n])
        remap = {int(old_id): n + k for k, old_id in enumerate(used)}
        for row in e:
            for j in (0, 1):
                if row[j] >= n:
                    row[j] = remap[int(row[j])]
        topo = cls(n, e.astype(np.int32), np.asarray(blens))
        topo.validate()
        return topo

    @classmethod
    def _from_newick_arrays(cls, parent, length, node_names,
                            names: list[str]) -> "Topology":
        """Build from the native tokenizer's flat preorder arrays —
        same unary-collapse / root-suppression semantics as the
        recursive path, but iterative (no recursion limit)."""
        name_to_id = {nm: i for i, nm in enumerate(names)}
        n = len(names)
        n_raw = len(parent)
        kids_raw: list[list[int]] = [[] for _ in range(n_raw)]
        for i in range(1, n_raw):
            kids_raw[int(parent[i])].append(i)

        edges: list[list[int]] = []
        blens: list[float] = []
        next_id = [n]
        res: list[tuple | None] = [None] * n_raw
        # preorder indexing => children have larger ids than parents,
        # so a reverse sweep resolves bottom-up
        for i in range(n_raw - 1, -1, -1):
            plen = 0.0 if np.isnan(length[i]) else float(length[i])
            ks = kids_raw[i]
            if not ks:
                nm = node_names[i]
                if nm not in name_to_id:
                    raise ValueError(f"taxon {nm!r} not in alignment")
                res[i] = (name_to_id[nm], plen)
            elif len(ks) == 1:
                cid, clen = res[ks[0]]
                res[i] = (cid, clen + plen)
            else:
                my = next_id[0]
                next_id[0] += 1
                for k in ks:
                    cid, clen = res[k]
                    edges.append([my, cid])
                    blens.append(clen)
                res[i] = (my, plen)

        root_kids = [res[k] for k in kids_raw[0]]
        if len(root_kids) == 2:
            # rooted input: drop the degree-2 root, join its children
            my, _ = res[0]
            keep = [e for e, b in zip(edges, blens) if e[0] != my]
            kb = [b for e, b in zip(edges, blens) if e[0] != my]
            (c0, l0), (c1, l1) = root_kids
            keep.append([c0, c1])
            kb.append(l0 + l1)
            edges, blens = keep, kb
        e = np.asarray(edges, dtype=np.int64)
        used = np.unique(e[e >= n])
        remap = {int(old_id): n + k for k, old_id in enumerate(used)}
        for row in e:
            for j in (0, 1):
                if row[j] >= n:
                    row[j] = remap[int(row[j])]
        topo = cls(n, e.astype(np.int32), np.asarray(blens))
        topo.validate()
        return topo

    def to_newick(
        self, names: list[str], fmt: str = "%.8f",
        support: dict[int, str] | None = None,
        node_labels: dict[int, str] | None = None,
    ) -> str:
        """Unrooted newick with a trifurcation at tip 0's neighbor
        (matching the reference's output rooting convention,
        io.c:714 Write_Tree).  `support` maps edge id -> label;
        `node_labels` maps internal (unrooted) node id -> label
        (used by the ancestral-sequence tree, ancestral.c:582-588)."""
        adj = self.adjacency()
        start = adj[0][0][0]

        def rec(u: int, came: int, eid_in: int) -> str:
            if u < self.n_otu:
                return f"{names[u]}:{fmt % self.blen[eid_in]}"
            parts = [
                rec(v, u, eid) for (v, eid) in adj[u] if v != came
            ]
            label = ""
            if support is not None and eid_in >= 0:
                label = support.get(eid_in, "")
            if node_labels is not None:
                label = node_labels.get(u, label)
            out = "(" + ",".join(parts) + ")" + label
            if eid_in >= 0:
                out += f":{fmt % self.blen[eid_in]}"
            return out

        import sys
        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 6 * self.n_otu + 1000))
        if self.n_otu == 2:
            s = (f"({names[0]}:{fmt % self.blen[0]},"
                 f"{names[1]}:0.0);")
            sys.setrecursionlimit(old)
            return s
        parts = [rec(0, start, adj[0][0][1])]
        parts += [
            rec(v, start, eid) for (v, eid) in adj[start] if v != 0
        ]
        sys.setrecursionlimit(old)
        root_label = ""
        if node_labels is not None:
            root_label = node_labels.get(start, "")
        return "(" + ",".join(parts) + ")" + root_label + ";"

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    def without_leaves(self, drop: set[int]) -> "Topology":
        """Prune a set of tips (reference: Prune_Subtree
        utilities.c:6152 applied per duplicate in
        Remove_Duplicates_From_Tree utilities.c:2768).  Kept tips are
        renumbered to 0..k-1 in ascending original order (matching
        the reduced Alignment's name order); the two edges around each
        suppressed degree-2 node merge with summed lengths."""
        drop = set(int(d) for d in drop)
        keep = [t for t in range(self.n_otu) if t not in drop]
        assert len(keep) >= 3, "cannot prune below 3 taxa"
        # adjacency with mutable edge set
        edges = {i: (int(a), int(b), float(l)) for i, ((a, b), l) in
                 enumerate(zip(self.edges, self.blen))}
        adj: dict[int, set[int]] = {}
        for eid, (a, b, _) in edges.items():
            adj.setdefault(a, set()).add(eid)
            adj.setdefault(b, set()).add(eid)

        def other(eid, u):
            a, b, _ = edges[eid]
            return b if a == u else a

        for t in sorted(drop):
            (eid,) = adj[t]
            v = other(eid, t)
            del edges[eid]
            adj[v].discard(eid)
            adj.pop(t)
            if len(adj[v]) == 2:           # suppress degree-2 node
                e1, e2 = sorted(adj[v])
                u1, u2 = other(e1, v), other(e2, v)
                ln = edges[e1][2] + edges[e2][2]
                del edges[e2]
                adj[u2].discard(e2)
                edges[e1] = (u1, u2, ln)
                adj[u2].add(e1)
                adj.pop(v)
        # renumber: kept tips 0..k-1, internals k..2k-3
        k = len(keep)
        remap = {old: new for new, old in enumerate(keep)}
        internals = sorted(u for u in adj if u >= self.n_otu)
        for j, u in enumerate(internals):
            remap[u] = k + j
        e_arr = np.asarray(
            [[remap[a], remap[b]] for (a, b, _) in edges.values()],
            dtype=np.int32)
        l_arr = np.asarray([l for (_, _, l) in edges.values()])
        t = Topology(k, e_arr, l_arr)
        t.validate()
        return t

    @classmethod
    def caterpillar(cls, n_otu: int, blen: float = 0.1) -> "Topology":
        """Ladder (caterpillar) topology: tips hang off a single
        internal chain.  Maximum pruning-recursion depth for a given
        taxon count — the stress case for CLV rescaling."""
        assert n_otu >= 3
        n = n_otu
        edges = [[n, 0], [n, 1]]
        for i in range(2, n - 1):
            link = n + i - 1
            edges.append([link - 1, link])
            edges.append([link, i])
        edges.append([2 * n - 3, n - 1])
        t = cls(n, np.asarray(edges, dtype=np.int32),
                np.full(len(edges), blen))
        t.validate()
        return t

    @classmethod
    def random(
        cls, n_otu: int, rng: np.random.Generator,
        mean_blen: float = 0.1,
    ) -> "Topology":
        """Random topology by sequential random addition (reference:
        Random_Tree utilities.c)."""
        assert n_otu >= 3
        n = n_otu
        # start with 3-taxon star around internal node n
        edges = [[n, 0], [n, 1], [n, 2]]
        next_internal = n + 1
        for tip in range(3, n):
            eid = int(rng.integers(0, len(edges)))
            p, q = edges[eid]
            link = next_internal
            next_internal += 1
            edges[eid] = [p, link]
            edges.append([link, q])
            edges.append([link, tip])
        blen = rng.exponential(mean_blen, size=len(edges))
        t = cls(n, np.asarray(edges, dtype=np.int32), blen)
        t.validate()
        return t
