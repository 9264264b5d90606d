"""Topological constraints (reference: --constraint_file, cl.c, and
the compatibility machinery of utilities.c Check_Constraint_Tree).

A constraint is a (possibly multifurcating) tree over all taxa.  A
binary tree is compatible iff every non-trivial constraint clade
appears among its bipartitions.  The search starts from a random
binary resolution of the constraint tree and NNI/SPR moves that would
break a constraint clade are rejected (the reference restricts the
move set the same way).
"""

from __future__ import annotations

import numpy as np

from phyml_tpu_torch.topology import Topology


class Constraint:
    """Set of required bipartitions over the taxon set `names`."""

    def __init__(self, root, names: list[str]):
        self._root = root
        self.names = list(names)
        self._name_to_id = {nm: i for i, nm in enumerate(names)}
        n = len(names)
        self.bips: set[frozenset] = set()

        def rec(node) -> set[int]:
            if node.is_leaf:
                if node.name not in self._name_to_id:
                    raise ValueError(
                        f"constraint taxon {node.name!r} not in alignment")
                return {self._name_to_id[node.name]}
            tips: set[int] = set()
            for c in node.children:
                tips |= rec(c)
            if 2 <= len(tips) <= n - 2:
                side = tips if 0 not in tips else set(range(n)) - tips
                self.bips.add(frozenset(side))
            return tips

        all_tips = rec(root)
        if len(all_tips) != n:
            raise ValueError(
                f"constraint tree covers {len(all_tips)}/{n} taxa; the "
                "reference requires all taxa present")

    @classmethod
    def from_newick(cls, text: str, names: list[str]) -> "Constraint":
        from phyml_tpu_torch.io.newick import parse_newick
        return cls(parse_newick(text), names)

    @classmethod
    def from_file(cls, path: str, names: list[str]) -> "Constraint":
        with open(path) as fh:
            return cls.from_newick(fh.read(), names)

    # ------------------------------------------------------------------
    def is_compatible(self, topo: Topology) -> bool:
        if not self.bips:
            return True
        return self.bips <= set(topo.bipartitions().keys())

    # ------------------------------------------------------------------
    def random_resolution(
        self, rng: np.random.Generator, mean_blen: float = 0.1,
    ) -> Topology:
        """Random binary resolution of the constraint tree (the
        reference's starting point for constrained searches)."""
        import copy

        from phyml_tpu_torch.io.newick import NewickNode

        root = copy.deepcopy(self._root)

        def resolve(node, is_root: bool) -> None:
            for c in node.children:
                resolve(c, False)
            limit = 3 if is_root else 2
            kids = list(node.children)
            while len(kids) > limit:
                i, j = sorted(rng.choice(len(kids), 2, replace=False))
                merged = NewickNode(
                    name=None, length=float(rng.exponential(mean_blen)),
                    children=[kids[i], kids[j]])
                kids = ([k for k_i, k in enumerate(kids)
                         if k_i not in (i, j)] + [merged])
            node.children = kids

        resolve(root, True)

        def fill(node) -> None:
            if node.length is None or node.length <= 0:
                node.length = float(rng.exponential(mean_blen))
            for c in node.children:
                fill(c)

        for c in root.children:
            fill(c)
        topo = Topology.from_newick(root, self.names)
        assert self.is_compatible(topo)
        return topo
