"""Subpattern aliasing: detect repeated per-subtree site patterns.

Reference: `Alias_Subpatt` (utilities.c:13528) + the `patt_id_left/
rght` / `p_lk_loc` fields on edges (utilities.h:769-772), hooked into
`Update_Partial_Lk` (lk.c:1294): when two site patterns restrict to
identical tip states inside a subtree, their conditional-likelihood
vectors at that subtree's root are equal, so the reference copies the
CLV instead of recomputing it.

Device translation (a host-only copy of phyml_tpu/ops/alias.py).
Pattern columns are the lanes of a warp here: every lane of a tile
computes in the same instruction, so skipping a lane saves
nothing — the reference's copy-instead-of-recompute trick targets a
serial CPU cost model and would only pessimize a batched kernel.
What survives the translation is the *analysis*: the per-node
subpattern identity map.  It is exposed as data because several host
consumers genuinely need it:

  * duplicate-taxon detection (`Remove_Duplicates` utilities.c:2675)
    is leaf-level aliasing over the whole pattern set;
  * `alias_compaction(ids, node)` returns gather/scatter indices that
    shrink a per-node computation to its unique subpatterns — used
    when extracting per-node quantities on host (ancestral posteriors
    of clade-identical columns are identical, so downstream consumers
    can dedup);
  * `alias_stats` reports the redundancy the reference would exploit
    (`--alias_subpatt` diagnostic parity).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def tip_pattern_codes(aln) -> np.ndarray:
    """[n_otu, P] int64 code per (taxon, pattern): the ambiguity
    bitmask of compatible states (identical codes <=> identical tip
    partial vectors, cf. Init_Tips_At_One_Site_* lk.c:26-270)."""
    compat = aln.partials > 0.0                   # [n_otu, P, ns]
    ns = aln.ns
    weightsv = (1 << np.arange(ns, dtype=np.int64))
    return (compat.astype(np.int64) * weightsv[None, None, :]).sum(-1)


def subpattern_ids(tip_codes: np.ndarray,
                   child: np.ndarray) -> np.ndarray:
    """Postorder subpattern identities.

    tip_codes: [n_otu, P] integer codes per (leaf, pattern).
    child: [n_internal, 2] postorder child table (TreeArrays.child).

    Returns ids [n_nodes, P] int32 such that ids[u, p] == ids[u, q]
    iff patterns p and q are identical at every tip inside
    subtree(u).  Ids are dense per node (0..n_unique-1), in order of
    first occurrence — the equivalent of the reference's prefix-tree
    `pnode` numbering (utilities.h:1702).
    """
    n_otu, P = tip_codes.shape
    n_int = child.shape[0]
    n_nodes = n_otu + n_int
    ids = np.empty((n_nodes, P), dtype=np.int32)
    for u in range(n_otu):
        _, inv = np.unique(tip_codes[u], return_inverse=True)
        ids[u] = inv.astype(np.int32)
    for i in range(n_int):
        c0, c1 = child[i]
        hi = np.int64(ids[c1].max()) + 1
        key = ids[c0].astype(np.int64) * hi + ids[c1]
        _, inv = np.unique(key, return_inverse=True)
        ids[n_otu + i] = inv.astype(np.int32)
    return ids


def alias_compaction(ids_u: np.ndarray):
    """For one node's id row [P]: (representatives, inverse) with
    representatives int32 [n_unique] pattern indices (first
    occurrence) and inverse int32 [P] mapping every pattern to its
    representative slot — compute on representatives, scatter back
    with `out[inverse]` (the reference's p_lk_loc copy)."""
    _, first, inv = np.unique(ids_u, return_index=True,
                              return_inverse=True)
    return first.astype(np.int32), inv.astype(np.int32)


@dataclass
class AliasReport:
    n_nodes: int
    n_patterns: int
    unique_per_node: np.ndarray        # [n_nodes] int32
    redundancy: float                  # total cells / unique cells

    def __str__(self) -> str:           # --alias_subpatt diagnostic
        return (f"subpattern aliasing: {self.n_patterns} patterns, "
                f"mean unique/node "
                f"{self.unique_per_node.mean():.1f}, redundancy "
                f"{self.redundancy:.2f}x")


def alias_stats(aln, child: np.ndarray) -> AliasReport:
    ids = subpattern_ids(tip_pattern_codes(aln), np.asarray(child))
    uniq = (ids.max(axis=1) + 1).astype(np.int32)
    total = ids.shape[0] * ids.shape[1]
    return AliasReport(
        n_nodes=ids.shape[0], n_patterns=ids.shape[1],
        unique_per_node=uniq,
        redundancy=float(total) / float(uniq.sum()),
    )
