"""BioNJ agglomerative starting tree (Gascuel 1997).

Reference: bionj.c:25 (Bionj), Dist_And_BioNJ utilities.c:9172.
Host-side numpy: the O(n^3) agglomeration is a few ms even for
thousands of taxa and runs once per analysis, so there is nothing to
gain from putting it on device.

Algorithm: classic neighbor-joining selection by the Q criterion, with
BioNJ's variance-weighted update of the reduced distance matrix
(lambda chosen to minimize the variance of the new distances,
matching Lamda/Finish in bionj.c).
"""

from __future__ import annotations

import numpy as np

from phyml_tpu_torch.topology import Topology

BL_MIN = 1e-8
BL_MAX = 100.0


def bionj(D: np.ndarray, n_otu: int | None = None) -> Topology:
    """Build an unrooted binary tree from a symmetric distance matrix.

    Node ids follow the package convention: tips 0..n-1, internal
    n..2n-3 assigned in agglomeration order.
    """
    D = np.array(D, dtype=np.float64)
    n = D.shape[0] if n_otu is None else n_otu
    assert D.shape == (n, n)
    if n == 2:
        raise ValueError("need >= 3 taxa")
    # variance matrix starts equal to D (bionj.c: v = d)
    V = D.copy()
    active = list(range(n))          # current cluster -> node id
    next_internal = n
    edges: list[list[int]] = []
    blen: list[float] = []

    # work on index lists into the shrinking matrices
    while len(active) > 3:
        m = len(active)
        Dsub = D[:m, :m]
        r = Dsub.sum(axis=1)
        # Q criterion (sum-based form): minimize (m-2) d_ij - r_i - r_j
        Q = (m - 2) * Dsub - r[:, None] - r[None, :]
        np.fill_diagonal(Q, np.inf)
        i, j = np.unravel_index(np.argmin(Q), Q.shape)
        if i > j:
            i, j = j, i
        dij = Dsub[i, j]
        # branch lengths to the new node (standard NJ)
        li = 0.5 * dij + (r[i] - r[j]) / (2.0 * (m - 2))
        lj = dij - li
        li = float(np.clip(li, BL_MIN, BL_MAX))
        lj = float(np.clip(lj, BL_MIN, BL_MAX))
        new_id = next_internal
        next_internal += 1
        edges.append([new_id, active[i]])
        blen.append(li)
        edges.append([new_id, active[j]])
        blen.append(lj)

        # BioNJ lambda: weight for the reduction, from variances
        vij = V[i, j]
        if vij > 1e-12 and m > 2:
            others = [k for k in range(m) if k not in (i, j)]
            lam = 0.5 + (V[j, others] - V[i, others]).sum() \
                / (2.0 * (m - 2) * vij)
            lam = float(np.clip(lam, 0.0, 1.0))
        else:
            lam = 0.5
        # reduced distances & variances (bionj.c Reduction)
        du = lam * (D[i, :m] - li) + (1.0 - lam) * (D[j, :m] - lj)
        vu = lam * V[i, :m] + (1.0 - lam) * V[j, :m] \
            - lam * (1.0 - lam) * vij
        # overwrite row i with the new cluster, delete row j
        D[i, :m] = du
        D[:m, i] = du
        D[i, i] = 0.0
        V[i, :m] = vu
        V[:m, i] = vu
        V[i, i] = 0.0
        keep = [k for k in range(m) if k != j]
        D[:m - 1, :m - 1] = D[np.ix_(keep, keep)]
        V[:m - 1, :m - 1] = V[np.ix_(keep, keep)]
        active[i] = new_id
        active.pop(j)

    # final 3-star (bionj.c Finish)
    a, b, c = active
    d01, d02, d12 = D[0, 1], D[0, 2], D[1, 2]
    center = next_internal
    la = 0.5 * (d01 + d02 - d12)
    lb = 0.5 * (d01 + d12 - d02)
    lc = 0.5 * (d02 + d12 - d01)
    for node, ln in ((a, la), (b, lb), (c, lc)):
        edges.append([center, node])
        blen.append(float(np.clip(ln, BL_MIN, BL_MAX)))

    t = Topology(n, np.asarray(edges, dtype=np.int32),
                 np.asarray(blen, dtype=np.float64))
    t.validate()
    return t


def bionj_start(engine, params, weights=None) -> Topology:
    """ML distances + BioNJ (the reference's default starting tree,
    Dist_And_BioNJ utilities.c:9172)."""
    from phyml_tpu_torch.search.distances import ml_pairwise_distances
    D = ml_pairwise_distances(engine, params, weights=weights)
    return bionj(D)
