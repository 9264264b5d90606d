"""Fitch parsimony as bit-parallel tensor ops.

Reference: pars.c (Pars pars.c:20, Update_Partial_Pars pars.c:239) —
union/intersection state sets as bit vectors (`ui` fields,
utilities.h:776), weighted step counts.  The state set of every
(node, pattern) is an integer bitmask and the postorder combine walks
the rooted child table — the same schedule as the likelihood up-pass.
"""

from __future__ import annotations

import numpy as np
import torch


def _tip_masks(aln, P_pad: int) -> np.ndarray:
    """[n_otu, P_pad] int32 bitmasks of compatible states per pattern;
    padding columns (P_pad beyond the alignment's patterns) hold every
    state (phyml_tpu/ops/parsimony.py:18)."""
    compat = (aln.partials > 0)                     # [n_otu, P_raw, ns]
    ns = aln.ns
    bits = (compat.astype(np.int64) <<
            np.arange(ns, dtype=np.int64)[None, None, :]).sum(-1)
    pad = P_pad - bits.shape[1]
    full = (1 << ns) - 1
    bits = np.pad(bits, ((0, 0), (0, pad)), constant_values=full)
    return bits.astype(np.int32)


def parsimony_score(engine, topo, weights=None) -> int:
    """Weighted Fitch parsimony score of the topology (reference:
    Pars pars.c:20 with site weights)."""
    masks = getattr(engine, "_pars_masks", None)
    if masks is None:
        # a sharded engine keeps its own columns (LikelihoodEngine._columns)
        masks = engine._pars_masks = engine._columns(
            _tip_masks(engine.aln, engine.n_padded))
    w = engine._w(weights)
    n = engine.n_otu
    state = list(masks)
    steps = torch.zeros_like(w)
    for c0, c1 in topo.rooted().child.tolist():
        m0, m1 = state[c0], state[c1]
        inter = m0 & m1
        miss = inter == 0
        state.append(torch.where(miss, m0 | m1, inter))
        steps = steps + miss.to(w.dtype) * w
    assert len(state) == 2 * n - 1
    return int(engine._sum_sites(torch.sum(steps)))
