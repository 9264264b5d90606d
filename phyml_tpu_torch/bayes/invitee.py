"""Calibrated-Yule node-time priors with calibration combinations
(≙ invitee.c: TIMES_Calib_Cond_Prob invitee.c:718, and
times.c:1526 TIMES_Lk_Yule_Order_Root_Cond — the Guindon 2018
"doubly intractable" calibrated-prior machinery).

Port of phyml_tpu/bayes/invitee.py on float64 tensors.

Model: conditional on the root age, each non-root internal node age
is an independent truncated exponential with rate `birth`, truncated
to the node's feasible window [lo, hi]:

    log p(h) = log b - b h - log(e^{-b lo} - e^{-b hi}),
    lo = max(t_floor, calibration lower),       (times.c:614)
    hi = min(calibration upper, root age),

where t_floor is the age of the node's oldest descendant tip
(times.c:345 TIMES_Update_Node_Ordering / t_floor fill).  When a
calibration can attach to one of SEVERAL clades (with prior
probabilities), the prior is the mixture over all calibration
COMBINATIONS (one clade choice per calibration):

    p(h) = sum_i  p_i  *  YuleOrderRootCond(h | bounds_i)

(TIMES_Calib_Cond_Prob invitee.c:718: `times_partial_proba[i] *
exp(Yule_val[i])` summed over Number_Of_Comb combinations).

The combinations are enumerated once on the host into per-node bound
arrays; the density is a logsumexp over the combination axis of a
vectorized truncated-exponential sum.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class CladeChoice:
    """One candidate clade for a calibration: taxa + prior weight
    (≙ the per-clade probability of t_cal, utilities.h:2197)."""
    taxa: tuple
    proba: float = 1.0


@dataclass(frozen=True)
class MultiCalibration:
    """A calibration whose clade attachment is uncertain: applies to
    exactly one of `choices`, with the given prior weights
    (xml.c <calibration> with several clade ids)."""
    choices: tuple          # tuple[CladeChoice]
    lower: float = 0.0
    upper: float = float("inf")


def node_floors(tt) -> np.ndarray:
    """Age of the oldest descendant tip of every node (height units;
    ≙ t_floor, times.c:345-399).  For contemporaneous tips this is 0
    everywhere; under serial sampling it lifts each node's lower
    bound."""
    n = tt.n_otu
    floors = np.asarray(tt.heights, dtype=np.float64).copy()
    for i in range(n - 1):
        c0, c1 = (int(x) for x in tt.child[i])
        floors[n + i] = max(floors[c0], floors[c1])
    return floors


def propagate_bounds(tt, lo: np.ndarray, hi: np.ndarray):
    """Tighten raw per-node calibration bounds into tree-consistent
    windows (≙ TIMES_Set_All_Node_Priors times.c:219): a node's upper
    bound cannot exceed its parent's, a parent's lower bound cannot
    be below its children's.  Returns (lo, hi) copies; infeasible
    windows (lo > hi) are left for the density to reject."""
    n = tt.n_otu
    lo = lo.copy()
    hi = hi.copy()
    # top-down (root first): cap upper bounds by the parent's
    for i in range(n - 2, -1, -1):
        u = n + i
        for c in tt.child[i]:
            hi[int(c)] = min(hi[int(c)], hi[u])
    # bottom-up: raise lower bounds above the children's
    for i in range(n - 1):
        u = n + i
        c0, c1 = (int(x) for x in tt.child[i])
        lo[u] = max(lo[u], lo[c0], lo[c1])
    return lo, hi


def yule_order_root_cond(heights, n_otu: int, birth, lo, hi):
    """Vectorized TIMES_Lk_Yule_Order_Root_Cond (times.c:1526): joint
    density of the non-root internal node ages, each truncated
    exponential(birth) on [lo_j, min(hi_j, root age)]; NEG_INF when
    any age leaves its window.  heights/lo/hi are full [n_nodes]
    tensors (tips ignored)."""
    n_nodes = heights.shape[0]
    root = n_nodes - 1
    h = heights[n_otu:root]
    lo_j = lo[n_otu:root]
    hi_j = torch.minimum(hi[n_otu:root], heights[root])
    b = torch.clamp(torch.as_tensor(birth, dtype=heights.dtype), min=1e-10)
    inside = bool(torch.all((h >= lo_j - 1e-12) & (h <= hi_j + 1e-12)))
    # the root's own calibration window (lo/hi[root]) is enforced too:
    # it is not part of the root-conditioned order statistics above
    inside = inside and bool(heights[root] >= lo[root] - 1e-12) \
        and bool(heights[root] <= hi[root] + 1e-12)
    # log(e^{-b lo} - e^{-b hi}) = -b lo + log1p(-e^{-b (hi - lo)})
    span = torch.clamp(hi_j - lo_j, min=1e-300)
    log_norm = -b * lo_j + torch.log(-torch.expm1(-b * span))
    lp = torch.sum(torch.log(b) - b * h - log_norm)
    return lp if inside else torch.full_like(lp, NEG_INF)


class CalibratedYule:
    """Resolved calibrated-Yule prior on one topology: enumerates the
    calibration combinations once (host-side), then scores heights as
    the weighted mixture (≙ TIMES_Calib_Cond_Prob invitee.c:718).

    calibrations: list of MultiCalibration (single-choice calibrations
    are the common case and reduce the mixture to one term)."""

    def __init__(self, tt, calibrations):
        self.n_otu = tt.n_otu
        n_nodes = tt.n_nodes
        floors = node_floors(tt)

        def mrca_of(taxa):
            idx = [tt.names.index(t) if isinstance(t, str) else int(t)
                   for t in taxa]
            return tt.mrca(idx) if len(idx) > 1 else idx[0]

        combos_lo, combos_hi, combo_logp = [], [], []
        if calibrations:
            pools = [range(len(c.choices)) for c in calibrations]
            for combo in itertools.product(*pools):
                lo = floors.copy()
                hi = np.full(n_nodes, np.inf)
                logp = 0.0
                for cal, k in zip(calibrations, combo):
                    ch = cal.choices[k]
                    node = mrca_of(ch.taxa)
                    lo[node] = max(lo[node], cal.lower)
                    hi[node] = min(hi[node], cal.upper)
                    logp += np.log(max(ch.proba, 1e-300))
                lo, hi = propagate_bounds(tt, lo, hi)
                combos_lo.append(lo)
                combos_hi.append(hi)
                combo_logp.append(logp)
        else:
            combos_lo.append(floors.copy())
            combos_hi.append(np.full(n_nodes, np.inf))
            combo_logp.append(0.0)
        # normalize the combination weights (the reference's
        # times_partial_proba, TIMES_Calib_Partial_Proba invitee.c:1773)
        w = torch.as_tensor(np.asarray(combo_logp), dtype=torch.float64)
        self.log_w = w - torch.logsumexp(w, dim=0)
        self.lo = torch.as_tensor(np.stack(combos_lo))    # [M, n_nodes]
        self.hi = torch.as_tensor(np.stack(combos_hi))

    @property
    def n_combos(self) -> int:
        return int(self.lo.shape[0])

    def log_prior(self, heights, birth):
        """log sum_i w_i YuleOrderRootCond(h | bounds_i)."""
        vals = torch.stack([
            yule_order_root_cond(heights, self.n_otu, birth,
                                 self.lo[i], self.hi[i])
            for i in range(self.n_combos)
        ])
        return torch.logsumexp(vals + self.log_w, dim=0)
