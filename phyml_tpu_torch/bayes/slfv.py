"""Spatial Lambda-Fleming-Viot model (≙ slfv.c + the SLFV branches of
phyrex.c/times.c).

Port of phyml_tpu/bayes/slfv.py.  The SLFV ("Etheridge-Barton") model
drives PhyREX's joint inference of genealogy and geography through a
sequence of REPRODUCTION/EXTINCTION EVENT DISKS: at rate `lbda`, an
event appears at a uniform center in the habitat; every lineage at
distance d from the center is hit with probability
mu * exp(-d^2 / (2 rad^2)); hit lineages coalesce into a parent whose
location is drawn from a truncated normal around the center
(SLFV_Lk_Gaussian_Core slfv.c:711).  The event times are a Poisson
process: n_evt * log(lbda) - lbda * total_dt (TIMES_Lk_SLFV
times.c:2751).

The augmented state is a fixed-shape struct of arrays — lineage nodes
(ldsk) with coordinates and parent pointers, disks with times, centers
and the hit id — in place of the reference's doubly-linked disk list
(t_dsk / t_ldsk, utilities.h:2374-2481), and the density is one masked
[K, L] computation.  `slfv_loglik` is its float64 torch form
(differentiable in coordinates, heights, centers and the parameters);
the joint sampler runs on the host in numpy, as phyml_tpu's does, with
every draw from one numpy Generator in phyml_tpu's order, so from one
seed both packages walk the same chain.  Its sequence term
(`make_seq_loglik_fn`) is one pass of the engine's slot kernel per
genealogy- or clock-changing move on the card (K1, or K4 at 20 states)
and one float read back.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

NEG_INF = -1e30
LOG2PI = float(np.log(2.0 * np.pi))


@dataclass(frozen=True)
class SLFVParams:
    """Habitat is the rectangle [lim_lo, lim_up]^D (≙ mmod->lim_do/
    lim_up); defaults match PHYREX_Set_Default (phyrex.c:856:
    lbda 0.1; mu/rad data-scale).

    dist_type: "euclidean" or "greatcircle" (the reference's
    HAVERSINE, phyrex.c:340-346) — with greatcircle, coordinates are
    (lat, lon) in degrees and the hit-kernel distance is the
    great-circle distance in km (rad then has km units)."""
    lbda: float = 0.1      # event rate per unit time
    mu: float = 0.5        # hit probability at the center
    rad: float = 1.0       # dispersal radius (sd of the hit kernel)
    lim_lo: tuple = (0.0, 0.0)
    lim_up: tuple = (10.0, 10.0)
    dist_type: str = "euclidean"


_EARTH_R_KM = 6371.0


def _sq_dist(x, c, params, xp):
    """Squared hit-kernel distance between points x [..., D] and
    centers c [..., D] under params.dist_type; xp is np or torch."""
    if params.dist_type == "greatcircle":
        rad = np.radians if xp is np else torch.deg2rad
        lat1 = rad(x[..., 0])
        lat2 = rad(c[..., 0])
        dlat = lat2 - lat1
        dlon = rad(c[..., 1] - x[..., 1])
        a = xp.sin(dlat / 2) ** 2 \
            + xp.cos(lat1) * xp.cos(lat2) * xp.sin(dlon / 2) ** 2
        d = 2.0 * _EARTH_R_KM * xp.arcsin(
            xp.sqrt(xp.clip(a, 0.0, 1.0)))
        return d * d
    return ((x - c) ** 2).sum(-1)


@dataclass
class SLFVState:
    """Augmented genealogy: struct-of-arrays event-disk history.

    Lineage nodes ("ldsk"): tips are 0..n_otu-1 at height 0; each
    coalescence (disk hit) creates one new node.  Heights increase
    into the past (the reference uses negative times; only gaps
    enter the density).
      coord   [L, D]  node location
      h_node  [L]     height of the disk that created the node
                      (0 for tips)
      parent  [L]     id of the node's ancestor ldsk (-1 for the root)
    Disks (every event, hit or not):
      h_disk  [K]     height (> 0, increasing into the past)
      centr   [K, D]  event center
      hit     [K]     ldsk id created at this disk, -1 if no lineage
                      was hit
    """
    n_otu: int
    coord: np.ndarray
    h_node: np.ndarray
    parent: np.ndarray
    h_disk: np.ndarray
    centr: np.ndarray
    hit: np.ndarray

    @property
    def n_ldsk(self) -> int:
        return self.coord.shape[0]

    @property
    def n_disks(self) -> int:
        return self.h_disk.shape[0]


def slfv_loglik(state: SLFVState, params: SLFVParams):
    """Joint log-density of the augmented state: Gaussian-SLFV disk
    terms (SLFV_Lk_Gaussian slfv.c:779) + the Poisson event-time term
    (TIMES_Lk_SLFV times.c:2751), a float64 0-d tensor.  The state's
    float fields may be tensors (differentiable in coords, heights,
    centers) and so may (lbda, mu, rad); parent and hit are host
    integer arrays."""
    f64 = torch.float64
    coord = torch.as_tensor(state.coord, dtype=f64)
    h_node = torch.as_tensor(state.h_node, dtype=f64)
    parent = np.asarray(state.parent)
    h_disk = torch.as_tensor(state.h_disk, dtype=f64)
    centr = torch.as_tensor(state.centr, dtype=f64)
    hit = np.asarray(state.hit)

    lbda = torch.as_tensor(params.lbda, dtype=f64)
    mu = torch.as_tensor(params.mu, dtype=f64)
    rad = torch.as_tensor(params.rad, dtype=f64)
    lo = torch.as_tensor(params.lim_lo, dtype=f64)
    up = torch.as_tensor(params.lim_up, dtype=f64)

    L = state.n_ldsk

    # lineage segment l spans (h_node[l], h_parent_event[l]]
    par_t = torch.as_tensor(parent)
    h_end = torch.where(par_t >= 0, h_node[torch.clamp(par_t, 0, L - 1)],
                        torch.full_like(h_node, float("inf")))

    # habitat check (PHYREX_Is_In_Ldscape): any lineage outside -> reject
    inside = torch.all((coord >= lo) & (coord <= up))

    # [K, L] masks: lineage active at the disk / hit by the disk
    active = (h_node[None, :] < h_disk[:, None]) \
        & (h_disk[:, None] <= h_end[None, :])
    # lineage l is hit at disk k iff its parent was created at disk k
    parent_safe = np.clip(parent, 0, L - 1)
    hit_mask_np = np.zeros((state.n_disks, L), dtype=bool)
    ok = parent >= 0
    disk_of_node = np.full(L, -1, dtype=np.int64)
    for k, h in enumerate(hit):
        if h >= 0:
            disk_of_node[h] = k
    rows = disk_of_node[parent_safe]
    cols = np.arange(L)
    sel = ok & (rows >= 0)
    hit_mask_np[rows[sel], cols[sel]] = True
    hit_mask = torch.as_tensor(hit_mask_np)

    # log prob of a hit: log(mu) - d(x, c)^2 / (2 rad^2)
    d2 = _sq_dist(coord[None, :, :], centr[:, None, :], params, torch)
    log_p_hit = torch.log(mu) - d2 / (2.0 * rad * rad)     # [K, L]
    log_p_hit = torch.clamp(log_p_hit, max=-1e-10)
    log_p_miss = torch.log(-torch.expm1(log_p_hit))
    per = torch.where(hit_mask, log_p_hit, log_p_miss)
    lnl = torch.sum(torch.where(active, per, torch.zeros_like(per)))

    # parent-location density: truncated normal around the center
    # per dimension (Log_Dnorm_Trunc in SLFV_Lk_Gaussian_Core)
    has_hit = hit >= 0
    if has_hit.any():
        kids = hit[has_hit]
        x = coord[torch.as_tensor(kids)]                      # [H, D]
        c = centr[torch.as_tensor(np.nonzero(has_hit)[0])]    # [H, D]
        z = (x - c) / rad
        log_pdf = -0.5 * (z * z + LOG2PI) - torch.log(rad)
        a = torch.special.ndtr((up[None] - c) / rad)
        b = torch.special.ndtr((lo[None] - c) / rad)
        lnl = lnl + torch.sum(log_pdf
                              - torch.log(torch.clamp(a - b, min=1e-300)))

    # disk-center density: uniform over the habitat, every disk
    lnl = lnl + state.n_disks * torch.sum(-torch.log(up - lo))

    # event-time Poisson term over the sampled span young(0) -> MRCA
    # (disks older than the root are integrated out of the model;
    # matches _loglik_np so fixed- and joint-sampling paths agree)
    dt_total = torch.max(h_node) if state.n_ldsk else 0.0
    lnl = lnl + state.n_disks * torch.log(lbda) - lbda * dt_total

    return torch.where(inside, lnl, torch.full_like(lnl, NEG_INF))


# ----------------------------------------------------------------------
# backward simulator (≙ SLFV_Simulate_Backward_Core slfv.c:1422)
# ----------------------------------------------------------------------
def simulate_slfv(n_otu: int, params: SLFVParams,
                  rng: np.random.Generator, tip_coord=None,
                  max_disks: int = 200_000) -> SLFVState:
    """Simulate the event-disk history backward from `n_otu` sampled
    lineages until their common ancestor; returns the augmented state
    (genealogy + all disks, hit or empty)."""
    D = len(params.lim_lo)
    lo = np.asarray(params.lim_lo, dtype=np.float64)
    up = np.asarray(params.lim_up, dtype=np.float64)
    if tip_coord is None:
        tip_coord = lo + (up - lo) * rng.random((n_otu, D))
    tip_coord = np.asarray(tip_coord, dtype=np.float64)

    coord = [tip_coord[i] for i in range(n_otu)]
    h_node = [0.0] * n_otu
    parent = [-1] * n_otu
    live = list(range(n_otu))

    h_disk, centr, hit = [], [], []
    h = 0.0
    while len(live) > 1:
        if len(h_disk) >= max_disks:
            raise RuntimeError("SLFV simulation exceeded max_disks; "
                               "increase mu/rad or lbda")
        h += rng.exponential(1.0 / params.lbda)
        c = lo + (up - lo) * rng.random(D)
        x = np.asarray([coord[l] for l in live])
        p_hit = params.mu * np.exp(
            -_sq_dist(x, c[None], params, np)
            / (2.0 * params.rad ** 2))
        hits = np.nonzero(rng.random(len(live)) < p_hit)[0]
        h_disk.append(h)
        centr.append(c)
        if len(hits) == 0:
            hit.append(-1)
            continue
        # all hit lineages coalesce into one parent near the center
        while True:
            pc = c + params.rad * rng.standard_normal(D)
            if np.all((pc >= lo) & (pc <= up)):
                break
        new = len(coord)
        coord.append(pc)
        h_node.append(h)
        parent.append(-1)
        for i in hits:
            parent[live[i]] = new
        live = [l for j, l in enumerate(live) if j not in set(hits)]
        live.append(new)
        hit.append(new)

    return SLFVState(
        n_otu=n_otu,
        coord=np.asarray(coord),
        h_node=np.asarray(h_node),
        parent=np.asarray(parent, dtype=np.int64),
        h_disk=np.asarray(h_disk),
        centr=np.asarray(centr),
        hit=np.asarray(hit, dtype=np.int64),
    )


def state_to_timetree(state: SLFVState, return_node_map: bool = False):
    """Collapse the ldsk chain to the coalescent TimeTree (multiple
    mergers are resolved left-to-right into same-height cherries,
    matching the reference's binary-tree conversion
    PHYREX_Ldsk_To_Tree phyrex.c:2530).  Handles MULTI-MERGERS of any
    degree — a k-way hit becomes k-1 binary nodes at the merger's
    height sharing its ldsk id in node_of — so sequence coupling
    works on any augmented state.

    return_node_map=True also returns node_of [2n-1] int: the ldsk id
    each tree node collapses from (cherries of a multi-merger share
    the merger's ldsk) — used to read sampled ancestral LOCATIONS off
    the augmented state."""
    from phyml_tpu_torch.bayes.chrono import TimeTree
    n = state.n_otu
    kids: dict[int, list[int]] = {}
    for l, p in enumerate(state.parent):
        if p >= 0:
            kids.setdefault(int(p), []).append(l)
    # drop pass-through nodes (single-child); map to binary merges
    merges = []

    def resolve(u: int) -> int:
        ks = kids.get(u, [])
        if not ks:
            return u
        rs = [resolve(k) for k in ks]
        if len(rs) == 1:
            return rs[0]
        node = rs[0]
        for other in rs[1:]:
            pid = -(len(merges) + 1)     # placeholder id, by creation
            merges.append((float(state.h_node[u]), node, other, pid,
                           u))
            node = pid
        return node

    root = int(np.argmax(np.asarray(state.parent) < 0))
    resolve(root)
    # sort by height; each merge carries its OWN placeholder id, so
    # references stay valid after reordering (children have smaller
    # heights, hence resolve earlier in the sorted order)
    merges.sort(key=lambda m: m[0])
    n_nodes = 2 * n - 1
    heights = np.zeros(n_nodes)
    child = np.zeros((n - 1, 2), dtype=np.int64)
    node_of = np.arange(n_nodes, dtype=np.int64)
    remap: dict[int, int] = {}
    nxt = n
    for k, (h, a, b, pid, u) in enumerate(merges):
        ia = a if a >= 0 else remap[a]
        ib = b if b >= 0 else remap[b]
        child[k] = (ia, ib)
        heights[nxt] = h
        node_of[nxt] = u
        remap[pid] = nxt
        nxt += 1
    names = [f"t{i}" for i in range(n)]
    tt = TimeTree(n_otu=n, child=child, heights=heights, names=names)
    if return_node_map:
        return tt, node_of
    return tt


# ----------------------------------------------------------------------
# parameter MCMC (≙ MCMC_PHYREX_Lbda / _Mu / _Radius moves in mcmc.c)
# ----------------------------------------------------------------------
def slfv_param_mcmc(state: SLFVState, params: SLFVParams,
                    n_iter: int = 2000, seed: int = 0,
                    step: float = 0.4):
    """Metropolis over (lbda, mu, rad) given the augmented history,
    log-multiplier proposals, Exp(1) priors on lbda/rad and
    Uniform(0,1) on mu.  Returns (params, trace [n_iter, 4])."""
    rng = np.random.default_rng(seed)

    def post(p: SLFVParams) -> float:
        if p.mu <= 0 or p.mu > 1 or p.lbda <= 0 or p.rad <= 0:
            return -np.inf
        lnl = float(slfv_loglik(state, p))
        return lnl - p.lbda - p.rad

    cur = params
    lp = post(cur)
    trace = np.zeros((n_iter, 4))
    for it in range(n_iter):
        which = it % 3
        m = float(np.exp(step * (rng.random() - 0.5)))
        if which == 0:
            prop = replace(cur, lbda=cur.lbda * m)
        elif which == 1:
            prop = replace(cur, mu=cur.mu * m)
        else:
            prop = replace(cur, rad=cur.rad * m)
        lp_new = post(prop)
        if np.log(rng.random()) < lp_new - lp + np.log(m):
            cur, lp = prop, lp_new
        trace[it] = (lp, cur.lbda, cur.mu, cur.rad)
    return cur, trace


# ----------------------------------------------------------------------
# Joint trans-dimensional MCMC over the augmented SLFV state
# (≙ PHYREX_MCMC phyrex.c:1234 with the MCMC_PHYREX_* move family:
#  indel_disk, indel_hit, move_disk_ud, ldsk_given_disk,
#  disk_given_ldsk, wide_exchange, scale_times, lbda/mu/rad)
# ----------------------------------------------------------------------

def _loglik_np(state: SLFVState, params: SLFVParams) -> float:
    """Pure-numpy augmented log-density, identical in value to
    slfv_loglik: the host-side sampler evaluates thousands of small
    proposals per second, where eager torch dispatch would dominate.
    The Poisson span is the ROOT height (disks older than the MRCA
    are integrated out of the model, matching TIMES_Lk_SLFV
    times.c:2751 which spans sampled time only)."""
    coord = np.asarray(state.coord)
    h_node = np.asarray(state.h_node)
    parent = np.asarray(state.parent)
    h_disk = np.asarray(state.h_disk)
    centr = np.asarray(state.centr)
    hit = np.asarray(state.hit)
    lo = np.asarray(params.lim_lo, dtype=np.float64)
    up = np.asarray(params.lim_up, dtype=np.float64)
    lbda, mu, rad = params.lbda, params.mu, params.rad
    L, K = coord.shape[0], h_disk.shape[0]

    if np.any(coord < lo) or np.any(coord > up):
        return float(NEG_INF)

    parent_safe = np.clip(parent, 0, L - 1)
    h_end = np.where(parent >= 0, h_node[parent_safe], np.inf)
    active = (h_node[None, :] < h_disk[:, None]) \
        & (h_disk[:, None] <= h_end[None, :])

    disk_of_node = np.full(L, -1, dtype=np.int64)
    ok_h = hit >= 0
    disk_of_node[hit[ok_h]] = np.nonzero(ok_h)[0]
    rows = disk_of_node[parent_safe]
    sel = (parent >= 0) & (rows >= 0)
    hit_mask = np.zeros((K, L), dtype=bool)
    hit_mask[rows[sel], np.nonzero(sel)[0]] = True

    d2 = _sq_dist(coord[None, :, :], centr[:, None, :], params, np)
    log_p_hit = np.minimum(np.log(mu) - d2 / (2.0 * rad * rad),
                           -1e-10)
    log_p_miss = np.log(-np.expm1(log_p_hit))
    lnl = float(np.sum(np.where(hit_mask, log_p_hit,
                                log_p_miss)[active]))

    if ok_h.any():
        from scipy.stats import norm as _norm  # CPU-host path
        kids = hit[ok_h]
        x = coord[kids]
        c = centr[np.nonzero(ok_h)[0]]
        z = (x - c) / rad
        log_pdf = -0.5 * (z * z + LOG2PI) - np.log(rad)
        a = _norm.cdf((up[None] - c) / rad)
        b = _norm.cdf((lo[None] - c) / rad)
        lnl += float(np.sum(log_pdf
                            - np.log(np.maximum(a - b, 1e-300))))

    lnl += K * float(np.sum(-np.log(up - lo)))
    span = float(h_node.max()) if L else 0.0
    lnl += K * np.log(lbda) - lbda * span
    return lnl


class SLFVDensity:
    """Cached decomposition of the augmented SLFV density for O(K+L)
    move deltas (≙ PHYREX_Lk_Range phyrex.c:1199: the reference
    scores moves against only the disk range they touch; here the
    cache holds the per-(disk, lineage) log-term matrix W, the
    per-disk hit-location terms, and the constants, so a move
    recomputes only its touched rows/columns instead of the full
    O(K*L) density)."""

    def __init__(self, state: SLFVState, params: SLFVParams):
        self.params = params
        self.rebuild(state)

    # -- full (re)build (vectorized like _loglik_np) -------------------
    def rebuild(self, state: SLFVState):
        p = self.params
        self.state = state
        coord = state.coord
        self.lo = np.asarray(p.lim_lo, dtype=np.float64)
        self.up = np.asarray(p.lim_up, dtype=np.float64)
        L, K = coord.shape[0], state.h_disk.shape[0]
        self.L, self.K = L, K
        parent_safe = np.clip(state.parent, 0, L - 1)
        self.h_end = np.where(state.parent >= 0,
                              state.h_node[parent_safe], np.inf)
        self.disk_of_node = np.full(L, -1, dtype=np.int64)
        okh = state.hit >= 0
        self.disk_of_node[state.hit[okh]] = np.nonzero(okh)[0]
        # cached geometry: mu/rad proposals re-derive W from d2
        # without touching the masks
        self.d2 = _sq_dist(coord[None, :, :], state.centr[:, None, :],
                           p, np)
        self.act = (state.h_node[None, :] < state.h_disk[:, None]) \
            & (state.h_disk[:, None] <= self.h_end[None, :])
        rows = self.disk_of_node[parent_safe]
        sel = (state.parent >= 0) & (rows >= 0)
        self.hm = np.zeros((K, L), dtype=bool)
        self.hm[rows[sel], np.nonzero(sel)[0]] = True
        self.W = self._w_of(p.mu, p.rad, self.d2, self.act, self.hm)
        self.hitloc = np.zeros(K)
        if okh.any():
            ks = np.nonzero(okh)[0]
            self.hitloc[ks] = self._hitloc_of(
                coord[state.hit[ks]], state.centr[ks], p.rad)
        self.span = float(state.h_node.max()) if L else 0.0
        self.oob = bool(np.any(coord < self.lo)
                        or np.any(coord > self.up))
        # cached scalar sums: total() must not re-reduce the O(K*L)
        # matrix per proposal
        self.wsum = float(self.W.sum())
        self.hlsum = float(self.hitloc.sum())

    @staticmethod
    def _w_of(mu, rad, d2, act, hm):
        lph = np.minimum(np.log(mu) - d2 / (2.0 * rad * rad), -1e-10)
        lpm = np.log(-np.expm1(lph))
        return np.where(act, np.where(hm, lph, lpm), 0.0)

    def _hitloc_of(self, x, c, rad):
        """Vectorized truncated-normal terms, one value per hit disk.
        x, c: [H, D]."""
        from scipy.stats import norm as _norm
        z = (x - c) / rad
        log_pdf = -0.5 * (z * z + LOG2PI) - np.log(rad)
        a = _norm.cdf((self.up[None] - c) / rad)
        b = _norm.cdf((self.lo[None] - c) / rad)
        return np.sum(log_pdf - np.log(np.maximum(a - b, 1e-300)),
                      axis=1)

    def propose_params(self, state, p2):
        """Density of `state` under new (mu, rad, lbda).  The
        geometry (distances, activity and hit masks) is re-derived
        from `state` directly: the cached d2/act/hm are refreshed
        only by rebuild(), so they can be stale after rowcol/resize
        commits (using them here would bias the (lbda, mu, rad)
        posterior)."""
        if np.any(state.coord < self.lo) \
                or np.any(state.coord > self.up):
            return float(NEG_INF)
        L = state.coord.shape[0]
        K = state.h_disk.shape[0]
        parent_safe = np.clip(state.parent, 0, L - 1)
        h_end = np.where(state.parent >= 0,
                         state.h_node[parent_safe], np.inf)
        act = (state.h_node[None, :] < state.h_disk[:, None]) \
            & (state.h_disk[:, None] <= h_end[None, :])
        don = np.full(L, -1, dtype=np.int64)
        okh = state.hit >= 0
        don[state.hit[okh]] = np.nonzero(okh)[0]
        rows = don[parent_safe]
        sel = (state.parent >= 0) & (rows >= 0)
        hm = np.zeros((K, L), dtype=bool)
        hm[rows[sel], np.nonzero(sel)[0]] = True
        d2 = _sq_dist(state.coord[None, :, :],
                      state.centr[:, None, :], self.params, np)
        w = float(self._w_of(p2.mu, p2.rad, d2, act, hm).sum())
        hl = 0.0
        if okh.any():
            ks = np.nonzero(okh)[0]
            hl = float(self._hitloc_of(
                state.coord[state.hit[ks]], state.centr[ks],
                p2.rad).sum())
        span = float(state.h_node.max())
        return (w + hl
                + K * float(np.sum(-np.log(self.up - self.lo)))
                + K * np.log(p2.lbda) - p2.lbda * span)

    def _row_terms(self, state, k):
        """(W row [L], hitloc scalar) of disk k against all lineages
        of `state` (which must share disk k's data)."""
        p = self.params
        coord, rad, mu = state.coord, p.rad, p.mu
        c = state.centr[k]
        act = (state.h_node < state.h_disk[k]) \
            & (state.h_disk[k] <= self.h_end)
        d2 = _sq_dist(coord, c[None], p, np)
        lph = np.minimum(np.log(mu) - d2 / (2.0 * rad * rad), -1e-10)
        lpm = np.log(-np.expm1(lph))
        hk = int(state.hit[k])
        hmask = (state.parent == hk) if hk >= 0 \
            else np.zeros(self.L, dtype=bool)
        row = np.where(act, np.where(hmask, lph, lpm), 0.0)
        hl = 0.0
        if hk >= 0:
            from scipy.stats import norm as _norm
            x = coord[hk]
            z = (x - c) / rad
            log_pdf = -0.5 * (z * z + LOG2PI) - np.log(rad)
            a = _norm.cdf((self.up - c) / rad)
            b = _norm.cdf((self.lo - c) / rad)
            hl = float(np.sum(log_pdf
                              - np.log(np.maximum(a - b, 1e-300))))
        return row, hl

    def _col_terms(self, state, ls):
        """W column block [K, |ls|] for lineages ls of `state`."""
        p = self.params
        rad, mu = p.rad, p.mu
        x = state.coord[ls]                          # [m, D]
        parent_safe = np.clip(state.parent[ls], 0, state.coord.shape[0] - 1)
        h_end = np.where(state.parent[ls] >= 0,
                         state.h_node[parent_safe], np.inf)
        act = (state.h_node[ls][None, :] < state.h_disk[:, None]) \
            & (state.h_disk[:, None] <= h_end[None, :])
        d2 = _sq_dist(x[None, :, :], state.centr[:, None, :], p, np)
        lph = np.minimum(np.log(mu) - d2 / (2.0 * rad * rad), -1e-10)
        lpm = np.log(-np.expm1(lph))
        dk = np.full(len(ls), -1, dtype=np.int64)
        for j, l in enumerate(ls):
            pl = int(state.parent[l])
            if pl >= 0:
                row = np.nonzero(state.hit == pl)[0]
                if row.size:
                    dk[j] = row[0]
        hmask = np.zeros((self.K, len(ls)), dtype=bool)
        for j in range(len(ls)):
            if dk[j] >= 0:
                hmask[dk[j], j] = True
        return np.where(act, np.where(hmask, lph, lpm), 0.0)

    def total(self):
        if self.oob:
            return float(NEG_INF)
        p = self.params
        return (self.wsum + self.hlsum
                + self.K * float(np.sum(-np.log(self.up - self.lo)))
                + self.K * np.log(p.lbda) - p.lbda * self.span)

    # -- deltas --------------------------------------------------------
    def propose_rowcol(self, s2, rows, cols):
        """Density of s2, which differs from the cached state only in
        disk ROWS and lineage COLUMNS (no disk count change, span
        unchanged, same params).  Returns (lnl, payload)."""
        if np.any(s2.coord < self.lo) or np.any(s2.coord > self.up):
            return float(NEG_INF), None
        rows = np.asarray(sorted(set(int(r) for r in rows)),
                          dtype=np.int64)
        cols = np.asarray(sorted(set(int(c) for c in cols)),
                          dtype=np.int64)
        new_rows = []
        new_hl = []
        # columns are evaluated against the PROPOSED state but must
        # not double-count cells in the recomputed rows
        old = 0.0
        new = 0.0
        colW = None
        if cols.size:
            colW = self._cols_of(s2, cols)
            old += float(self.W[:, cols].sum())
            new += float(colW.sum())
        for k in rows:
            r, hl = self._row_terms_p(s2, int(k))
            new_rows.append(r)
            new_hl.append(hl)
            old += float(self.W[k].sum()) + float(self.hitloc[k])
            new += float(r.sum()) + hl
            if cols.size:
                old -= float(self.W[k, cols].sum())
                new -= float(r[cols].sum())
        # span can move with node-height columns
        span_new = float(s2.h_node.max())
        lnl = (self.total() - old + new
               - self.params.lbda * (span_new - self.span))
        payload = (s2, rows, cols, new_rows, new_hl, colW,
                   new - old)
        return lnl, payload

    def _row_terms_p(self, s2, k):
        sub = SLFVDensity.__new__(SLFVDensity)
        sub.params = self.params
        sub.lo, sub.up = self.lo, self.up
        sub.L = s2.coord.shape[0]
        parent_safe = np.clip(s2.parent, 0, sub.L - 1)
        sub.h_end = np.where(s2.parent >= 0,
                             s2.h_node[parent_safe], np.inf)
        return sub._row_terms(s2, k)

    def _cols_of(self, s2, cols):
        sub = SLFVDensity.__new__(SLFVDensity)
        sub.params = self.params
        sub.lo, sub.up = self.lo, self.up
        sub.K = s2.h_disk.shape[0]
        return sub._col_terms(s2, cols)

    def commit(self, payload):
        s2, rows, cols, new_rows, new_hl, colW, delta = payload
        # delta covers W + hitloc jointly; split: hitloc part
        hl_delta = sum(new_hl) - float(self.hitloc[rows].sum()) \
            if len(rows) else 0.0
        self.wsum += delta - hl_delta
        self.hlsum += hl_delta
        if cols.size:
            self.W[:, cols] = colW
        for j, k in enumerate(rows):
            self.W[k] = new_rows[j]
            self.hitloc[k] = new_hl[j]
            if cols.size:
                self.W[k, cols] = new_rows[j][cols]
        # refresh derived tables that row/col moves may touch
        self.state = s2
        L = s2.coord.shape[0]
        parent_safe = np.clip(s2.parent, 0, L - 1)
        self.h_end = np.where(s2.parent >= 0,
                              s2.h_node[parent_safe], np.inf)
        self.disk_of_node = np.full(L, -1, dtype=np.int64)
        okh = s2.hit >= 0
        self.disk_of_node[s2.hit[okh]] = np.nonzero(okh)[0]
        self.span = float(s2.h_node.max())

    def propose_insert_hit(self, s2, l):
        """Density of s2 = cached state with a pass-through node
        appended (node m = L, disk k = K, hit m, parent[l] = m)."""
        if np.any(s2.coord < self.lo) or np.any(s2.coord > self.up):
            return float(NEG_INF)
        m = s2.n_ldsk - 1
        colW = self._cols_of(s2, [l, m])          # [K+1, 2]
        rowW, hl = self._row_terms_p(s2, s2.n_disks - 1)
        new = float(colW.sum()) + float(rowW.sum()) \
            - float(colW[-1, 0]) - float(colW[-1, 1])
        old = float(self.W[:, l].sum())
        p = self.params
        return (self.total() + new - old + hl
                + float(np.sum(-np.log(self.up - self.lo)))
                + np.log(p.lbda))

    def propose_delete_hit(self, s2, m, dk, child):
        """Density of s2 = cached state with pass-through node m (and
        its disk dk) removed; `child` is m's single child in OLD
        indexing."""
        child2 = child if child < m else child - 1
        colW_new = self._cols_of(s2, [child2])     # [K-1, 1]
        old = (float(self.W[dk].sum()) + float(self.W[:, m].sum())
               + float(self.W[:, child].sum())
               - float(self.W[dk, m]) - float(self.W[dk, child])
               + float(self.hitloc[dk]))
        new = float(colW_new.sum())
        p = self.params
        span_new = float(s2.h_node.max())
        return (self.total() + new - old
                - float(np.sum(-np.log(self.up - self.lo)))
                - np.log(p.lbda)
                - p.lbda * (span_new - self.span))

    def propose_insert_empty(self, s2):
        """s2 = cached state + ONE empty disk appended (last row)."""
        k = s2.h_disk.shape[0] - 1
        row, _ = self._row_terms_p(s2, k)
        p = self.params
        lnl = (self.total() + float(row.sum())
               + float(np.sum(-np.log(self.up - self.lo)))
               + np.log(p.lbda))
        return lnl, ("ins", s2, row)

    def propose_delete_empty(self, s2, k):
        p = self.params
        lnl = (self.total() - float(self.W[k].sum())
               - float(np.sum(-np.log(self.up - self.lo)))
               - np.log(p.lbda))
        return lnl, ("del", s2, k)

    def commit_resize(self, payload):
        tag = payload[0]
        if tag == "ins":
            _, s2, row = payload
            self.wsum += float(row.sum())
            self.W = np.vstack([self.W, row[None]])
            self.hitloc = np.append(self.hitloc, 0.0)
        else:
            _, s2, k = payload
            self.wsum -= float(self.W[k].sum())
            self.hlsum -= float(self.hitloc[k])
            self.W = np.delete(self.W, k, axis=0)
            self.hitloc = np.delete(self.hitloc, k)
        self.K = self.W.shape[0]
        self.state = s2


class SLFVJointSampler:
    """Metropolis-Hastings over the FULL augmented state (disks, disk
    centers/times, ldsk locations, genealogy) jointly with the
    parameters (lbda, mu, rad); slfv_param_mcmc holds the augmented
    state fixed.

    Moves (reference counterparts in mcmc.c):
      param       log-multiplier on lbda / mu / rad
                  (MCMC_PHYREX_Lbda/_Mu/_Radius)
      centr       Gaussian jitter of one disk center
                  (MCMC_PHYREX_Disk_Multi)
      ldsk        Gaussian jitter of one internal ldsk location
                  (MCMC_PHYREX_Ldsk_Multi)
      etime       uniform re-draw of one EMPTY disk's time
                  (MCMC_PHYREX_Move_Disk_Updown)
      ntime       move one internal node's height (with its disk)
                  within (oldest child, parent) (mcmc.c node times)
      indel_disk  reversible-jump insert/delete of an empty disk
                  (MCMC_PHYREX_Indel_Disk)
      indel_hit   reversible-jump insert/delete of a single-hit
                  pass-through ldsk (MCMC_PHYREX_Indel_Hit /
                  Add_Remove_Jump)
      exchange    swap the parents of two nodes, heights permitting
                  (MCMC_PHYREX_Wide_Exchange) — changes the genealogy
      scale       scale all times by m (MCMC_PHYREX_Scale_Times)
    """

    MOVES = ("param", "centr", "ldsk", "etime", "ntime",
             "indel_disk", "indel_hit", "exchange", "spr", "scale",
             "clock")

    def __init__(self, state: SLFVState, params: SLFVParams,
                 seed: int = 0, sample_params: bool = True,
                 sample_genealogy: bool = True, step: float = 0.4,
                 seq_fn=None, clock0: float = 1.0):
        """seq_fn (optional): callable (state, clock) -> sequence
        log-likelihood; when given, genealogy/time moves are accepted
        against the JOINT (spatial x sequence) posterior and a strict
        clock rate is sampled alongside — the full PhyREX coupling
        (phyrex.c:1234)."""
        self.state = SLFVState(
            n_otu=state.n_otu,
            coord=np.array(state.coord, dtype=np.float64),
            h_node=np.array(state.h_node, dtype=np.float64),
            parent=np.array(state.parent, dtype=np.int64),
            h_disk=np.array(state.h_disk, dtype=np.float64),
            centr=np.array(state.centr, dtype=np.float64),
            hit=np.array(state.hit, dtype=np.int64),
        )
        self.params = params
        self.rng = np.random.default_rng(seed)
        self.sample_params = sample_params
        self.sample_genealogy = sample_genealogy
        self.step = step
        self.seq_fn = seq_fn
        self.clock = float(clock0)
        self.seq_lnl = (float(seq_fn(self.state, self.clock))
                        if seq_fn else 0.0)
        self._dc = SLFVDensity(self.state, params)
        self.lp = self._dc.total() \
            + self._lprior(params) + self.seq_lnl
        self.tries = {m: 0 for m in self.MOVES}
        self.accepts = {m: 0 for m in self.MOVES}
        self._audit_ctr = 0
        self.audit_every = 512   # cheap invariant insurance

    # -- priors: Exp(1) on lbda/rad, U(0,1) on mu (phyrex.c defaults)
    @staticmethod
    def _lprior(p: SLFVParams) -> float:
        if p.mu <= 0 or p.mu > 1 or p.lbda <= 0 or p.rad <= 0:
            return float(NEG_INF)
        return -p.lbda - p.rad

    def _post(self, state, params) -> float:
        pr = self._lprior(params)
        if pr <= NEG_INF:
            return float(NEG_INF)
        return _loglik_np(state, params) + pr

    def _accept(self, name, state_new, params_new, log_hastings,
                affects_seq: bool = False, clock_new=None,
                hint=None):
        """affects_seq: the move changes the collapsed genealogy or
        its node times (pass-through inserts and spatial-only moves
        leave the sequence likelihood untouched).

        hint (optional): incremental-density descriptor —
        ("rowcol", rows, cols), ("ins_empty",) or ("del_empty", k) —
        valid only when params are unchanged; the density delta then
        costs O(K + L) instead of O(K*L) (≙ PHYREX_Lk_Range
        phyrex.c:1199)."""
        clock_new = self.clock if clock_new is None else clock_new
        payload = None
        resize = False
        rebuild = False
        if hint is not None and hint[0] == "lnl":
            # density precomputed by a cheap closed-form delta (scale,
            # lbda-only, indel_hit); the cache is rebuilt on accept
            lp_new = hint[1] + self._lprior(params_new)
            rebuild = True
        elif hint is not None and params_new is self.params:
            pr = self._lprior(params_new)
            if hint[0] == "rowcol":
                lnl_new, payload = self._dc.propose_rowcol(
                    state_new, hint[1], hint[2])
            elif hint[0] == "ins_empty":
                lnl_new, payload = self._dc.propose_insert_empty(
                    state_new)
                resize = True
            else:
                lnl_new, payload = self._dc.propose_delete_empty(
                    state_new, hint[1])
                resize = True
            lp_new = lnl_new + pr
            if payload is None:
                lp_new = float(NEG_INF)
        else:
            lp_new = self._post(state_new, params_new)
            rebuild = True
        seq_new = self.seq_lnl
        if self.seq_fn is not None and lp_new > NEG_INF \
                and (affects_seq or clock_new != self.clock):
            seq_new = float(self.seq_fn(state_new, clock_new))
        lp_new = lp_new + seq_new
        self.tries[name] += 1
        if np.log(self.rng.random()) < lp_new - self.lp + log_hastings:
            self.state, self.params, self.lp = \
                state_new, params_new, lp_new
            self.clock, self.seq_lnl = clock_new, seq_new
            self.accepts[name] += 1
            if payload is not None and not rebuild:
                if resize:
                    self._dc.commit_resize(payload)
                else:
                    self._dc.commit(payload)
            else:
                self._dc = SLFVDensity(self.state, self.params)
            self._audit_ctr += 1
            if self._audit_ctr % self.audit_every == 0:
                full = _loglik_np(self.state, self.params)
                inc = self._dc.total()
                if not (abs(full - inc) < 1e-6 * max(1.0, abs(full))):
                    # self-heal and surface the inconsistency
                    self._dc = SLFVDensity(self.state, self.params)
                    raise AssertionError(
                        f"SLFV incremental density drifted: "
                        f"{inc} vs {full}")
            return True
        return False

    def _copy(self) -> SLFVState:
        s = self.state
        return SLFVState(n_otu=s.n_otu, coord=s.coord.copy(),
                         h_node=s.h_node.copy(),
                         parent=s.parent.copy(),
                         h_disk=s.h_disk.copy(),
                         centr=s.centr.copy(), hit=s.hit.copy())

    # ------------------------------------------------------------------
    def _mv_param(self):
        which = int(self.rng.integers(3))
        m = float(np.exp(self.step * (self.rng.random() - 0.5)))
        p = self.params
        if which == 0:
            p2 = replace(p, lbda=p.lbda * m)
            if p2.lbda > 0:
                # W/hitloc do not depend on lbda: O(1) delta
                dc = self._dc
                lnl = (dc.total()
                       + dc.K * (np.log(p2.lbda) - np.log(p.lbda))
                       - (p2.lbda - p.lbda) * dc.span)
                return self._accept("param", self.state, p2,
                                    np.log(m), hint=("lnl", lnl))
        elif which == 1:
            p2 = replace(p, mu=p.mu * m)
        else:
            p2 = replace(p, rad=p.rad * m)
        if p2.mu <= 0 or p2.mu > 1 or p2.rad <= 0:
            self.tries["param"] += 1
            return False
        lnl = self._dc.propose_params(self.state, p2)
        return self._accept("param", self.state, p2, np.log(m),
                            hint=("lnl", lnl))

    def _mv_centr(self):
        s = self.state
        if s.n_disks == 0:
            return False
        k = int(self.rng.integers(s.n_disks))
        s2 = self._copy()
        s2.centr[k] = s2.centr[k] + self.params.rad * 0.5 \
            * self.rng.standard_normal(s2.centr.shape[1])
        # centers may leave the habitat in the reference too (the
        # density's center term is uniform over the habitat: reject)
        lo = np.asarray(self.params.lim_lo)
        up = np.asarray(self.params.lim_up)
        if np.any(s2.centr[k] < lo) or np.any(s2.centr[k] > up):
            self.tries["centr"] += 1
            return False
        return self._accept("centr", s2, self.params, 0.0,
                            hint=("rowcol", [k], []))

    def _mv_ldsk(self):
        s = self.state
        internal = np.nonzero(np.arange(s.n_ldsk) >= s.n_otu)[0]
        if internal.size == 0:
            return False
        l = int(self.rng.choice(internal))
        s2 = self._copy()
        s2.coord[l] = s2.coord[l] + self.params.rad * 0.5 \
            * self.rng.standard_normal(s2.coord.shape[1])
        rows = np.nonzero(s.hit == l)[0].tolist()
        return self._accept("ldsk", s2, self.params, 0.0,
                            hint=("rowcol", rows, [l]))

    def _mv_etime(self):
        s = self.state
        empty = np.nonzero(s.hit < 0)[0]
        if empty.size == 0:
            return False
        k = int(self.rng.choice(empty))
        span = float(s.h_node.max())
        s2 = self._copy()
        s2.h_disk[k] = span * self.rng.random()
        return self._accept("etime", s2, self.params, 0.0,
                            hint=("rowcol", [k], []))

    def _mv_ntime(self):
        """Move an internal (non-root) node's height together with
        its creating disk, uniform within (oldest child, parent)."""
        s = self.state
        cand = [m for m in range(s.n_otu, s.n_ldsk)
                if s.parent[m] >= 0]
        if not cand:
            return False
        m = int(self.rng.choice(cand))
        kids = np.nonzero(s.parent == m)[0]
        lo_t = float(s.h_node[kids].max()) if kids.size else 0.0
        hi_t = float(s.h_node[s.parent[m]])
        if hi_t <= lo_t:
            return False
        t = lo_t + (hi_t - lo_t) * self.rng.random()
        s2 = self._copy()
        s2.h_node[m] = t
        dk = np.nonzero(s2.hit == m)[0]
        s2.h_disk[dk] = t
        cols = [m] + kids.tolist()
        return self._accept("ntime", s2, self.params, 0.0,
                            affects_seq=True,
                            hint=("rowcol", dk.tolist(), cols))

    def _mv_indel_disk(self):
        """RJ insert/delete of an empty disk: u = (t, c) drawn
        directly, Jacobian 1; q_ins = 1/2 * 1/(span * |A|),
        q_del = 1/2 * 1/n_empty' (MCMC_PHYREX_Indel_Disk)."""
        s = self.state
        lo = np.asarray(self.params.lim_lo)
        up = np.asarray(self.params.lim_up)
        area = float(np.prod(up - lo))
        span = float(s.h_node.max())
        empty = np.nonzero(s.hit < 0)[0]
        if self.rng.random() < 0.5:
            # insert
            t = span * self.rng.random()
            c = lo + (up - lo) * self.rng.random(lo.shape[0])
            s2 = self._copy()
            s2.h_disk = np.append(s2.h_disk, t)
            s2.centr = np.vstack([s2.centr, c[None]])
            s2.hit = np.append(s2.hit, -1)
            log_h = -np.log(empty.size + 1) \
                - (-np.log(span * area))
            return self._accept("indel_disk", s2, self.params, log_h,
                                hint=("ins_empty",))
        if empty.size == 0:
            return False
        k = int(self.rng.choice(empty))
        s2 = self._copy()
        keep = np.arange(s2.n_disks) != k
        s2.h_disk = s2.h_disk[keep]
        s2.centr = s2.centr[keep]
        s2.hit = s2.hit[keep]
        log_h = (-np.log(span * area)) - (-np.log(empty.size))
        return self._accept("indel_disk", s2, self.params, log_h,
                            hint=("del_empty", k))

    def _single_hit_nodes(self, s):
        """Pass-through internal nodes: exactly one child."""
        counts = np.bincount(s.parent[s.parent >= 0],
                             minlength=s.n_ldsk)
        return [m for m in range(s.n_otu, s.n_ldsk)
                if counts[m] == 1]

    def _mv_indel_hit(self):
        """RJ insert/delete of a single-hit (pass-through) ldsk on a
        lineage segment: a location jump, the elementary event of the
        SLFV lineage trajectory (MCMC_PHYREX_Add_Remove_Jump).
        Insert: pick lineage l (parent >= 0), t ~ U(segment),
        c ~ N(coord[l], rad), y ~ N(c, rad); q densities explicit."""
        s = self.state
        rad = self.params.rad
        D = s.coord.shape[1]
        lo = np.asarray(self.params.lim_lo)
        up = np.asarray(self.params.lim_up)

        def lognorm(x, mean, sd):
            z = (np.asarray(x) - np.asarray(mean)) / sd
            return float(np.sum(-0.5 * (z * z + LOG2PI) - np.log(sd)))

        if self.rng.random() < 0.5:
            # insert above lineage l
            cands = np.nonzero(s.parent >= 0)[0]
            if cands.size == 0:
                return False
            l = int(self.rng.choice(cands))
            t_lo = float(s.h_node[l])
            t_hi = float(s.h_node[s.parent[l]])
            if t_hi <= t_lo:
                return False
            t = t_lo + (t_hi - t_lo) * self.rng.random()
            c = s.coord[l] + rad * self.rng.standard_normal(D)
            y = c + rad * self.rng.standard_normal(D)
            if np.any(c < lo) or np.any(c > up) \
                    or np.any(y < lo) or np.any(y > up):
                self.tries["indel_hit"] += 1
                return False
            s2 = self._copy()
            m = s2.n_ldsk
            s2.coord = np.vstack([s2.coord, y[None]])
            s2.h_node = np.append(s2.h_node, t)
            s2.parent = np.append(s2.parent, s2.parent[l])
            s2.parent[l] = m
            s2.h_disk = np.append(s2.h_disk, t)
            s2.centr = np.vstack([s2.centr, c[None]])
            s2.hit = np.append(s2.hit, m)
            n_single_new = len(self._single_hit_nodes(s2))
            log_q_fwd = (-np.log(cands.size) - np.log(t_hi - t_lo)
                         + lognorm(c, s.coord[l], rad)
                         + lognorm(y, c, rad))
            log_q_rev = -np.log(max(n_single_new, 1))
            lnl = self._dc.propose_insert_hit(s2, l)
            return self._accept("indel_hit", s2, self.params,
                                log_q_rev - log_q_fwd,
                                hint=("lnl", lnl))
        # delete a pass-through node
        singles = self._single_hit_nodes(s)
        if not singles:
            return False
        m = int(self.rng.choice(singles))
        child = int(np.nonzero(s.parent == m)[0][0])
        dk = int(np.nonzero(s.hit == m)[0][0])
        s2 = self._copy()
        s2.parent[child] = s2.parent[m]
        # drop node m, renumber node ids > m
        keep_n = np.arange(s2.n_ldsk) != m
        s2.coord = s2.coord[keep_n]
        s2.h_node = s2.h_node[keep_n]
        par = s2.parent[keep_n]
        par = np.where(par > m, par - 1, par)
        s2.parent = par
        keep_k = np.arange(s2.n_disks) != dk
        s2.h_disk = s2.h_disk[keep_k]
        s2.centr = s2.centr[keep_k]
        hit = s2.hit[keep_k]
        s2.hit = np.where(hit > m, hit - 1, hit)
        # reverse insert: choose child among parent>=0 lineages of s2,
        # t in child's new segment, c ~ N(coord[child], rad), y ~ N(c, rad)
        cands2 = int(np.sum(s2.parent >= 0))
        child2 = child if child < m else child - 1
        t_lo = float(s2.h_node[child2])
        t_hi = float(s2.h_node[s2.parent[child2]])
        if t_hi <= t_lo:
            return False
        log_q_fwd = -np.log(len(singles))
        log_q_rev = (-np.log(cands2) - np.log(t_hi - t_lo)
                     + lognorm(s.centr[dk], s2.coord[child2], rad)
                     + lognorm(s.coord[m], s.centr[dk], rad))
        lnl = self._dc.propose_delete_hit(s2, m, dk, child)
        return self._accept("indel_hit", s2, self.params,
                            log_q_rev - log_q_fwd,
                            hint=("lnl", lnl))

    def _mv_exchange(self):
        """Swap the parents of two nodes a, b (parents u != v), valid
        when each node is younger than its new parent — a genealogy
        topology change (MCMC_PHYREX_Wide_Exchange)."""
        s = self.state
        cands = np.nonzero(s.parent >= 0)[0]
        if cands.size < 2:
            return False
        a, b = self.rng.choice(cands, size=2, replace=False)
        a, b = int(a), int(b)
        u, v = int(s.parent[a]), int(s.parent[b])
        if u == v or a == v or b == u:
            return False
        if s.h_node[a] >= s.h_node[v] or s.h_node[b] >= s.h_node[u]:
            return False
        s2 = self._copy()
        s2.parent[a], s2.parent[b] = v, u
        return self._accept("exchange", s2, self.params, 0.0,
                            affects_seq=True,
                            hint=("rowcol", [], [a, b]))

    def _mv_spr(self):
        """ldsk-level SPR: detach one lineage x from its parent node
        and re-attach it to a DIFFERENT hit node older than x — the
        genealogy rearrangement beyond wide-exchange (≙ MCMC_PHYREX_Prune_Regraft, mcmc.c; the
        reference's spr over ldsk chains).  Uniform choice among
        valid targets both ways gives the F/R Hastings count."""
        s = self.state
        counts = np.bincount(s.parent[s.parent >= 0],
                             minlength=s.n_ldsk)
        # detaching must not orphan the old parent: pass-through
        # nodes are created/destroyed by indel_hit, not here
        cands = np.nonzero((s.parent >= 0)
                           & (counts[np.clip(s.parent, 0,
                                             s.n_ldsk - 1)] >= 2))[0]
        if cands.size == 0:
            return False
        x = int(self.rng.choice(cands))
        p0 = int(s.parent[x])
        hx = float(s.h_node[x])
        hit_nodes = s.hit[s.hit >= 0]
        targets = [int(u) for u in hit_nodes
                   if u != p0 and float(s.h_node[u]) > hx and u != x
                   and not self._is_descendant(s, int(u), x)]
        if not targets:
            return False
        v = int(targets[self.rng.integers(len(targets))])
        s2 = self._copy()
        s2.parent[x] = v
        # reverse targets from the NEW state
        rev = [int(u) for u in hit_nodes
               if u != v and float(s2.h_node[u]) > hx and u != x
               and not self._is_descendant(s2, int(u), x)]
        if p0 not in rev:
            return False
        counts2 = np.bincount(s2.parent[s2.parent >= 0],
                              minlength=s2.n_ldsk)
        cands2 = np.nonzero(
            (s2.parent >= 0)
            & (counts2[np.clip(s2.parent, 0,
                               s2.n_ldsk - 1)] >= 2))[0]
        if x not in cands2:
            return False
        log_h = float(np.log(len(targets)) - np.log(len(rev))
                      + np.log(cands.size) - np.log(cands2.size))
        return self._accept("spr", s2, self.params, log_h,
                            affects_seq=True,
                            hint=("rowcol", [], [x]))

    @staticmethod
    def _is_descendant(s, u, x):
        """True when node u lies inside the subtree rooted at x."""
        while u >= 0:
            if u == x:
                return True
            u = int(s.parent[u])
        return False

    def _mv_scale(self):
        """Scale every internal-node height and every empty-disk time
        by m; hit-disk times follow their nodes.  Jacobian:
        (n_internal + n_empty) log m (MCMC_PHYREX_Scale_Times)."""
        s = self.state
        m = float(np.exp(0.5 * self.step * (self.rng.random() - 0.5)))
        s2 = self._copy()
        s2.h_node[s.n_otu:] *= m
        hit_nodes = s2.hit >= 0
        s2.h_disk = np.where(hit_nodes, s2.h_node[
            np.clip(s2.hit, 0, s2.n_ldsk - 1)], s2.h_disk * m)
        n_free = (s.n_ldsk - s.n_otu) + int(np.sum(s.hit < 0))
        # feasibility (child younger than parent) is scale-invariant;
        # so are the [K, L] activity masks and distances, so only the
        # Poisson span term changes: O(1) delta
        dc = self._dc
        span_new = float(s2.h_node.max())
        lnl = dc.total() - self.params.lbda * (span_new - dc.span)
        return self._accept("scale", s2, self.params,
                            n_free * np.log(m), affects_seq=True,
                            hint=("lnl", lnl))

    def _mv_clock(self):
        """Log-multiplier on the strict clock rate (seq-coupled runs
        only); Exp(1) prior folded into the ratio via the -clock
        term."""
        if self.seq_fn is None:
            return False
        m = float(np.exp(self.step * (self.rng.random() - 0.5)))
        c2 = self.clock * m
        # prior ratio exp(-(c2 - c)) + Hastings log m
        return self._accept("clock", self.state, self.params,
                            np.log(m) - (c2 - self.clock),
                            clock_new=c2)

    # ------------------------------------------------------------------
    def sweep(self):
        """One sweep: every move family once, in random order."""
        fns = {"param": self._mv_param, "centr": self._mv_centr,
               "ldsk": self._mv_ldsk, "etime": self._mv_etime,
               "ntime": self._mv_ntime,
               "indel_disk": self._mv_indel_disk,
               "indel_hit": self._mv_indel_hit,
               "exchange": self._mv_exchange,
               "spr": self._mv_spr,
               "scale": self._mv_scale,
               "clock": self._mv_clock}
        names = [m for m in self.MOVES
                 if (self.sample_params or m != "param")
                 and (self.sample_genealogy
                      or m not in ("exchange", "spr"))
                 and (self.seq_fn is not None or m != "clock")]
        for m in self.rng.permutation(names):
            fns[str(m)]()

    def run(self, n_sweeps: int = 2000, thin: int = 10):
        """Returns trace [n_samples, 7]:
        (posterior, lbda, mu, rad, n_disks, root_height, n_ldsk)."""
        out = []
        for it in range(n_sweeps):
            self.sweep()
            if it % thin == 0:
                s, p = self.state, self.params
                out.append((self.lp, p.lbda, p.mu, p.rad,
                            s.n_disks, float(s.h_node.max()),
                            s.n_ldsk))
        return np.asarray(out)


def state_from_timetree(tt, coords, rng=None, jitter: float = 1e-3):
    """Initial augmented state from a binary TimeTree + tip
    coordinates: one hit disk per coalescence, internal locations set
    to child midpoints, no empty disks (the joint sampler inserts
    them).  ≙ PHYREX_Tree_To_Ldsk-style initialization."""
    rng = rng or np.random.default_rng(0)
    n = tt.n_otu
    coords = np.asarray(coords, dtype=np.float64)
    D = coords.shape[1]
    n_nodes = 2 * n - 1
    coord = np.zeros((n_nodes, D))
    coord[:n] = coords
    parent = np.full(n_nodes, -1, dtype=np.int64)
    for i in range(n - 1):
        c0, c1 = int(tt.child[i, 0]), int(tt.child[i, 1])
        u = n + i
        parent[c0] = u
        parent[c1] = u
        coord[u] = 0.5 * (coord[c0] + coord[c1]) \
            + jitter * rng.standard_normal(D)
    h_node = np.asarray(tt.heights, dtype=np.float64).copy()
    h_disk = h_node[n:].copy()
    centr = coord[n:] + jitter * rng.standard_normal((n - 1, D))
    hit = np.arange(n, n_nodes, dtype=np.int64)
    return SLFVState(n_otu=n, coord=coord, h_node=h_node,
                     parent=parent, h_disk=h_disk, centr=centr,
                     hit=hit)


def make_seq_loglik_fn(engine, params):
    """Sequence log-likelihood of an augmented state under a strict
    clock: collapse the ldsk chain to the binary time tree, set each
    edge length to clock * dt, one likelihood pass on a system cached
    once (one launch of the route's slot kernel on the card, one float
    read back).  Used by SLFVJointSampler to couple the genealogy to
    the alignment — the reference's PHYREX_MCMC likewise alternates
    spatial and sequence terms (phyrex.c:1234, Lk calls per move)."""
    from phyml_tpu_torch.ops.likelihood import TreeArrays

    sys_cached = engine.system_of(params)

    def fn(state: SLFVState, clock: float) -> float:
        tt = state_to_timetree(state)
        n = tt.n_otu
        par = np.full(tt.n_nodes, -1, dtype=np.int64)
        for i in range(n - 1):
            par[tt.child[i, 0]] = n + i
            par[tt.child[i, 1]] = n + i
        dt = np.where(par >= 0,
                      tt.heights[np.clip(par, 0, tt.n_nodes - 1)]
                      - tt.heights, 0.0)
        blen = np.maximum(clock * dt, 1e-10)
        blen[tt.n_nodes - 1] = 0.0
        tree = TreeArrays(
            child=torch.as_tensor(tt.child.astype(np.int32)),
            blen=torch.as_tensor(blen, dtype=engine.dtype,
                                 device=engine.device))
        return float(engine._loglik_sys(sys_cached, tree))

    return fn
