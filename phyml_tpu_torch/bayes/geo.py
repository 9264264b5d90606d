"""Discrete-landscape phylogeography with competition (≙ geo.c).

Port of phyml_tpu/bayes/geo.py.  The reference's GEO model: a
landscape of `L` discrete locations with coordinates; forward in time,
each lineage in location i migrates to location j with rate

    r[i, j] = f(i, j) * (occupied(j) ? lbda : 1) * tau * dum,
    f(i, j) = exp(-||x_i - x_j||^2 / (2 sigma^2)) / L

(GEO_Update_Fmat geo.c:517 — the self-density terms cancel the
normal-density constants, leaving the Gaussian kernel over the
landscape distance; GEO_Update_Rmat geo.c:664).  `lbda < 1` models
competition: occupied demes are harder to enter.  A migration is
observed at every branching: one daughter keeps the parent's
location, the other carries the arrival location
(GEO_Get_Arrival_Location geo.c:846).  The likelihood walks time
slices from the root down, each contributing the exponential waiting
term -R * dt and the chosen migration's log-rate (GEO_Lk geo.c:682).

The [L, L] rate algebra runs in float64 torch on the model's device
(the CUDA device unless given), differentiable in (sigma, lbda, tau);
the walk over the height-sorted internal nodes is a host loop (the
labels are host integers), where phyml_tpu scans it in one jitted
program.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30
F64 = torch.float64


class GeoModel:
    """Landscape + likelihood for one (tree, tip-location) problem.
    `coords` [L, D] are the landscape locations (≙ t_geo->ldscape);
    `tt` a TimeTree; `tip_loc` [n_otu] int location indices
    (≙ GEO_Init_Tloc_Tips geo.c:807)."""

    def __init__(self, coords, tt, tip_loc, device=None):
        from phyml_tpu_torch.ops.likelihood import default_device

        self.device = default_device(device)
        self.coords = np.asarray(coords, dtype=np.float64)
        self.L = self.coords.shape[0]
        self.tt = tt
        self.n_otu = tt.n_otu
        self.n_nodes = tt.n_nodes
        self.tip_loc = np.asarray(tip_loc, dtype=np.int32)
        assert self.tip_loc.shape == (self.n_otu,)
        # squared landscape distances, host-precomputed
        d = self.coords[:, None, :] - self.coords[None, :, :]
        self._d2 = torch.as_tensor(np.sum(d * d, axis=-1), dtype=F64,
                                   device=self.device)
        # internal nodes sorted oldest -> youngest (root first);
        # heights are fixed in the GEO sampler (GEO_MCMC geo.c:350
        # samples locations + parameters, not times)
        h = np.asarray(tt.heights, dtype=np.float64)
        internal = np.arange(self.n_otu, self.n_nodes)
        self._order = internal[np.argsort(-h[internal])]
        self._heights = h
        self._child = np.asarray(tt.child, dtype=np.int64)

    # ------------------------------------------------------------------
    def _fmat(self, sigma):
        """f(i, j) = exp(-d2/(2 sigma^2)) / L (GEO_Update_Fmat)."""
        return torch.exp(-self._d2 / (2.0 * sigma * sigma)) / self.L

    def _scalar(self, x):
        return torch.as_tensor(x, dtype=F64, device=self.device)

    def _loglik_impl(self, loc, sigma, lbda, tau, dum=1.0):
        """loc [n_nodes] host int location of every node (tips fixed
        by the data; internal sampled).  Returns the GEO_Lk
        log-density (a float64 0-d tensor on the model's device), or
        NEG_INF when the labeling breaks the one-daughter-inherits
        rule."""
        n = self.n_otu
        f = self._fmat(sigma)
        child, order, heights = self._child, self._order, self._heights
        zero = torch.zeros(self.L, dtype=F64, device=self.device)
        onehot = torch.eye(self.L, dtype=F64, device=self.device)

        # occupancy during the first slice below the root: the root
        # lineage plus the arrival of the root's own split (the
        # reference's occup[sorted_nd[1]] = occup[root] + root
        # arrival, GEO_Update_Occup geo.c:592; the root migration
        # itself is not scored — it seeds the two starting lineages)
        root = int(order[0])
        rc0, rc1 = child[root - n]
        dep_r = int(loc[root])
        inh0 = int(loc[rc0]) == dep_r
        ok = inh0 or int(loc[rc1]) == dep_r
        arr_r = int(loc[rc1]) if inh0 else int(loc[rc0])
        occ = zero + onehot[dep_r] + onehot[arr_r]
        lnl = torch.zeros((), dtype=F64, device=self.device)
        h_prev = heights[root]
        for k in range(1, n - 1):
            u = int(order[k])                  # current event node
            c0, c1 = child[u - n]
            dep, l0, l1 = int(loc[u]), int(loc[c0]), int(loc[c1])
            # one daughter inherits dep; the other is the arrival
            inherit0 = l0 == dep
            ok = ok and (inherit0 or l1 == dep)
            arr = l1 if inherit0 else l0
            # rates on the slice ABOVE this node use the occupancy
            # before the split (GEO_Update_Rmat with occup[u])
            lbda_j = torch.where(occ > 0, lbda, torch.ones_like(occ))
            r = f * (lbda_j * tau * dum)[None, :]       # [L, L]
            R = torch.sum(r * occ[:, None])
            dt = h_prev - heights[u]
            lnl = lnl - R * dt + torch.log(
                torch.clamp(r[dep, arr], min=1e-300))
            # the split adds one lineage at the arrival location
            occ = occ + onehot[arr]
            h_prev = heights[u]
        # the last slice (down to the tips) has no event term; the
        # reference's GEO_Lk also stops at the youngest internal node
        return lnl if ok else torch.full_like(lnl, NEG_INF)

    def loglik(self, internal_loc, sigma, lbda, tau, dum=1.0):
        """internal_loc [n_internal] locations for nodes
        n_otu..n_nodes-1."""
        loc = np.concatenate([self.tip_loc,
                              np.asarray(internal_loc, dtype=np.int32)])
        return self._loglik_impl(loc, self._scalar(sigma),
                                 self._scalar(lbda), self._scalar(tau),
                                 self._scalar(dum))

    # ------------------------------------------------------------------
    def init_locations(self, rng: np.random.Generator) -> np.ndarray:
        """Feasible internal labeling: every internal node inherits a
        uniformly chosen child's location, bottom-up
        (≙ GEO_Randomize_Locations geo.c:1299)."""
        n = self.n_otu
        loc = np.zeros(self.n_nodes, dtype=np.int32)
        loc[:n] = self.tip_loc
        for i in range(self.n_nodes - n):
            c = self.tt.child[i]
            loc[n + i] = loc[int(c[int(rng.integers(0, 2))])]
        return loc[n:]

    def mcmc(self, n_iter: int = 4000, seed: int = 0,
             sigma0: float = 1.0, lbda0: float = 1.0,
             tau0: float = 1.0, step: float = 0.5):
        """Metropolis sampler over (sigma, lbda, tau, internal
        locations) — the GEO_MCMC loop (geo.c:350: MCMC_GEO_Lbda/Tau/
        Loc/Sigma) with log-multiplier parameter moves and
        child-inheritance location proposals.  Exp(1) priors on all
        three scalars (the reference uses uniform-on-range; the
        exponential keeps the density proper).  Draws from numpy's
        default_rng(seed) in phyml_tpu's order.  Returns
        (sigma, lbda, tau, internal_loc, trace [n_iter, 4])."""
        rng = np.random.default_rng(seed)
        iloc = self.init_locations(rng)
        s, lb, ta = sigma0, lbda0, tau0

        def post(il, s_, lb_, ta_):
            return float(self.loglik(il, s_, lb_, ta_)) - s_ - lb_ - ta_

        lp = post(iloc, s, lb, ta)
        trace = np.zeros((n_iter, 4))
        n = self.n_otu
        for it in range(n_iter):
            which = it % 4
            if which < 3:
                m = float(np.exp(step * (rng.random() - 0.5)))
                s2, lb2, ta2 = s, lb, ta
                if which == 0:
                    s2 = s * m
                elif which == 1:
                    lb2 = lb * m
                else:
                    ta2 = ta * m
                lp2 = post(iloc, s2, lb2, ta2)
                if np.log(rng.random()) < lp2 - lp + np.log(m):
                    s, lb, ta, lp = s2, lb2, ta2, lp2
            else:
                # relabel a random internal node with a child's
                # location (keeps the labeling feasible)
                i = int(rng.integers(0, n - 1))
                c = self.tt.child[i]
                cur_all = np.concatenate([self.tip_loc, iloc])
                new = int(cur_all[int(c[int(rng.integers(0, 2))])])
                il2 = iloc.copy()
                il2[i] = new
                lp2 = post(il2, s, lb, ta)
                if np.log(rng.random()) < lp2 - lp:
                    iloc, lp = il2, lp2
            trace[it] = (lp, s, lb, ta)
        return s, lb, ta, iloc, trace
