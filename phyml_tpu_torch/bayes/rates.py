"""Clock / rate-across-lineage models (≙ rates.c, t_rate
utilities.h:1761-1870).

Port of phyml_tpu/bayes/rates.py on float64 tensors.  The reference
supports STRICTCLOCK, LOGNORMAL (uncorrelated lognormal), THORNE
(autocorrelated geometric Brownian motion) and GUINDON
(branch-integrated) rate models; `RATES_Lk` (rates.c:27) scores the
per-edge relative rates under the chosen model and
`RATES_Update_One_Edge_Length` (rates.c:1244) maps
(clock, rate, duration) -> substitution length.  Each model is a pure
log-density over the vector of per-edge log-rates, differentiable by
torch.autograd (the MCMC's MALA move).

All densities are functions of:
  log_r   [n_nodes]  log relative rate on the edge above each node
                     (root entry ignored)
  dt      [n_nodes]  edge durations (root entry 0)
  parent  [n_nodes]  parent ids
  nu      scalar     rate-variation hyperparameter (autocorrelation
                     variance per unit time for THORNE, log-sd for
                     LOGNORMAL)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LOG2PI = float(np.log(2.0 * np.pi))

STRICT = "strict"
LOGNORMAL = "lognormal"
THORNE = "thorne"
GUINDON = "guindon"


def _root_mask(log_r, root: int):
    """1 on every edge, 0 at the root slot."""
    mask = torch.ones_like(log_r)
    mask[root] = 0.0
    return mask


@dataclass(frozen=True)
class RateModel:
    """Relative-rate prior over lineages.

    kind: 'strict' | 'lognormal' | 'thorne' | 'guindon'.
    'guindon' (Guindon 2012, the reference's branch-length-integrated
    model) shares the Thorne autocorrelated prior over branch-average
    rates; its likelihood additionally integrates P(t) over
    within-branch rate variation via the Gamma MGF
    (LikelihoodEngine.loglik_mgf ≙ PMat_MGF_Gamma models.c:1044).
    """

    kind: str = LOGNORMAL

    def log_prior(self, log_r, dt, parent, nu, root: int):
        """Joint log-density of per-edge log relative rates
        (≙ RATES_Lk rates.c:27 dispatching on the model)."""
        if self.kind == STRICT:
            return log_r.new_zeros(())
        nu = torch.clamp(nu, min=1e-10)
        mask = _root_mask(log_r, root)
        if self.kind == LOGNORMAL:
            # iid: log r_e ~ N(-nu^2/2, nu^2)  => E[r_e] = 1
            mu = -0.5 * nu * nu
            z = (log_r - mu) / nu
            lp = -0.5 * (z * z + LOG2PI) - torch.log(nu)
            return torch.sum(lp * mask)
        # THORNE / GUINDON: geometric Brownian motion down the tree:
        # log r_child ~ N(log r_parent - nu*dt/2, nu*dt)
        # (mean-correction keeps E[r_child | r_parent] = r_parent,
        #  matching the reference's autocorrelated THORNE model)
        var = torch.clamp(nu * dt, min=1e-12)
        anc = torch.where(parent == root, torch.zeros_like(log_r),
                          log_r[parent])
        mu = anc - 0.5 * var
        z = (log_r - mu) / torch.sqrt(var)
        lp = -0.5 * (z * z + LOG2PI) - 0.5 * torch.log(var)
        return torch.sum(lp * mask)

    def rates(self, log_r, root: int):
        """Per-edge relative rates r_e = exp(log_r); pinned to 1 under
        the strict clock and at the (meaningless) root slot."""
        if self.kind == STRICT:
            return torch.ones_like(log_r)
        r = torch.exp(log_r)
        return torch.where(_root_mask(log_r, root) > 0, r,
                           torch.ones_like(r))
