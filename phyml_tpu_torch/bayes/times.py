"""Node-time priors and calibrations (≙ times.c, date.c calibrations).

Port of phyml_tpu/bayes/times.py on float64 tensors.  The reference's
TIMES_Lk dispatches on the tree-generating model: birth-death with
incomplete sampling (times.c:1610), Yule (times.c:445-660), coalescent
with constant or exponentially growing effective size
(times.c:851/:938), and calibrated-uniform (times.c:417).  Calibrations
are per-clade bounds attached to MRCA nodes (`t_cal`/`t_clad`
utilities.h:2197-2227, read from XML by XML_Read_Calibration
xml.c:2417).

Each prior is a pure log-density over the node-height vector,
differentiable by torch.autograd (the MCMC's MALA move); calibrations
are hard-bound terms added to the joint posterior.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

import numpy as np
import torch

BIRTHDEATH = "birthdeath"
YULE = "yule"
COALESCENT = "coalescent"
EXPCOALESCENT = "expcoalescent"
UNIFORM = "uniform"
CALYULE = "calibrated_yule"   # invitee.c mixture over calibrations

NEG_INF = -1e30


@dataclass(frozen=True)
class Calibration:
    """Clade calibration: bounds on the MRCA height of `taxa`
    (≙ t_cal utilities.h:2197; XML <calibration> with <lower>/<upper>).
    node is resolved against a TimeTree at setup."""
    taxa: tuple
    lower: float = 0.0
    upper: float = float("inf")
    node: int = -1

    def resolved(self, tt) -> "Calibration":
        idx = [tt.names.index(t) if isinstance(t, str) else int(t)
               for t in self.taxa]
        node = tt.mrca(idx) if len(idx) > 1 else idx[0]
        return Calibration(taxa=self.taxa, lower=self.lower,
                           upper=self.upper, node=node)


@dataclass(frozen=True)
class TimePrior:
    """Prior over node heights.

    kind: 'yule' | 'birthdeath' | 'coalescent' | 'expcoalescent' |
    'uniform' | 'calibrated_yule'.  Hyperparameters enter via the MCMC
    state so they can be sampled:
      yule/birthdeath: birth (lambda), death (mu)
      coalescent: theta (= 2*Ne in pairwise-rate units)
      expcoalescent: theta0, growth g  (Ne(t) = N0 * exp(-g t))
    """

    kind: str = BIRTHDEATH
    calibrations: tuple = field(default_factory=tuple)
    # 'calibrated_yule' only: MultiCalibration tuple (clade-choice
    # mixtures, invitee.c); plain calibrations are auto-converted
    multi_calibrations: tuple = field(default_factory=tuple)
    # resolved CalibratedYule engine (set by resolve())
    calyule: object = field(default=None, compare=False)

    def resolve(self, tt) -> "TimePrior":
        from phyml_tpu_torch.bayes.invitee import (
            CalibratedYule, CladeChoice, MultiCalibration,
        )
        out = TimePrior(
            kind=self.kind,
            calibrations=tuple(c.resolved(tt)
                               for c in self.calibrations),
            multi_calibrations=self.multi_calibrations,
        )
        if self.kind == CALYULE:
            mcals = list(self.multi_calibrations)
            # plain bounds calibrations become single-choice mixtures
            # and are NOT double-counted by log_calibrations
            mcals += [
                MultiCalibration(choices=(CladeChoice(taxa=c.taxa),),
                                 lower=c.lower, upper=c.upper)
                for c in self.calibrations
            ]
            out = replace(out, calibrations=(),
                          calyule=CalibratedYule(tt, tuple(mcals)))
        return out

    # ------------------------------------------------------------------
    def log_prior(self, heights, n_otu: int, hyper: dict):
        """log p(node heights | hyper) (≙ TIMES_Lk)."""
        n_nodes = heights.shape[0]
        root = n_nodes - 1
        internal = heights[n_otu:]
        t_root = heights[root]
        if self.kind == CALYULE:
            # mixture over calibration combinations of root-
            # conditioned truncated-exponential orders
            # (TIMES_Calib_Cond_Prob invitee.c:718)
            return self.calyule.log_prior(heights, hyper["birth"])
        if self.kind == UNIFORM:
            # calibrated-uniform (times.c:417): flat within the
            # feasible region; the MCMC's bound-respecting moves plus
            # calibration terms do the conditioning
            return heights.new_zeros(())
        if self.kind in (YULE, BIRTHDEATH):
            b = torch.clamp(hyper["birth"], min=1e-10)
            d = (torch.zeros_like(b) if self.kind == YULE
                 else torch.clamp(hyper["death"], min=0.0))
            # Density of internal node ages CONDITIONED on the root
            # age under the reconstructed birth-death process with
            # complete sampling (≙ TIMES_Lk_Birth_Death times.c:1610;
            # Yang & Rannala 1997 eq. 6 with rho = 1): each of the
            # n-2 non-root internal nodes contributes
            #   log b + log p1(t) - log nut1(troot)
            # where p1(t) = (b-d)^2 e^{-(b-d)t} / (b - d e^{-(b-d)t})^2
            # and nut1(s) = 1 - pt(s) e^{-(b-d)s},
            #       pt(s) = (b-d)/(b - d e^{-(b-d)s}).
            # b < d is hard-rejected (times.c:1634: return UNLIKELY).
            ti = torch.abs(internal[:-1])          # non-root internals
            troot = torch.abs(t_root)
            bmd = b - d
            n = n_otu

            # --- general case b > d > 0 (times.c:1672-1706) ---------
            bmd_s = torch.where(bmd > 1e-8, bmd, torch.ones_like(bmd))
            d_s = torch.clamp(d, min=1e-300)
            den_root = torch.clamp(b - d_s * torch.exp(-bmd_s * troot),
                                   min=1e-300)
            pt = bmd_s / den_root
            nut1 = torch.clamp(1.0 - pt * torch.exp(-bmd_s * troot),
                               min=1e-300)
            log_p1 = (2.0 * torch.log(bmd_s) - bmd_s * ti
                      - 2.0 * torch.log(torch.clamp(
                          b - d_s * torch.exp(-bmd_s * ti), min=1e-300)))
            lp_gen = torch.sum(torch.log(b) + log_p1 - torch.log(nut1))

            # --- Yule case d ~ 0 (times.c:1714-1738) ----------------
            lognut1_y = torch.log(torch.clamp(-torch.expm1(-b * troot),
                                              min=1e-300))
            lp_yule = torch.sum(torch.log(b) - b * ti - lognut1_y)

            # --- critical case b ~ d (times.c:1761-1786; Yang &
            # Rannala eq. 7 with rho = 1) ----------------------------
            lp_crit = torch.sum(torch.log1p(d)
                                - 2.0 * torch.log1p(d_s * ti))

            lp = torch.where(d < 1e-8, lp_yule,
                             torch.where(torch.abs(bmd) < 1e-8, lp_crit,
                                         lp_gen))
            lp = lp + math.lgamma(float(n) - 1.0)
            return torch.where(bmd < -1e-8,
                               torch.full_like(lp, NEG_INF), lp)
        if self.kind == COALESCENT:
            theta = torch.clamp(hyper["theta"], min=1e-10)
            return self._coalescent_lp(
                heights, n_otu,
                rate=lambda t: 2.0 / theta,
                cum=lambda a, b: 2.0 * (b - a) / theta)
        if self.kind == EXPCOALESCENT:
            theta = torch.clamp(hyper["theta"], min=1e-10)
            g = hyper["growth"]
            small = torch.abs(g) < 1e-12
            g_s = torch.where(small, torch.ones_like(g), g)
            # Ne(t) = N0 e^{-g t} looking backwards => pairwise rate
            # 2/theta * e^{g t}; integral analytic
            return self._coalescent_lp(
                heights, n_otu,
                rate=lambda t: (2.0 / theta) * torch.exp(g * t),
                cum=lambda a, b: torch.where(
                    small, 2.0 * (b - a) / theta,
                    (2.0 / (theta * g_s))
                    * (torch.exp(g * b) - torch.exp(g * a))))
        raise ValueError(self.kind)

    def _coalescent_lp(self, heights, n_otu, rate, cum):
        """Piecewise-interval coalescent density with serial sampling
        (≙ TIMES_Lk_Coalescent times.c:851)."""
        n_nodes = heights.shape[0]
        delta = torch.cat([
            heights.new_ones((n_otu,)),
            -heights.new_ones((n_nodes - n_otu,)),
        ])
        # a stable sort, as jnp.argsort: tied heights keep node order
        order = torch.sort(heights, stable=True).indices
        t = heights[order]
        d = delta[order]
        k = torch.cumsum(d, dim=0)              # lineages after event i
        kk = k[:-1]                             # on interval (t_i, t_{i+1})
        pair = kk * (kk - 1.0) / 2.0
        waiting = -pair * cum(t[:-1], t[1:])
        coal_rate = torch.as_tensor(rate(t[1:])).expand(t[1:].shape)
        coal = torch.where(d[1:] < 0,
                           torch.log(torch.clamp(coal_rate, min=1e-300)),
                           torch.zeros_like(t[1:]))
        return torch.sum(waiting) + torch.sum(coal)

    # ------------------------------------------------------------------
    def log_calibrations(self, heights):
        """Hard-bound calibration terms: 0 inside [lower, upper],
        -inf outside (≙ the calibrated-node uniform densities of
        date.c/invitee.c)."""
        lp = heights.new_zeros(())
        for c in self.calibrations:
            h = float(heights[c.node].detach())
            upper = c.upper if np.isfinite(c.upper) else 1e30
            if not (c.lower <= h <= upper):
                lp = lp + NEG_INF
        return lp

    def hyper_names(self) -> tuple:
        # NB: no "rho" — the reference's conditioned density fixes
        # the sampling fraction at 1 (times.c:1610) and never samples
        # it, so it is not a chain parameter here either.
        return {
            YULE: ("birth",),
            CALYULE: ("birth",),
            BIRTHDEATH: ("birth", "death"),
            COALESCENT: ("theta",),
            EXPCOALESCENT: ("theta", "growth"),
            UNIFORM: (),
        }[self.kind]

    def default_hyper(self) -> dict:
        f64 = dict(dtype=torch.float64)
        return {
            "birth": torch.tensor(1.0, **f64),
            "death": torch.tensor(0.5, **f64),
            "theta": torch.tensor(1.0, **f64),
            "growth": torch.tensor(0.0, **f64),
        }
