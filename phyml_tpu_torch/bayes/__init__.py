"""Bayesian tier: clock models, node-time priors, MCMC, dating and
phylogeography.

Port of phyml_tpu/bayes (the reference's PhyTime and PhyREX stacks:
date.c, rates.c, times.c, invitee.c, mcmc.c, phyrex.c, slfv.c, rw.c,
rrw.c, ibm.c, iwn.c, iou.c, geo.c): the chain state is a tuple of host
tensors, every move a (draw, apply) pair scored against one joint
log-posterior whose likelihood runs on the engine's device.
"""

from phyml_tpu_torch.bayes.chrono import TimeTree
from phyml_tpu_torch.bayes.geo import GeoModel
from phyml_tpu_torch.bayes.mcmc import MCMC, MCMCSettings
from phyml_tpu_torch.bayes.phyrex import PhyrexResult, run_phyrex
from phyml_tpu_torch.bayes.rates import RateModel
from phyml_tpu_torch.bayes.slfv import (
    SLFVJointSampler, SLFVParams, SLFVState,
)
from phyml_tpu_torch.bayes.times import Calibration, TimePrior

__all__ = [
    "TimeTree", "RateModel", "TimePrior", "Calibration",
    "MCMC", "MCMCSettings", "GeoModel", "PhyrexResult", "run_phyrex",
    "SLFVJointSampler", "SLFVParams", "SLFVState",
]
