"""Bayesian tier: clock models, node-time priors, MCMC, dating.

Port of phyml_tpu/bayes (the reference's PhyTime stack: date.c,
rates.c, times.c, invitee.c, mcmc.c): the chain state is a tuple of
host tensors, every move a (draw, apply) pair scored against one joint
log-posterior whose likelihood runs on the engine's device.
"""

from phyml_tpu_torch.bayes.chrono import TimeTree
from phyml_tpu_torch.bayes.mcmc import MCMC, MCMCSettings
from phyml_tpu_torch.bayes.rates import RateModel
from phyml_tpu_torch.bayes.times import Calibration, TimePrior

__all__ = [
    "TimeTree", "RateModel", "TimePrior", "Calibration",
    "MCMC", "MCMCSettings",
]
