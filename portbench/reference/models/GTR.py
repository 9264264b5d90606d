"""GTR (Tavare 1986) with a discrete Gamma: nucleotides ACGT, six
exchangeabilities AC AG AT CG CT GT relative to GT = 1.  Free
parameters x: the logs of the first five exchangeabilities, then the
log of the Gamma shape."""

import numpy as np
import torch

from portbench.reference import model as M

ALPHABET = M.NT_STATES
F64 = torch.float64


def truth(model):
    rr = np.asarray(model["rates"], dtype=np.float64)
    x = np.concatenate([np.log(rr[:5] / rr[5]), [np.log(model["alpha"])]])
    return x, np.asarray(model["frequencies"], dtype=np.float64)


def start(values, model):
    """The program's `rr_val` (log exchangeabilities) and `alpha`."""
    rr = np.exp(np.asarray(values["rr_val"], dtype=np.float64))
    return np.concatenate([np.log(rr[:5] / rr[5]),
                           np.log(np.atleast_1d(values["alpha"]))])


def values(x, model):
    return {"rr_val": list(x[:5]) + [0.0], "alpha": float(np.exp(x[5]))}


def mixture(x, freqs, model):
    pairs = torch.as_tensor(np.stack([M.gtr_exchangeabilities(
        np.eye(6)[k]) for k in range(6)]), dtype=F64, device=x.device)
    rr6 = torch.cat([torch.exp(x[:5]), torch.ones(1, dtype=F64,
                                                  device=x.device)])
    S = (rr6[:, None, None] * pairs).sum(0)
    return M.gamma_classes(S, freqs, x[5], model["categories"])
