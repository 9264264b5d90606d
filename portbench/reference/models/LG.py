"""LG (Le and Gascuel 2008) with a discrete Gamma: the published
exchangeabilities and frequencies (`reference/lg.json`), amino acids
ARNDCQEGHILKMFPSTWYV.  Free parameter x: the log of the Gamma shape."""

import numpy as np
import torch

from portbench.reference import model as M

ALPHABET = M.AA_STATES
F64 = torch.float64


def truth(model):
    return np.log(np.atleast_1d(float(model["alpha"]))), M.lg()[1]


def start(values, model):
    """The program's `alpha`."""
    return np.log(np.atleast_1d(np.asarray(values["alpha"], np.float64)))


def values(x, model):
    return {"alpha": float(np.exp(x[0]))}


def mixture(x, freqs, model):
    S = torch.as_tensor(M.lg()[0], dtype=F64, device=x.device)
    return M.gamma_classes(S, freqs, x[0], model["categories"])
