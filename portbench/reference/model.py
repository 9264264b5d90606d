"""Substitution models of the benchmark's configurations, in float64 NumPy.

Written from the published definitions, not from the program:

* GTR (Tavare 1986): six exchangeabilities in the order AC AG AT CG CT
  GT, relative to GT = 1, and the state frequencies; nucleotides in the
  order ACGT.
* LG (Le and Gascuel 2008): the published exchangeabilities and
  frequencies in `lg.json` (amino acids in the order ARNDCQEGHILKMFPSTWYV),
  the frequencies renormalised to sum to 1.
* Q is scaled to one expected substitution per unit of branch length.
* Discrete Gamma with K categories of equal weight, each category's rate
  the mean of the Gamma(alpha, alpha) distribution over that category
  (Yang 1994), renormalised to mean 1.

Each model of a configuration is a file `reference/models/<name>.py`,
found by the configuration's model name (see `models/__init__.py`);
what they share is here.  The generator simulates with these models and
the reference evaluates with them, so the data and the yardstick share
one definition.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
from scipy import special

F64 = torch.float64

NT_STATES = "ACGT"
AA_STATES = "ARNDCQEGHILKMFPSTWYV"
# index pairs of the six GTR exchangeabilities: AC AG AT CG CT GT
GTR_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))

_LG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lg.json")


def gtr_exchangeabilities(rates) -> np.ndarray:
    """Symmetric [4, 4] exchangeabilities (zero diagonal) from the six
    rates AC AG AT CG CT GT."""
    S = np.zeros((4, 4))
    for (i, j), r in zip(GTR_PAIRS, rates):
        S[i, j] = S[j, i] = float(r)
    return S


def lg() -> tuple[np.ndarray, np.ndarray]:
    """(S [20, 20] symmetric exchangeabilities, pi [20]) of LG."""
    with open(_LG) as fh:
        data = json.load(fh)
    S = np.zeros((20, 20))
    for i, row in enumerate(data["exchangeabilities_lower"], start=1):
        S[i, :i] = row
    S = S + S.T
    pi = np.asarray(data["frequencies"], dtype=np.float64)
    return S, pi / pi.sum()


def eigen(S, pi):
    """(lam [ns], V [ns, ns], Vinv [ns, ns]) with Q = V diag(lam) Vinv,
    Q_ij = S_ij pi_j off the diagonal, rows summing to 0, scaled to one
    expected substitution per unit time."""
    S = np.asarray(S, dtype=np.float64)
    pi = np.asarray(pi, dtype=np.float64)
    Q = S * pi[None, :]
    np.fill_diagonal(Q, 0.0)
    np.fill_diagonal(Q, -Q.sum(axis=1))
    Q = Q / -(pi * np.diag(Q)).sum()
    # symmetrise: B = D^1/2 Q D^-1/2
    r = np.sqrt(pi)
    B = Q * r[:, None] / r[None, :]
    lam, U = np.linalg.eigh((B + B.T) / 2.0)
    return lam, U / r[:, None], U.T * r[None, :]


def discrete_gamma(alpha: float, K: int) -> np.ndarray:
    """Rates [K] of the mean-one discrete Gamma, category means."""
    alpha = float(alpha)
    cuts = special.gammaincinv(alpha, np.arange(1, K) / K) / alpha
    cum = special.gammainc(alpha + 1.0, cuts * alpha)
    cum = np.concatenate([[0.0], cum, [1.0]])
    rates = K * np.diff(cum)
    return rates / rates.mean()


def pmat(lam, V, Vinv, t):
    """P(t) = V exp(lam t) Vinv for every t: [..., ns, ns]."""
    t = np.asarray(t, dtype=np.float64)
    E = np.exp(t[..., None] * lam)
    return np.einsum("xi,...i,iy->...xy", V, E, Vinv)


class _GammaRates(torch.autograd.Function):
    """Discrete Gamma rates of shape exp(x), their derivative by central
    differences of the closed form."""

    @staticmethod
    def forward(ctx, x, K):
        a = math.exp(float(x))
        h = 1e-5
        hi = discrete_gamma(a * math.exp(h), K)
        lo = discrete_gamma(a * math.exp(-h), K)
        ctx.save_for_backward(torch.as_tensor((hi - lo) / (2 * h),
                                              dtype=F64, device=x.device))
        return torch.as_tensor(discrete_gamma(a, K), dtype=F64,
                               device=x.device)

    @staticmethod
    def backward(ctx, g):
        (dr,) = ctx.saved_tensors
        return (g * dr).sum(), None


def gamma_rates(log_alpha: torch.Tensor, K: int) -> torch.Tensor:
    """Rates [K] of the mean-one discrete Gamma of shape exp(log_alpha),
    differentiable in log_alpha."""
    return _GammaRates.apply(log_alpha, int(K))


def gamma_classes(S: torch.Tensor, pi: torch.Tensor, log_alpha, K: int):
    """(S [K, ns, ns], pi [K, ns], rate [K], weight [K]): one
    exchangeability matrix and one set of frequencies under K discrete
    Gamma classes of equal weight."""
    rate = gamma_rates(log_alpha, K)
    ns = pi.shape[-1]
    return (S.expand(K, ns, ns), pi.expand(K, ns), rate,
            torch.full((K,), 1.0 / K, dtype=F64, device=pi.device))
