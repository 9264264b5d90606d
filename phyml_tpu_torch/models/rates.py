"""Rates-across-sites: discrete Gamma, +I, FreeRate.

Parity target: the reference's DiscreteGamma (stats.c:1974, the
Yang 1994 discretization with mean or median binning) and the t_ras
settings (utilities.h:1218-1263, Update_RAS models.c:669).

The Gamma quantile is the same Newton iteration on the regularized
incomplete gamma (torch.special.gammainc) from a Wilson-Hilferty
start as phyml_tpu's, with the same iteration count, so float64
results agree with it to roundoff.  Shape parameters may carry a
leading batch shape; the outputs gain it.
"""

from __future__ import annotations

import math

import torch

_F64 = torch.float64


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F64)


def _unbroadcast(g, shape):
    """g summed down to `shape` (the reverse of broadcasting)."""
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class _GammaInc(torch.autograd.Function):
    """torch.special.gammainc(a, x) with a derivative in the shape a,
    which torch does not implement (the MCMC's MALA move differentiates
    the discrete Gamma rates in alpha, as phyml_tpu does through
    jax.scipy's).  d/dx is the Gamma density; d/da a central difference
    of gammainc at a relative step of 6e-6 (float64: ~1e-10
    relative)."""

    @staticmethod
    def forward(ctx, a, x):
        ctx.save_for_backward(a, x)
        return torch.special.gammainc(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        h = 6e-6 * a
        da = (torch.special.gammainc(a + h, x)
              - torch.special.gammainc(a - h, x)) / (2.0 * h)
        dx = torch.exp((a - 1.0) * torch.log(x) - x - torch.lgamma(a))
        return _unbroadcast(g * da, a.shape), _unbroadcast(g * dx, x.shape)


def _gammainc(a, x):
    if a.requires_grad or x.requires_grad:
        return _GammaInc.apply(a, x)
    return torch.special.gammainc(a, x)


def gamma_icdf(p, alpha, n_newton: int = 40):
    """Quantile of Gamma(shape=alpha, scale=1) via Newton in log-x.

    Accurate to ~1e-12 (fp64) across alpha in [1e-3, 1e3],
    p in (0, 1).  p and alpha broadcast against each other.
    """
    p = _f64(p)
    alpha = _f64(alpha)
    # Wilson-Hilferty starting point (chi^2_{2a}/2)
    z = math.sqrt(2.0) * _erfinv_approx(2.0 * p - 1.0)
    c = 1.0 - 1.0 / (9.0 * alpha) + z / (3.0 * torch.sqrt(alpha))
    x0 = alpha * torch.clamp(c, min=1e-3) ** 3
    x0 = torch.clamp(x0, min=1e-30)
    y = torch.log(x0)
    lgam = torch.lgamma(alpha)
    for _ in range(n_newton):
        x = torch.exp(y)
        f = _gammainc(alpha, x) - p
        # d/dy gammainc(a, e^y) = pdf(e^y) * e^y
        logpdf_y = alpha * y - x - lgam
        step = f * torch.exp(-logpdf_y)
        y = y - torch.clamp(step, -2.0, 2.0)
    return torch.exp(y)


def _erfinv_approx(x):
    """Inverse error function (Giles 2010 polynomial), adequate as a
    Newton starting point."""
    w = -torch.log(torch.clamp((1.0 - x) * (1.0 + x), min=1e-30))
    w_small = w - 2.5
    p_small = 2.81022636e-08
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164,
              0.246640727, 1.50140941):
        p_small = p_small * w_small + c
    w_big = torch.sqrt(torch.clamp(w, min=1e-30)) - 3.0
    p_big = -0.000200214257
    for c in (0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047,
              1.00167406, 2.83297682):
        p_big = p_big * w_big + c
    return torch.where(w < 5.0, p_small, p_big) * x


def discrete_gamma(alpha, n_cat: int, median: bool = False):
    """Return (rates [..., n_cat], probs [..., n_cat]) for the mean-one
    discrete Gamma (reference DiscreteGamma stats.c:1974).

    mean binning: r_k = K * (P(a+1, q_{k+1}) - P(a+1, q_k)) with q_k
    the shape-a unit-scale quantiles at k/K; median binning: scaled
    bin medians.  Rates are renormalized to mean exactly 1.
    """
    alpha = _f64(alpha)
    K = n_cat
    lead = tuple(alpha.shape)
    probs = torch.full(lead + (K,), 1.0 / K, dtype=_F64)
    if K == 1:
        return torch.ones(lead + (1,), dtype=_F64), probs
    a = alpha[..., None]
    if median:
        qs = gamma_icdf(
            (2.0 * torch.arange(K, dtype=_F64) + 1.0) / (2.0 * K), a)
        rates = qs / a
    else:
        cuts = gamma_icdf(torch.arange(1, K, dtype=_F64) / K, a)
        cum = _gammainc(a + 1.0, cuts)
        cum = torch.cat([torch.zeros(lead + (1,), dtype=_F64), cum,
                         torch.ones(lead + (1,), dtype=_F64)], dim=-1)
        rates = K * torch.diff(cum, dim=-1)
    rates = rates / torch.sum(rates * probs, dim=-1, keepdim=True)
    return rates, probs


def freerate_normalize(raw_rates, raw_weights):
    """FreeRate model (reference: ras->free_mixt_rates, Update_RAS
    models.c:700-740): softmax weights, rates scaled so the weighted
    mean rate is 1."""
    w = torch.softmax(_f64(raw_weights), dim=-1)
    r = torch.exp(_f64(raw_rates))
    r = r / torch.sum(w * r, dim=-1, keepdim=True)
    return r, w


# NOTE: the +I invariant fraction is NOT folded into the class rates in
# the reference (gamma rates keep mean 1 regardless of pinv); it enters
# only in the root likelihood mix:
#   L_site = (1 - pinv) * sum_c w_c L_c + pinv * pi[invar_state]
# (lk.c:820-837).  The likelihood engine implements exactly that.
