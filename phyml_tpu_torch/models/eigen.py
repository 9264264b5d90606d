"""Reversible-Q eigendecomposition and batched P(t).

For reversible models B = D^{1/2} Q D^{-1/2} with D = diag(pi) is
symmetric, so `torch.linalg.eigh` gives an orthogonal eigenbasis U
with real eigenvalues, and
    V = D^{-1/2} U,   V^{-1} = U^T D^{1/2},   Q = V diag(lam) V^{-1}.
This is batchable over mixture components and parameter grids and
has no failure path (the reference instead runs a nonsymmetric QR
solver with a retry loop, eigen.c:43, models.c:954-993).

P(t) = V exp(diag(lam * t)) V^{-1}  (reference PMat_Empirical
models.c:257), batched over (edge, class) in a single einsum.
"""

from __future__ import annotations

import torch


def reversible_eigen(S, pi, normalize: bool = True):
    """Return (lam [..., ns], V [..., ns, ns], Vinv [..., ns, ns])
    such that Q = V diag(lam) Vinv with mean rate 1 (normalize=False
    skips the mean-rate scaling)."""
    ns = S.shape[-1]
    eye = torch.eye(ns, dtype=S.dtype)
    pi = torch.clamp(pi, min=1e-12)
    off = S * pi[..., None, :] * (1.0 - eye)
    diag = -torch.sum(off, dim=-1)
    if normalize:
        mr = -torch.sum(pi * diag, dim=-1)[..., None]
    else:
        mr = torch.ones_like(pi[..., :1])
    sqrt_pi = torch.sqrt(pi)
    # B = D^{1/2} Q D^{-1/2}; built directly from off/diag (symmetric).
    b_off = off * (sqrt_pi[..., :, None] / sqrt_pi[..., None, :])
    b = b_off + torch.diag_embed(diag)
    lam, u = torch.linalg.eigh(b)
    v = u / sqrt_pi[..., :, None]
    vinv = torch.swapaxes(u, -1, -2) * sqrt_pi[..., None, :]
    return lam / mr, v, vinv


def pmat(lam, v, vinv, t):
    """Batched P(t) = V exp(lam t) V^{-1}.

    lam, v, vinv: per-class eigensystem [..., C, ns], [..., C, ns, ns]
    (any leading batch shape).
    t: branch "time" per (node, class) [..., N, C] (class rate already
    folded into lam by the caller).
    Returns P [..., N, C, ns, ns] with rows summing to 1.

    Entries are clamped to a small positive floor: eigendecomposition
    roundoff can give tiny negative values, which would otherwise feed
    sign flips into the CLV recursion (the reference clamps to
    SMALL_PIJ = 1e-100, models.c:293).  On a CUDA device the caller
    keeps TF32 off: a reduced-precision P is a ~1e-3 per-site error.
    """
    elt = torch.exp(lam[..., None, :, :] * t[..., :, :, None])
    p = torch.einsum("...cxi,...nci,...ciy->...ncxy", v, elt, vinv)
    floor = 1e-100 if p.dtype == torch.float64 else 1e-30
    return torch.clamp(p, min=floor)


def mgf_rates(lam, sigma):
    """Eigenvalues of the branch-length-integrated P: with each branch
    length Gamma-distributed of mean t and variance t*sigma, E[P(L)] =
    V diag(exp(mu t)) V^{-1} with mu = -log(1 - lam*sigma)/sigma, an
    exponential family in t again (reference PMat_MGF_Gamma
    models.c:1044).  sigma <= 1e-12 keeps lam (plain P(t)); the base
    1 - lam*sigma is floored at 1e-30, as phyml_tpu's
    pmat_mgf_gamma."""
    sig = torch.clamp(torch.as_tensor(sigma, dtype=lam.dtype,
                                      device=lam.device), min=0.0)
    base = torch.clamp(1.0 - lam * sig, min=1e-30)  # lam <= 0: base >= 1
    mu = -torch.log(base) / torch.clamp(sig, min=1e-12)
    return torch.where(sig > 1e-12, mu, lam)


def pmat_mgf_gamma(lam, v, vinv, t, sigma):
    """Branch-length-integrated P: E[P(L)] with L ~ Gamma of mean t
    and variance t*sigma (reference PMat_MGF_Gamma models.c:1044,
    called with mean = l*r_c, var = l*sigma*r_c^2, lk.c:2296-2323 —
    the Guindon 2012 relaxed-clock model).  With the class rate folded
    into lam (as in `pmat`), the reference's
    (1 - lam*var/mean)^(-mean^2/var) reduces to
    exp(t * mgf_rates(lam, sigma)), so this is `pmat` at those
    eigenvalues.  t: [..., N, C]; sigma: scalar."""
    return pmat(mgf_rates(lam, sigma), v, vinv, t)
