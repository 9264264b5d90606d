"""Covarion (M4) model: Markov-modulated substitution process.

PyTorch port of phyml_tpu/models/covarion.py.  The reference builds
one big (n_o * n_h)^2 rate matrix (M4_Update_Qmat m4.c:324-523): n_h
hidden rate classes, each scaling the observed substitution process by
a multiplier, plus a switching process between hidden classes (rate
delta) that leaves the observed state unchanged.  States are indexed
s = h * n_o + o (m4.c:408-409).  Construction:

  * diagonal blocks (observed substitutions within hidden class h):
    the base model's generic Q (exchangeabilities x freqs, mean rate 1
    under o_fq: Update_Qmat_Generic models.c:430) times multipl[h],
    then globally rescaled so the expected number of OBSERVED
    substitutions per unit branch length is 1 (m4.c:463-474) - the
    switching events do not count toward branch length;
  * off-diagonal blocks (hidden-class switches, same observed state):
    delta * h_fq[h'] / mr_h with mr_h = 1 - sum h_fq^2 (the generic
    normalization of the all-ones switch exchangeabilities,
    m4.c:479-504);
  * stationary distribution pi[s] = o_fq[o] * h_fq[h] (m4.c:408).

The big Q is reversible w.r.t. that pi, so it is expressed as a
symmetric exchangeability matrix S_big (Q = S_big o pi_big off the
diagonal) built from two Kronecker products, and decomposed by the
pi-symmetrized `eigh` path (models/eigen.py) with the mean-rate
normalization DISABLED (the M4 normalization above already happened
and is intentionally partial).

Hidden-class multipliers (m4.c:338-396):
  * 'fixed'  (plain --cov):  multipl = [0, 1, ..., n_h-1], h_fq uniform
    (M4_Init_Model init.c:6415-6436) - class 0 is an "off" state;
  * 'alpha'  (--cov_alpha):  multipl = DiscreteGamma(cov_alpha) rates,
    h_fq uniform (m4.c:339-343);
  * 'free'   (--cov_free):   free h_fq (clipped to [0.01,0.99] and
    renormalized, m4.c:352-363) and free multipliers rescaled so
    sum h_fq*multipl = 1 (m4.c:365-370).

Every function takes float64 tensors with an optional leading batch
shape (the line search's parameter grid) and carries it through.
"""

from __future__ import annotations

import torch

from phyml_tpu_torch.models.rates import discrete_gamma

_F64 = torch.float64


def _kron(a, b):
    """Kronecker product of the last two axes, batched over the rest."""
    n, m = a.shape[-2:]
    p, q = b.shape[-2:]
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(*out.shape[:-4], n * p, m * q)


def m4_hidden_free(h_fq_raw, multipl_raw):
    """The reference's --cov_free reparameterization (m4.c:344-396):
    returns (h_fq, multipl) with h_fq in [0.01, 0.99] summing to 1 and
    sum(h_fq * multipl) == 1."""
    h = torch.abs(h_fq_raw)
    h = h / torch.sum(h, dim=-1, keepdim=True)
    # the reference's clip-renormalize do-while converges in a couple
    # of iterations; phyml_tpu unrolls a fixed count of four
    for _ in range(4):
        h = torch.clamp(h, 0.01, 0.99)
        h = h / torch.sum(h, dim=-1, keepdim=True)
    m = torch.abs(multipl_raw)
    m = multipl_raw / torch.sum(m * h, dim=-1, keepdim=True)
    return h, m


def m4_exchangeabilities(E, o_fq, h_fq, multipl, delta):
    """Big-state symmetric exchangeabilities + stationary frequencies.

    E       [..., n_o, n_o]  symmetric observed-state exchangeabilities
    o_fq    [..., n_o]       observed-state frequencies
    h_fq    [..., n_h]       hidden-class frequencies
    multipl [..., n_h]       hidden-class rate multipliers
    delta   [...]            switching rate

    Returns (S_big [..., ns, ns], pi_big [..., ns]) with ns = n_h * n_o
    such that Q_ij = S_big_ij * pi_big_j (i != j, diagonal = -rowsum, NO
    further normalization) reproduces M4_Update_Qmat exactly.
    """
    n_o = E.shape[-1]
    n_h = h_fq.shape[-1]
    eye_o = torch.eye(n_o, dtype=E.dtype)

    # mean rate of the base observed block under o_fq (the generic
    # normalization, models.c:470-479)
    q_off = E * o_fq[..., None, :] * (1.0 - eye_o)
    mr_o = torch.sum(o_fq[..., :, None] * q_off, dim=(-2, -1))

    # global observed-substitution rate across hidden classes
    # (m4.c:465-471 reduces to this because each block has mean 1)
    mr = torch.sum(h_fq * multipl, dim=-1)

    # switch-matrix normalization (generic with all-ones rr)
    mr_h = 1.0 - torch.sum(h_fq * h_fq, dim=-1)

    # Q same-h block: (E/mr_o) * o_fq[j] * multipl[h] / mr
    #   = S_big * pi_big[j] with pi_big[j] = h_fq[h] * o_fq[o_j]
    #   -> S_big = E * multipl[h] / (mr_o * h_fq[h] * mr)
    diag_part = _kron(
        torch.diag_embed(multipl / (h_fq * mr[..., None])),
        E / mr_o[..., None, None])
    # Q switch entry (same o): delta * h_fq[h'] / mr_h
    #   -> S_big = delta / (mr_h * o_fq[o])
    switch_part = _kron(
        (1.0 - torch.eye(n_h, dtype=E.dtype)).expand(
            *delta.shape, n_h, n_h),
        torch.diag_embed(delta[..., None]
                         / (mr_h[..., None] * o_fq)))
    S_big = diag_part + switch_part
    pi_big = h_fq[..., :, None] * o_fq[..., None, :]
    return S_big, pi_big.reshape(*pi_big.shape[:-2], n_h * n_o)


def m4_hidden_system(model, params):
    """(h_fq, multipl) [..., n_h] from the model's covarion mode and
    params."""
    n_h = model.n_hidden
    if model.cov_mode == "free":
        return m4_hidden_free(torch.as_tensor(params["cov_h_fq_raw"],
                                              dtype=_F64),
                              torch.as_tensor(params["cov_multipl_raw"],
                                              dtype=_F64))
    if model.cov_mode == "alpha":
        multipl, h_fq = discrete_gamma(params["cov_alpha"], n_h)
        return h_fq, multipl
    # 'fixed': M4_Init_Model defaults (init.c:6433-6436)
    h_fq = torch.full((n_h,), 1.0 / n_h, dtype=_F64)
    multipl = torch.arange(n_h, dtype=_F64)
    return h_fq, multipl
