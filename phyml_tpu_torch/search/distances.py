"""ML pairwise distances, all pairs at once.

PyTorch port of phyml_tpu/search/distances.py.  The reference computes
per-pair ML distances with a host Brent loop (ML_Dist lk.c:1783 ->
Opt_Dist_F optimiz.c:1958 -> Lk_Dist lk.c:2416), building for each
pair a joint state-count matrix F[ns, ns] so the two-sequence
likelihood is a dot product: lnL(t) = sum_xy F_xy log(pi_x sum_c w_c
P_xy(t r_c)).  Pairs are independent, so here all n(n-1)/2 pairs run
together on the engine's device: F is one product over patterns per
chunk of pairs, the optimizer a log-spaced grid scan refined by
vectorized Newton.

Ambiguity handling follows the reference (lk.c:1852-1860): site pairs
where either sequence is ambiguous (gap, N, partial codes) are
excluded from F entirely.  Rate-across-site classes are disabled for
distance estimation, also matching the reference (lk.c:1817-1824).

Memory: only the pairs i < j are formed, a chunk at a time, and the
grid and the Newton steps run pair chunk by pair chunk, so no tensor
larger than F [n_pairs, ns, ns] and one chunk's temporaries is alive.
"""

from __future__ import annotations

import numpy as np
import torch

DIST_MIN = 1e-8
DIST_MAX = 2.0  # utilities.h:351
_GRID = 64
_NEWTON = 25
# bytes of one chunk's temporaries (the gathered rows of the pair
# counts; [chunk, ns, ns] tensors in the grid and Newton steps)
_CHUNK_BYTES = 256 << 20


def _pair_chunks(n_pairs: int, per_pair_bytes: int):
    step = max(1, _CHUNK_BYTES // max(per_pair_bytes, 1))
    for lo in range(0, n_pairs, step):
        yield lo, min(lo + step, n_pairs)


def _all_pair_counts(tips, weights):
    """F [n_pairs, ns, ns] joint weighted state counts for all pairs
    (i < j, row-major), counting only site pairs where BOTH sequences
    have a single definite state (reference: Assign_State > -1 check,
    lk.c:1852-1860).  tips: [n_otu, ns, P]; weights: [P]."""
    n, ns, P = tips.shape
    definite = (torch.sum(tips > 0, dim=1) == 1).to(tips.dtype)
    t = tips * definite[:, None, :]
    tw = t * weights.to(tips.dtype)[None, None, :]
    iu = torch.triu_indices(n, n, offset=1, device=tips.device)
    F = tips.new_empty((iu.shape[1], ns, ns))
    for lo, hi in _pair_chunks(iu.shape[1], 2 * ns * P *
                               tips.element_size()):
        F[lo:hi] = torch.einsum("kxp,kyp->kxy", tw[iu[0, lo:hi]],
                                t[iu[1, lo:hi]])
    return F


def _log_site(lam, V, Vinv, pi, t):
    """log(max(pi_x P_xy(t), 1e-300)) [..., ns, ns] of the single
    unit-rate class, t [...]."""
    from phyml_tpu_torch.models.eigen import pmat

    P = pmat(lam, V, Vinv, t.reshape(-1, 1))[:, 0]
    site = pi[0][:, None] * P
    return torch.log(torch.clamp(site, min=1e-300)).reshape(
        t.shape + site.shape[-2:])


def _grid_start(F, lam, V, Vinv, pi, grid):
    """For each pair the grid point of highest lnL (the first of equal
    ones).  Every pair shares a grid point's P(t), so one [ns, ns]
    matrix serves all pairs at that point."""
    best = torch.full((F.shape[0],), -torch.inf, dtype=torch.float64,
                      device=F.device)
    arg = torch.zeros(F.shape[0], dtype=torch.long, device=F.device)
    for g in range(grid.shape[0]):
        ll = torch.einsum("nxy,xy->n", F, _log_site(lam, V, Vinv, pi,
                                                    grid[g]))
        better = ll > best
        best = torch.where(better, ll.double(), best)
        arg = torch.where(better, g, arg)
    return grid[arg]


def _pair_grad(F, lam, V, Vinv, pi, t):
    """d lnL_k / d t_k [n_pairs]: sum_xy F_xy P'_xy / P_xy with
    P' = V diag(lam e^{lam t}) V^-1, zero where P(t) sits at the pmat
    floor or pi P(t) at the 1e-300 log floor (the clamps' own
    derivative)."""
    elt = torch.exp(lam[0][None, :] * t[:, None])           # [n, ns]
    p = torch.einsum("xi,ni,iy->nxy", V[0], elt, Vinv[0])
    dp = torch.einsum("xi,ni,iy->nxy", V[0], lam[0][None, :] * elt,
                      Vinv[0])
    floor = 1e-100 if p.dtype == torch.float64 else 1e-30
    pc = torch.clamp(p, min=floor)
    ok = (p > floor) & (pi[0][:, None] * pc > 1e-300)
    return torch.sum(torch.where(ok, F * dp / pc, 0.0), dim=(1, 2))


def _refine(F, lam, V, Vinv, pi, t0):
    """Newton refinement with secant curvature, vectorized over pairs
    (each pair's step reads only its own derivative, so the pairs run
    in chunks)."""
    out = torch.empty_like(t0)
    eps = 1e-5
    for lo, hi in _pair_chunks(F.shape[0], 4 * F.shape[1] * F.shape[2] *
                               F.element_size()):
        Fc, t = F[lo:hi], t0[lo:hi]
        for _ in range(_NEWTON):
            d1 = _pair_grad(Fc, lam, V, Vinv, pi, t)
            d2e = (_pair_grad(Fc, lam, V, Vinv, pi, t + eps) - d1) / eps
            step = d1 / torch.where(d2e < 0, -d2e, 1.0)
            tn = torch.where(d2e < -1e-12, t + step,
                             torch.where(d1 > 0, t * 1.5, t / 1.5))
            tn = torch.minimum(torch.maximum(tn, t / 2.0), t * 2.0)
            t = torch.clamp(tn, DIST_MIN, DIST_MAX).to(t.dtype)
        out[lo:hi] = t
    return out


def ml_pairwise_distances(engine, params, weights=None) -> np.ndarray:
    """Full symmetric [n_otu, n_otu] ML distance matrix (float64 numpy),
    computed on the engine's device in its dtype."""
    # single unit-rate class (reference disables gamma, lk.c:1817-1824)
    lam, V, Vinv, pi, _, _ = engine.model.class_system(
        {k: torch.as_tensor(v).detach().to("cpu", torch.float64)
         for k, v in params.items()}, fold_rates=False)

    def c(x):
        return x[:1].to(engine.device, engine.dtype).contiguous()

    lam, V, Vinv, pi = c(lam), c(V), c(Vinv), c(pi)
    F = engine._sum_sites(_all_pair_counts(engine.tips,
                                           engine._w(weights)))

    # grid scan (log-spaced) for a robust start
    grid = torch.as_tensor(
        np.logspace(np.log10(1e-4), np.log10(DIST_MAX), _GRID),
        dtype=engine.dtype, device=engine.device)
    t0 = _grid_start(F, lam, V, Vinv, pi, grid)
    t_hat = _refine(F, lam, V, Vinv, pi, t0).double().cpu().numpy()
    n = engine.n_otu
    D = np.zeros((n, n))
    iu = np.triu_indices(n, k=1)
    D[iu] = t_hat
    return D + D.T
