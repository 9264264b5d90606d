"""Coordinate-ascent parameter optimization (Round_Optimize).

Mirrors the reference's outer loop (optimiz.c:669 Round_Optimize:
alternate branch-length optimization with model-parameter
optimization until the gain stalls) and its per-parameter Brent
searches (Optimiz_All_Free_Param optimiz.c:962).  Parameter bounds
follow utilities.h: TSTV in [0.05, 100], ALPHA in [0.01, 1000],
PINV in [1e-5, 0.99999], RR in [1e-4, 1e4].

Positive parameters are searched in log space; pinv in logit space;
FreeRate raws and frequency logits unconstrained.  The joint grid-zoom
line search is a host loop over zoom levels; each level scores all
its parameter variants as one batch (batched eigensystems, batched
P-matrices, one batched K3 launch).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from phyml_tpu_torch.optim.blen import optimize_branch_lengths
from phyml_tpu_torch.utils import trace


def _logit(p):
    return math.log(p / (1.0 - p))


def _inv_logit(x):
    return 1.0 / (1.0 + math.exp(-x))


def free_scalar_slots(model, params):
    """List of (name, index_or_None, transform, lo, hi) search slots.
    transform maps the searched variable -> parameter value."""
    slots = []
    exp = math.exp
    if model.optimize_kappa and "kappa" in params:
        slots.append(("kappa", None, exp,
                      math.log(0.05), math.log(100.0)))
    if model.optimize_kappa and "lambda" in params:
        slots.append(("lambda", None, exp,
                      math.log(0.01), math.log(100.0)))
    if model.optimize_rr and "rr_val" in params:
        n_rr = int(params["rr_val"].shape[0])
        # last rate is the normalizer (G<->T for GTR); keep it fixed
        for i in range(n_rr - 1):
            slots.append(("rr_val", i, lambda x: x,
                          math.log(1e-4), math.log(1e4)))
    if model.optimize_alpha and "alpha" in params:
        slots.append(("alpha", None, exp,
                      math.log(0.01), math.log(1000.0)))
    if model.optimize_pinv and "pinv" in params:
        slots.append(("pinv", None, _inv_logit,
                      _logit(1e-5), _logit(0.99)))
    if "class_rates_raw" in params:
        n = int(params["class_rates_raw"].shape[0])
        for i in range(n):
            slots.append(("class_rates_raw", i, lambda x: x, -7.0, 7.0))
        for i in range(n - 1):
            # weights are softmax-normalized; fix the last logit
            slots.append(("class_weights_raw", i, lambda x: x,
                          -9.0, 9.0))
    if "il_sigma" in params:
        # IL branch-length variance, stored as log(sigma)
        slots.append(("il_sigma", None, lambda x: x,
                      math.log(1e-4), math.log(100.0)))
    if "freqs_raw" in params:
        n = int(params["freqs_raw"].shape[0])
        for i in range(n - 1):
            slots.append(("freqs_raw", i, lambda x: x, -9.0, 9.0))
    if getattr(model, "covarion", False) and model.optimize_cov:
        # Optimize_M4mod bounds: delta in [0.01, 10] (optimiz.c:1016),
        # covarion alpha in [0.01, 10] (:1087), free multipliers and
        # class freqs in [0.1, 100] (:1047/:1068)
        if "cov_delta" in params:
            slots.append(("cov_delta", None, exp,
                          math.log(0.01), math.log(10.0)))
        if "cov_alpha" in params:
            slots.append(("cov_alpha", None, exp,
                          math.log(0.01), math.log(10.0)))
        if "cov_multipl_raw" in params:
            for i in range(model.n_hidden):
                slots.append(("cov_multipl_raw", i, exp,
                              math.log(0.1), math.log(100.0)))
            for i in range(model.n_hidden):
                slots.append(("cov_h_fq_raw", i, exp,
                              math.log(0.1), math.log(100.0)))
    return slots


def _get(params, name, idx):
    v = params[name]
    return float(v) if idx is None else float(v[idx])


def _set(params, name, idx, value):
    """New dict with one value replaced (never written in place, so
    the engine's caches stay valid)."""
    p = dict(params)
    if idx is None:
        p[name] = torch.as_tensor(value, dtype=torch.float64)
    else:
        v = params[name].clone()
        v[idx] = value
        p[name] = v
    return p


def _x0_of(tf, cur):
    if tf is math.exp:
        return math.log(max(cur, 1e-12))
    if tf is _inv_logit:
        return _logit(min(max(cur, 1e-6), 1.0 - 1e-6))
    return cur


def _apply_tf(tf, x: np.ndarray) -> np.ndarray:
    if tf is math.exp:
        return np.exp(x)
    if tf is _inv_logit:
        return 1.0 / (1.0 + np.exp(-x))
    return x


def _batched_params(params, slots, S: np.ndarray) -> dict:
    """Params with a leading batch axis: row b sets slot j to
    tf_j(S[b, j]), the other parameters stay as they are."""
    B = S.shape[0]
    p = dict(params)
    for j, (name, idx, tf, lo, hi) in enumerate(slots):
        v = torch.as_tensor(_apply_tf(tf, S[:, j]), dtype=torch.float64)
        if idx is None:
            p[name] = v
        else:
            if p[name].dim() == params[name].dim():   # not yet batched
                p[name] = params[name].expand(B, -1).clone()
            p[name][:, idx] = v
    return p


@trace.traced("round.scalars")
def optimize_scalars(engine, model, params, tree, lnl0=None,
                     brent_tol: float = 1e-4, weights=None,
                     grid: int = 12, zooms: int = 16):
    """Joint line search over ALL free scalars; returns (params, lnL).

    Every slot's `grid` candidate values (plus the current value) are
    scored as one batch, per-slot winners are applied jointly with a
    single-best fallback guard, and the per-slot brackets shrink
    around their best grid points until the bracket step drops below
    brent_tol (the reference's per-parameter Brent searches,
    Generic_Brent_Lk optimiz.c:2475, all parameters jointly)."""
    slots = free_scalar_slots(model, params)
    lnl = float(trace.to_host(engine.loglik(params, tree, weights),
                              "round.lnl")) if lnl0 is None else lnl0
    if not slots:
        return params, lnl
    n = len(slots)

    def lnl_of(S):
        trace.count("round.probe_rows", S.shape[0])
        sys = engine._system(_batched_params(params, slots, S))
        vals = trace.to_host(engine.loglik_batch(sys, tree, weights),
                             "round.probes").numpy()
        return np.where(np.isfinite(vals), vals, -np.inf)

    lo = np.asarray([sl[3] for sl in slots])
    hi = np.asarray([sl[4] for sl in slots])
    a, b = lo.copy(), hi.copy()
    s_cur = np.asarray([_x0_of(tf, _get(params, name, idx))
                        for name, idx, tf, _, _ in slots])
    zoom = 0
    while zoom < zooms and np.max((b - a) / (grid - 1)) >= brent_tol:
        trace.count("round.zooms")
        with trace.span("round.zoom"):
            step = (b - a) / (grid - 1)
            # candidate matrix [n, grid+1]: linspace + current
            xs = a[:, None] + step[:, None] * np.arange(grid)[None, :]
            xs = np.concatenate([xs, s_cur[:, None]], axis=1)
            # variant s-vectors: slot j takes xs[j, k], others current
            svar = np.broadcast_to(s_cur, (n, grid + 1, n)).copy()
            for j in range(n):
                svar[j, :, j] = xs[j]
            vals = lnl_of(svar.reshape(n * (grid + 1), n))
            vals = vals.reshape(n, grid + 1)
            k_best = np.argmax(vals, axis=1)
            best_val = vals[np.arange(n), k_best]
            best_x = xs[np.arange(n), k_best]
            improved = best_val > lnl + 1e-9
            if improved.any():
                s_joint = np.where(improved, best_x, s_cur)
                i_star = int(np.argmax(np.where(improved, best_val, -np.inf)))
                s_single = s_cur.copy()
                s_single[i_star] = best_x[i_star]
                pair = lnl_of(np.stack([s_joint, s_single]))
                if pair[0] >= pair[1] and pair[0] > lnl:
                    s_cur, lnl = s_joint, float(pair[0])
                elif pair[1] > lnl:
                    s_cur, lnl = s_single, float(pair[1])
            # shrink every bracket around its best grid point
            a = np.maximum(lo, best_x - step)
            b = np.minimum(hi, best_x + step)
            zoom += 1
    for j, (name, idx, tf, lo_, hi_) in enumerate(slots):
        params = _set(params, name, idx, tf(float(s_cur[j])))
    return params, lnl


def round_optimize(
    engine,
    model,
    params,
    tree,
    opt_blen: bool = True,
    opt_params: bool = True,
    tol: float = 1e-3,
    max_rounds: int = 20,
    blen_tol: float = 1e-4,
    verbose: bool = False,
    weights=None,
):
    """Alternate branch-length and model-parameter optimization until
    a full round gains < tol log units (Round_Optimize optimiz.c:669).
    Returns (params, tree, lnL)."""
    lnl = float(trace.to_host(engine.loglik(params, tree, weights),
                              "round.lnl"))
    for it in range(max_rounds):
        start = lnl
        trace.count("round.rounds")
        with trace.span("round.round"):
            if opt_blen:
                tree, lnl = optimize_branch_lengths(
                    engine, params, tree, tol=blen_tol, weights=weights
                )
            if opt_params:
                params, lnl = optimize_scalars(engine, model, params, tree,
                                               lnl0=lnl, weights=weights)
        if verbose:
            print(f"  round {it}: lnL {lnl:.5f}")
        if lnl - start < tol:
            break
    return params, tree, lnl
