"""Cross-validation for model selection (reference: cv.c).

Port of phyml_tpu/ops/crossval.py.  Three modes, mirroring the
reference's cv_type values (xml.c:506-520):

  * tip / "maxfold" leave-one-out (CV_Tip_Cv cv.c:15): for every
    (taxon, site) cell, the predictive distribution of that tip state
    given ALL other data.  The outside partial out[tip] (the engine's
    _down_pass) never includes the tip's own data, so the leave-one-out
    predictive probabilities for EVERY cell fall out of ONE down pass
    on the engine's device:
        pred[u, x, p] ~ sum_c w_c (out[u,c]^T P_c(t_u))[x, p].
    (The reference's per-cell re-optimization of the tip branch length,
    an O(1/n_sites) effect, cv.c:70, is omitted, as in phyml_tpu.)

  * kfold.col (CV_Hide_Align_At_Random_Col cv.c:213): mask whole
    columns, refit on the rest (round_optimize with the fold's
    pattern weights zeroed: no data copies), score the summed
    predictive site log-likelihood at the masked columns
    (CV_Score_At_Hidden_Cols cv.c:442).

  * kfold.pos (CV_Hide_Align_At_Random_Pos cv.c:151 /
    _One_Per_Site cv.c:185): mask individual cells; scoring uses the
    tip-CV predictive distribution restricted to the masked cells,
    with the model refit on the masked alignment's own engine.

Folds and masked cells come from numpy draws made with phyml_tpu's
calls in its order, so one seed gives phyml_tpu's folds and cells.
ROC points (reference ROC in stats.c, printed as ###model,tax,...)
are returned as arrays for the caller to write.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from phyml_tpu_torch.optim.round import round_optimize


@torch.no_grad()
def tip_predictive_probs(engine, params, tree):
    """[n_otu, P, ns_obs] float64 leave-one-out predictive state
    probabilities for every tip cell (CV_Tip_Cv cv.c:74-99, batched),
    on the host."""
    lam, V, Vinv, pi, w, pinv = engine._system(params)
    child = torch.as_tensor(tree.child)
    pmats = engine._pmats(lam, V, Vinv,
                          tree.blen.to(engine.device, engine.dtype))
    pup, clv, sc = engine._up_pass(pmats, child)
    out, sc_out = engine._down_pass(pmats, child, pup, sc, pi)
    n = engine.n_otu
    # (out^T P)[x]: likelihood of the rest of the data if tip u's
    # state were x (site likelihood = out^T P clv, and a bare tip has
    # clv = e_x).  The class mix uses the per-class scales.
    ext = torch.einsum("uczp,uczx->ucxp", out[:n], pmats[:n])
    m = torch.amax(sc_out[:n], dim=1, keepdim=True)      # [n,1,P]
    cw = w[None, :, None] * torch.exp(sc_out[:n] - m)    # [n,C,P]
    pred = torch.einsum("ucp,ucxp->uxp", cw, ext)
    pred = torch.clamp(pred, min=engine._tiny)
    pred = pred / torch.sum(pred, dim=1, keepdim=True)
    probs = pred.permute(0, 2, 1).to("cpu", torch.float64).numpy()
    ns_obs = engine.aln.partials.shape[-1]
    probs = probs[:, : engine.aln.n_patterns, :]
    if probs.shape[-1] != ns_obs:
        # covarion: predictive distribution over observed states is
        # the hidden-marginalized one
        n_h = probs.shape[-1] // ns_obs
        probs = probs.reshape(probs.shape[0], probs.shape[1],
                              n_h, ns_obs).sum(axis=2)
    return probs


def tip_cv(engine, params, tree):
    """Leave-one-out CV over all unambiguous tip cells.

    Returns dict with:
      probs   [n_otu, P, ns]  predictive state probabilities
      truth   [n_otu, P]      observed state index (-1 = ambiguous)
      logpred [n_otu, P]      log predictive prob of the truth
      score   float           weighted mean log predictive probability
                              (the model-selection criterion)
    """
    aln = engine.aln
    probs = tip_predictive_probs(engine, params, tree)
    tips = aln.partials                       # [n_otu, P, ns]
    unamb = tips.sum(axis=-1) == 1.0          # exactly one state
    truth = np.where(unamb, tips.argmax(axis=-1), -1)

    safe = np.maximum(truth, 0)
    logpred = np.log(
        np.take_along_axis(probs, safe[..., None], axis=-1)[..., 0]
    )
    logpred = np.where(unamb, logpred, 0.0)
    wts = np.asarray(aln.weights)[None, :] * unamb
    score = float((logpred * wts).sum() / wts.sum())
    return dict(probs=probs, truth=truth, logpred=logpred, score=score)


def kfold_col_cv(engine, model, params, tree, n_folds: int = 5,
                 rng=None, opt_blen: bool = True, verbose: bool = False):
    """K-fold column cross-validation (cv.c:213 + :442): patterns are
    partitioned into K folds; for each fold, refit (branch lengths +
    free scalars) with the fold's weights zeroed, then sum the
    held-out patterns' predictive site log-likelihoods.

    Returns (total heldout log-likelihood, per-fold list)."""
    rng = np.random.default_rng() if rng is None else rng
    P_raw = engine.aln.n_patterns
    fold_of = rng.integers(0, n_folds, size=P_raw)
    base_w = engine.weights.to("cpu", torch.float64).numpy()

    total = 0.0
    per_fold = []
    for k in range(n_folds):
        hide = np.zeros_like(base_w)
        hide[:P_raw] = fold_of == k
        train_w = torch.as_tensor(base_w * (1.0 - hide),
                                  device=engine.device)
        p_k, t_k, _ = round_optimize(
            engine, model, params, tree,
            opt_blen=opt_blen, opt_params=True, weights=train_w,
        )
        site = engine.site_logliks(p_k, t_k).to("cpu", torch.float64)
        held = float(np.sum(site.numpy() * base_w * hide))
        per_fold.append(held)
        total += held
        if verbose:
            print(f"  fold {k + 1}/{n_folds}: heldout lnL {held:.4f}")
    return total, per_fold


def mask_cells(aln, cells):
    """Return a copy of `aln` with the given (taxon, pattern) cells
    made fully ambiguous (CV_Hide_Align_At_Given_Pos cv.c:253)."""
    out = copy.copy(aln)
    partials = np.array(aln.partials)
    for (t, p) in cells:
        partials[t, p, :] = 1.0
    out.partials = partials
    return out


def kfold_pos_cv(engine_factory, aln, model, params, tree,
                 mask_prob: float = 0.05, rng=None,
                 opt_blen: bool = True):
    """Positional CV: mask a random subset of unambiguous cells, refit
    on the masked alignment, and score the predictive probability of
    the true states at the masked cells (cv.c:151 + :273).

    engine_factory(aln) -> LikelihoodEngine (the masked alignment
    needs its own tip tensors; the engine is dropped before this
    returns).  Returns (score, n_masked)."""
    rng = np.random.default_rng() if rng is None else rng
    unamb = aln.partials.sum(axis=-1) == 1.0
    pick = (rng.random(unamb.shape) < mask_prob) & unamb
    cells = list(zip(*np.nonzero(pick)))
    if not cells:
        return 0.0, 0
    masked = mask_cells(aln, cells)
    eng_m = engine_factory(masked)
    p_m, t_m, _ = round_optimize(eng_m, model, params, tree,
                                 opt_blen=opt_blen, opt_params=True)
    probs = tip_predictive_probs(eng_m, p_m, t_m)
    del eng_m
    truth = aln.partials.argmax(axis=-1)
    w = np.asarray(aln.weights)
    score = 0.0
    for (t, p) in cells:
        score += float(np.log(max(probs[t, p, truth[t, p]], 1e-300))
                       * w[p])
    return score, len(cells)


def roc_points(probs, truth, n_thresholds: int = 101):
    """ROC curve for the state calls (reference ROC): at threshold q,
    a (cell, state) pair is called positive when prob >= q.  Returns
    (fpr [T], tpr [T])."""
    ns = probs.shape[-1]
    flat_p = probs.reshape(-1, ns)
    ok = truth.reshape(-1) >= 0
    flat_p = flat_p[ok]
    t = truth.reshape(-1)[ok]
    is_true = np.zeros_like(flat_p, dtype=bool)
    is_true[np.arange(len(t)), t] = True

    qs = np.linspace(0.0, 1.0, n_thresholds)
    pos = flat_p[..., None] >= qs[None, None, :]     # [N, ns, T]
    tp = (pos & is_true[..., None]).sum(axis=(0, 1))
    fp = (pos & ~is_true[..., None]).sum(axis=(0, 1))
    P = is_true.sum()
    N = (~is_true).sum()
    return fp / max(N, 1), tp / max(P, 1)
