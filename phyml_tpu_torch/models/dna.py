"""Nucleotide substitution models as symmetric exchangeabilities.

Every reversible DNA model is expressed as Q_ij = S_ij * pi_j with a
symmetric exchangeability matrix S, normalized to mean rate 1
(-sum_i pi_i Q_ii = 1), exactly the construction of the reference's
Update_Qmat_HKY / Update_Qmat_TN93 / Update_Qmat_GTR
(models.c:549/588/487).  Every model goes through the pi-symmetrized
eigendecomposition (models/eigen.py).

Parameters may carry a leading batch shape (a parameter grid scored
in one call); S then gains the same leading shape.

Model ids mirror utilities.h:385-392.
"""

from __future__ import annotations

import numpy as np
import torch

# index pairs for the 6 unordered rates in reference order
# (rr_num order, models.c:487): AC AG AT CG CT GT
RR_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _symmetric(entries) -> torch.Tensor:
    """[..., 4, 4] of ones with S[i, j] = S[j, i] = v for each
    ((i, j), v); the leading shape is the broadcast of the values'."""
    vals = [torch.as_tensor(v, dtype=torch.float64) for _, v in entries]
    lead = torch.broadcast_shapes(*(v.shape for v in vals)) if vals \
        else ()
    S = torch.ones(*lead, 4, 4, dtype=torch.float64)
    for ((i, j), _), v in zip(entries, vals):
        S[..., i, j] = v
        S[..., j, i] = v
    return S


def exchangeabilities(model: str, params: dict, custom_map=None):
    """Symmetric S [..., 4, 4] (diagonal irrelevant).

    params may contain 'kappa' (ts/tv multiplier), 'lambda'
    (TN93 purine/pyrimidine transition ratio), 'rr' ([..., 6] or
    [..., n_classes] GTR/custom relative rates).
    """
    model = model.upper()
    if model in ("JC69", "F81"):
        return _symmetric([])
    if model in ("K80", "HKY85"):
        kappa = params["kappa"]
        return _symmetric([((0, 2), kappa), ((1, 3), kappa)])
    if model == "TN93":
        kappa, lam = params["kappa"], params["lambda"]
        return _symmetric([((0, 2), kappa * lam), ((1, 3), kappa)])
    if model == "F84":
        # reference: PMat_TN93 with kappa2 = 2k/(1+lambda),
        # kappa1 = kappa2*lambda, lambda from Get_Lambda_F84
        # (models.c:105-114, :173)
        kappa, lam = params["kappa"], params["lambda"]
        kappa2 = kappa * 2.0 / (1.0 + lam)
        kappa1 = kappa2 * lam
        return _symmetric([((0, 2), kappa1), ((1, 3), kappa2)])
    if model in ("GTR", "CUSTOM"):
        rr = params["rr"]
        if custom_map is not None:
            rr = rr[..., custom_map]  # expand rate classes -> 6 rates
        return _symmetric([(pair, rr[..., k])
                           for k, pair in enumerate(RR_PAIRS)])
    raise ValueError(f"unknown DNA model {model!r}")


def parse_custom_string(s: str) -> tuple[np.ndarray, int]:
    """Reference Translate_Custom_Mod_String (models.c:628): a 6-char
    string like '012210' groups the 6 GTR rates into shared classes.
    Returns (map [6] -> class index, n_classes)."""
    if len(s) != 6:
        raise ValueError("custom model string must have 6 characters")
    classes: dict[str, int] = {}
    idx = np.zeros(6, dtype=np.int32)
    for i, ch in enumerate(s):
        if ch not in classes:
            classes[ch] = len(classes)
        idx[i] = classes[ch]
    return idx, len(classes)
