"""Substitution-model configuration and class-system construction.

A `SubstModel` is the static description (model family, number of rate
classes, what's free); `class_system(params)` turns a parameter dict
into the per-class eigensystem the likelihood engine consumes:

    lam   [..., C, ns]       eigenvalues with the class rate folded in
    V     [..., C, ns, ns]   right eigenvectors
    Vinv  [..., C, ns, ns]
    pi    [..., C, ns]       per-class stationary frequencies
    w     [..., C]           class weights
    pinv  [...]              invariant fraction (0 when disabled)

Parameters are float64 tensors.  A scalar parameter may carry a
leading batch shape [B] (a vector parameter then [B, n]): every
output gains that leading shape, which is how a parameter grid is
scored in one batched call (the counterpart of phyml_tpu's vmap).

Reference parity notes:
  * GTR rates are exp(log-rates) grouped by a 6-char custom string and
    normalized by the G<->T rate (Update_Qmat_GTR models.c:487-510).
  * Frequencies: 'empirical' (counted from data, the default for DNA),
    'model' (the empirical AA matrix's frequencies, default for AA),
    'optimize' (ML, via softmax of unconstrained logits), or 'fixed'
    user values (cl.c -f handling).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any
import numpy as np
import torch

from phyml_tpu_torch.models import dna as dna_mod
from phyml_tpu_torch.models import matrices
from phyml_tpu_torch.models.covarion import (
    m4_exchangeabilities, m4_hidden_system,
)
from phyml_tpu_torch.models.eigen import reversible_eigen
from phyml_tpu_torch.models.rates import discrete_gamma, freerate_normalize

RR_MIN, RR_MAX = 0.01, 100.0  # utilities.h clamps for GTR rates

_F64 = torch.float64
# parameters whose unbatched value is a vector (all others are scalars)
_VECTOR_PARAMS = ("rr_val", "freqs_raw", "freqs_const",
                  "class_rates_raw", "class_weights_raw",
                  "cov_h_fq_raw", "cov_multipl_raw")


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F64)


def batch_shape(params: dict) -> tuple:
    """Leading batch shape shared by the parameter values."""
    shapes = []
    for k, v in params.items():
        v = torch.as_tensor(v)
        rank = 1 if k in _VECTOR_PARAMS else 0
        shapes.append(tuple(v.shape[:v.dim() - rank]))
    return tuple(torch.broadcast_shapes(*shapes)) if shapes else ()


@dataclass
class SubstModel:
    datatype: str = "nt"              # "nt" | "aa" | "generic"
    name: str = "HKY85"
    # custom-alphabet state count (-d generic, utilities.h:303)
    generic_ns: int = 0
    n_classes: int = 4                # gamma / freerate classes
    gamma_median: bool = False
    invar: bool = False               # +I
    freerate: bool = False
    freqs_mode: str | None = None     # empirical|model|optimize|fixed
    fixed_freqs: Any = None           # np [ns] when freqs_mode == fixed
    custom_string: str = "012345"     # DNA CUSTOM grouping
    # CUSTOMAA: (S [20,20], pi [20]) numpy pair from a PAML rate file
    # (--aa_rate_file, cl.c:560-570); overrides the empirical table
    custom_aa: Any = None
    # Mixture components: list of (S [ns,ns], pi [ns]) numpy pairs.
    # When set, n_classes == len(components) and each class has its own
    # Q (LG4X-style); otherwise a single Q is shared across classes.
    components: list | None = None
    # Covarion (M4, m4.c; models/covarion.py): n_hidden rate classes
    # over the observed process; cov_mode selects the hidden-multiplier
    # parameterization ('fixed' = plain --cov, 'alpha' = --cov_alpha
    # discrete-gamma, 'free' = --cov_free free freqs+multipliers;
    # m4.c:338-396)
    covarion: bool = False
    n_hidden: int = 3
    cov_mode: str = "fixed"
    # which scalar parameters are optimized (used by the optimizer)
    optimize_kappa: bool = True
    optimize_alpha: bool = True
    optimize_pinv: bool = False
    optimize_rr: bool = True
    optimize_cov: bool = True

    def __post_init__(self):
        self.name = self.name.upper()
        if self.datatype == "generic":
            if self.generic_ns < 2:
                raise ValueError("generic datatype needs generic_ns")
            # reference: uniform state frequencies, all rates equal
            # (init.c:1519-1533)
            self.name = "GENERIC"
            self.freqs_mode = "fixed"
            self.fixed_freqs = np.full(self.generic_ns,
                                       1.0 / self.generic_ns)
        if self.freqs_mode is None:
            self.freqs_mode = "empirical"
        if self.name in ("JC69", "K80"):
            # these models fix pi = 1/4 (utilities.h model defs)
            self.freqs_mode = "fixed"
            self.fixed_freqs = np.full(4, 0.25)
        if self.covarion:
            if self.is_mixture:
                raise ValueError("covarion cannot combine with "
                                 "matrix mixtures")
            if self.n_hidden < 2:
                raise ValueError("covarion needs >= 2 hidden classes")

    # ------------------------------------------------------------------
    @property
    def obs_ns(self) -> int:
        """Observed (alphabet) states - what tips are encoded over."""
        if self.components is not None:
            return int(self.components[0][0].shape[-1])
        if self.datatype == "generic":
            return self.generic_ns
        return 4 if self.datatype == "nt" else 20

    @property
    def ns(self) -> int:
        """Process states: obs_ns, times n_hidden under covarion
        (mod->ns = n_o * n_h, init.c:6406)."""
        if self.covarion:
            return self.obs_ns * self.n_hidden
        return self.obs_ns

    @property
    def is_mixture(self) -> bool:
        return self.components is not None

    def init_params(self, obs_freqs: np.ndarray | None = None) -> dict:
        """Default parameter dict of float64 tensors (reference
        defaults: Set_Defaults_Model init.c:669 - kappa 4, alpha 1,
        pinv 0)."""
        p: dict[str, torch.Tensor] = {}
        ns = self.obs_ns
        if self.datatype == "nt":
            if self.name in ("K80", "HKY85", "F84", "TN93"):
                p["kappa"] = _t(4.0)
            if self.name == "TN93":
                p["lambda"] = _t(1.0)
            if self.name in ("GTR", "CUSTOM"):
                _, n_rr = dna_mod.parse_custom_string(
                    self.custom_string if self.name == "CUSTOM"
                    else "012345"
                )
                p["rr_val"] = torch.zeros(n_rr, dtype=_F64)  # log-rates
        if self.n_classes > 1 and not self.freerate and not self.is_mixture:
            p["alpha"] = _t(1.0)
        if self.is_mixture or self.freerate:
            p["class_rates_raw"] = torch.zeros(self.n_classes,
                                               dtype=_F64)
            p["class_weights_raw"] = torch.zeros(self.n_classes,
                                                 dtype=_F64)
        if self.invar:
            p["pinv"] = _t(0.2)
        if self.covarion:
            # M4 defaults: delta = 1, cov alpha = 1, free-mode raws
            # h_fq_unscaled = 1, multipl_unscaled = [0..n_h-1]
            # (M4_Init_Model init.c:6431-6436)
            p["cov_delta"] = _t(1.0)
            if self.cov_mode == "alpha":
                p["cov_alpha"] = _t(1.0)
            elif self.cov_mode == "free":
                p["cov_h_fq_raw"] = torch.ones(self.n_hidden, dtype=_F64)
                p["cov_multipl_raw"] = torch.arange(self.n_hidden,
                                                    dtype=_F64)
        if self.freqs_mode == "optimize":
            base = obs_freqs if obs_freqs is not None else np.full(ns, 1 / ns)
            p["freqs_raw"] = torch.log(_t(np.asarray(base)))
        elif self.freqs_mode == "empirical":
            if obs_freqs is None:
                raise ValueError("empirical freqs need observed counts")
            p["freqs_const"] = _t(np.asarray(obs_freqs))
        elif self.freqs_mode == "fixed":
            p["freqs_const"] = _t(np.asarray(self.fixed_freqs))
        # 'model' mode: frequencies come from the component table(s)
        return p

    # ------------------------------------------------------------------
    def _frequencies(self, params, comp_pi):
        """Per-class OBSERVED-state pi [..., C, obs_ns]."""
        C = self.n_classes
        if self.freqs_mode == "optimize":
            pi = torch.softmax(_t(params["freqs_raw"]), dim=-1)
        elif self.freqs_mode in ("empirical", "fixed"):
            pi = _t(params["freqs_const"])
            pi = pi / torch.sum(pi, dim=-1, keepdim=True)
        else:
            return comp_pi  # 'model': the component tables' frequencies
        return pi[..., None, :].expand(*pi.shape[:-1], C, pi.shape[-1])

    def class_system(self, params: dict, fold_rates: bool = True):
        """params -> (lam, V, Vinv, pi, w, pinv), float64 tensors with
        the parameters' batch shape leading (see the module notes).

        fold_rates=False returns the unit-mean-rate eigenvalues, with
        neither the class rates nor the 1/(1-pinv) fold (the ML
        pairwise distances, which the reference computes with the
        discrete-gamma distribution disabled, lk.c:1817-1824)."""
        C, ns = self.n_classes, self.obs_ns
        lead = batch_shape(params)

        # --- per-class rates & weights -------------------------------
        if self.is_mixture or self.freerate:
            rates, w = freerate_normalize(
                params["class_rates_raw"], params["class_weights_raw"]
            )
        elif C > 1:
            rates, w = discrete_gamma(
                params["alpha"], C, median=self.gamma_median
            )
        else:
            rates = torch.ones(1, dtype=_F64)
            w = torch.ones(1, dtype=_F64)

        # --- per-class exchangeabilities & base freqs -----------------
        # S [..., C, ns, ns]: one Q for all classes (a class axis of 1),
        # or a mixture's own Q and table frequencies per class
        comp_pi = None
        if self.is_mixture:
            S = torch.stack([_t(s) for s, _ in self.components])
            comp_pi = torch.stack([_t(p_) for _, p_ in self.components])
        elif self.datatype == "generic":
            # JC over the custom alphabet: unit exchangeabilities
            S = (torch.ones(ns, ns, dtype=_F64)
                 - torch.eye(ns, dtype=_F64))[None]
        elif self.datatype == "aa":
            S_np, pi_np = self.custom_aa if self.custom_aa is not None \
                else matrices.empirical_aa(self.name)
            S = _t(S_np)[None]
            comp_pi = _t(pi_np).expand(C, ns)
        else:
            dparams = {k: _t(v) for k, v in params.items()}
            if self.name == "F84":
                # lambda recomputed from current freqs & kappa
                pi_now = self._frequencies(params, None)[..., 0, :]
                dparams["lambda"] = _f84_lambda(pi_now, dparams["kappa"])
            cmap = None
            if self.name == "CUSTOM":
                cmap_np, _ = dna_mod.parse_custom_string(self.custom_string)
                cmap = torch.as_tensor(cmap_np, dtype=torch.long)
                dparams["rr"] = torch.clamp(
                    torch.exp(dparams["rr_val"]), RR_MIN, RR_MAX)
            elif self.name == "GTR":
                rr6 = torch.exp(dparams["rr_val"])
                rr6 = torch.clamp(rr6 / rr6[..., 5:6], RR_MIN, RR_MAX)
                dparams["rr"] = rr6
            S = dna_mod.exchangeabilities(self.name, dparams, cmap)
            S = S[..., None, :, :]                 # one Q for all classes

        pi = self._frequencies(params, comp_pi)

        # --- eigensystem (batched over classes and the batch shape) ---
        if self.covarion:
            # M4: blow the observed system up to n_hidden * obs_ns
            # states (m4.c:324 M4_Update_Qmat); the M4 normalization
            # (observed substitutions only) replaces the mean-rate-1
            # scaling, so eigen runs with normalize=False
            o_pi = pi[..., 0, :]
            E = self._m4_observed_exch(params, S[..., 0, :, :], o_pi)
            h_fq, multipl = m4_hidden_system(self, params)
            S_big, pi_big = m4_exchangeabilities(
                E, o_pi, h_fq, multipl, _t(params["cov_delta"]))
            S, pi = S_big[..., None, :, :], pi_big[..., None, :]
            ns = self.ns
            lam, V, Vinv = reversible_eigen(S, pi, normalize=False)
        else:
            lam, V, Vinv = reversible_eigen(S, pi)
        pinv = _t(params.get("pinv", 0.0))
        if fold_rates:
            lam = lam * rates[..., :, None]  # fold class rate into lam
        if fold_rates and self.invar:
            # Branch lengths follow the reference's FILE convention
            # (expected substitutions per site INCLUDING the never-
            # changing invariant fraction): internally the variable-
            # site process runs on t/(1-pinv)
            # (Br_Len_Not_Involving_Invar utilities.c:4155).
            # Folding 1/(1-pinv) into the eigenvalues is exactly
            # equivalent and keeps every tree array in file units.
            lam = lam / torch.clamp(1.0 - pinv, min=1e-8)[..., None,
                                                           None]
        return (lam.expand(lead + (C, ns)), V.expand(lead + (C, ns, ns)),
                Vinv.expand(lead + (C, ns, ns)), pi.expand(lead + (C, ns)),
                w.expand(lead + (C,)), pinv.expand(lead))

    def _m4_observed_exch(self, params, S_base, o_pi):
        """Observed-state exchangeabilities [..., n_o, n_o] the M4 big Q
        uses.

        For DNA models other than GTR/CUSTOM the reference overwrites
        the observed rates with the kappa1/kappa2 transition pattern
        (m4.c:411-431, with A<->G = kappa2, C<->T = kappa1 - flipped
        relative to PMat_TN93's convention).  For GTR/CUSTOM/AA (and
        generic data) it seeds them from the base model's normalized
        Q-matrix upper triangle (M4_Init_Model init.c:6417-6425), which
        bakes one factor of pi_j into the 'exchangeability'.
        """
        if self.datatype == "nt" and self.name not in ("GTR", "CUSTOM"):
            kappa = _t(params.get("kappa", 4.0))
            if self.name == "F84":
                lam_p = _f84_lambda(o_pi, kappa)
            elif self.name == "TN93":
                lam_p = _t(params["lambda"])
            else:
                lam_p = _t(1.0)
            kappa2 = kappa * 2.0 / (1.0 + lam_p)
            kappa1 = kappa2 * lam_p
            lead = torch.broadcast_shapes(kappa2.shape, kappa1.shape)
            E = torch.ones(lead + (4, 4), dtype=_F64)
            E[..., 0, 2] = E[..., 2, 0] = kappa2.expand(lead)
            E[..., 1, 3] = E[..., 3, 1] = kappa1.expand(lead)
            return E
        n_o = S_base.shape[-1]
        eye = torch.eye(n_o, dtype=_F64)
        off = S_base * o_pi[..., None, :] * (1.0 - eye)
        diag = -torch.sum(off, dim=-1)
        q = off + torch.diag_embed(diag)
        q = q / (-torch.sum(o_pi * diag, dim=-1))[..., None, None]
        upper = torch.triu(torch.clamp(q, min=1e-5), diagonal=1)
        return upper + upper.transpose(-1, -2)


def _f84_lambda(pi, kappa):
    A, C, G, T = pi[..., 0], pi[..., 1], pi[..., 2], pi[..., 3]
    R, Y = A + G, C + T
    kappa = torch.clamp(kappa, min=1e-5)
    return (Y + (R - Y) / (2.0 * kappa)) / (R - (R - Y) / (2.0 * kappa))


def lg4x_model() -> SubstModel:
    """The LG4X 4-matrix mixture (Le, Dang & Gascuel 2012), matching
    the reference's examples/lg4x XML setup (4 partitionless classes
    with free rates and weights)."""
    comps = [matrices.empirical_aa(n)
             for n in ("lg4x_1", "lg4x_2", "lg4x_3", "lg4x_4")]
    return SubstModel(
        datatype="aa", name="LG4X", n_classes=4, freerate=True,
        freqs_mode="model", components=comps,
    )
