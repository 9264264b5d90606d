"""Metropolis-Hastings over dated trees (≙ mcmc.c, the phytime chain).

Port of phyml_tpu/bayes/mcmc.py.  The chain state is a NamedTuple of
host tensors: float64 scalars and O(n) vectors (heights, log-rates),
the int32 child table and the parent vector.  Every move is a pair

    draw  (generator -> variates)
    apply (state, step, *variates -> proposal, log Hastings, affects)

so the tests can hand the port the variates read back from phyml_tpu's
proposal.  The joint log-posterior is the likelihood-engine call plus
the rate prior, the time prior, the calibrations and the hyperpriors;
a move that does not touch branch lengths reuses the cached lnL (the
reference's per-move `Lk` on the affected subtree).

Where phyml_tpu runs 250 steps inside one jitted `lax.scan`, here the
host steps the chain: the scalar moves draw from one torch.Generator
seeded from MCMCSettings.seed, the topology moves from numpy's
default_rng(seed + 77003) as phyml_tpu's do, so the same state and the
same stream give the same topology proposals in both packages.  Only
the branch lengths cross to the engine's device, in its dtype (float32
on the card, float64 on the CPU); each lnL-affecting step reads its
lnL back (one host sync).  On the card every posterior lnL is one pass
of the route's slot kernel (K1, or K4 at 20 states); the Guindon 2012
clock feeds it the Gamma-MGF P-matrices (LikelihoodEngine.loglik_mgf).

Step-size tuning happens between batches during burn-in, targeting
the reference's acceptance window (0.234-0.44,
MCMC_Adjust_Tuning_Parameter mcmc.c).

MALA (a joint gradient move over heights, clock, rates and the free
substitution scalars) needs the likelihood's gradient.  The kernels
have no backward pass, so, as phyml_tpu does whenever a kernel serves
the likelihood, its weight is 0 on the card; on the CPU its gradient
is torch.autograd through the plain scan.

trait_x (PhyREX: tip coordinates under the rw/rrw/ibm/iwn/iou movement
models of bayes/traits.py) adds the location term to the log prior and
the trait moves (sigma^2, the RRW edge scalers); the term is float64
host arithmetic on the CPU tensors of the chain state, differentiable
for MALA.

fastlk=True (the reference's --fastlk) swaps the likelihood for the
normal approximation fitted at the initial tree (optim/fastlk.py, on
the engine's device in float64): the substitution moves and MALA get
weight 0, and each lnL is a vector-matrix-vector product, no kernel
launch.  It is refused under the Guindon clock and with topology
moves, as in phyml_tpu.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from phyml_tpu_torch.bayes.chrono import TimeTree
from phyml_tpu_torch.bayes.rates import GUINDON, STRICT, RateModel
from phyml_tpu_torch.bayes.times import TimePrior
from phyml_tpu_torch.models.eigen import mgf_rates
from phyml_tpu_torch.ops.likelihood import TreeArrays

NEG_INF = -1e30
F64 = torch.float64


class ChainState(NamedTuple):
    child: torch.Tensor      # int32 [n-1, 2] postorder child table —
    #                          topology is CHAIN STATE (tree moves,
    #                          ≙ mcmc.c MCMC_Prune_Regraft family)
    parent: torch.Tensor     # int64 [2n-1] (root -> itself)
    heights: torch.Tensor    # [2n-1] node heights (tips fixed)
    log_r: torch.Tensor      # [2n-1] per-edge log relative rates
    log_clock: torch.Tensor  # scalar
    log_nu: torch.Tensor     # scalar rate-variation hyperparam
    hyper: dict              # birth/death/theta/growth scalars
    subst: dict              # substitution params (kappa, alpha)
    log_s2x: torch.Tensor    # scalar: log trait/location sigma^2
    trait_lr: torch.Tensor   # [2n-1] RRW log edge scalers (phyrex)
    lnL: torch.Tensor
    lp: torch.Tensor         # total prior log-density


@dataclass
class MCMCSettings:
    n_iter: int = 20000
    burnin: int = 2000
    batch: int = 250        # iterations between topology sweeps
    thin: int = 10
    seed: int = 0
    target_accept: tuple = (0.234, 0.44)
    clock_prior_mean_log: float = 0.0
    clock_prior_sd_log: float = 3.0


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F64)


def _set(x, i, v):
    """Copy of x with x[i] = v."""
    y = x.clone()
    y[i] = v
    return y


def _descendants(child: np.ndarray, n_otu: int, u: int) -> np.ndarray:
    """Mask [n_nodes] of u and every node below it (a reverse sweep
    over the postorder child table)."""
    mask = np.zeros(2 * n_otu - 1, dtype=bool)
    mask[u] = True
    for i in range(n_otu - 2, -1, -1):
        if mask[n_otu + i]:
            mask[child[i]] = True
    return mask


class MCMC:
    """Joint sampler over (node times, lineage rates, clock,
    hyperparameters, substitution parameters and, with
    sample_topology, the rooted topology) — the phytime posterior
    (date.c:779 DATE_MCMC).  The engine's device is the chain's
    (the CUDA device unless the engine was built on the CPU)."""

    MOVE_NAMES = [
        "height_slide", "root_scale", "tree_scale", "clock_scale",
        "rate_walk", "nu_scale", "hyper_scale", "subst_kappa",
        "subst_alpha", "rates_clock_swap", "trait_s2", "trait_scaler",
        "tree_clock_swap", "subtree_scale",
        "updown_root_clock", "rate_exchange", "nu_rates_updown",
        "height_jitter", "updown_t_br", "subtree_rates",
        "time_slice", "time_slice_br", "cov_switch", "cov_rates",
        "mala_times",
    ]

    def __init__(self, engine, model, subst_params, time_tree: TimeTree,
                 rate_model: RateModel, time_prior: TimePrior,
                 settings: MCMCSettings | None = None, trait_x=None,
                 trait_kind: str = "rrw", trait_nu: float = 1.0,
                 fastlk: bool = False, sample_topology: bool = False,
                 topo_moves_per_batch: int | None = None):
        """trait_x [n_otu, D] (optional): observed tip coordinates /
        continuous traits; when given, the chain jointly samples the
        movement model (trait_kind in rw/rrw/ibm/iwn/iou) — the
        phyrex posterior (PHYREX_MCMC phyrex.c:1234) with the
        genealogy informed by both sequences and locations."""
        if fastlk and rate_model.kind == GUINDON:
            # the quadratic lnL expansion is a function of expected
            # branch lengths only; it cannot represent the Guindon-2012
            # within-branch variance nu, so sampling nu against it
            # would silently draw nu from the prior alone
            raise ValueError(
                "fastlk is incompatible with the Guindon (2012) "
                "integrated relaxed clock: the normal approximation "
                "ignores the within-branch rate variance nu. Use the "
                "exact likelihood (fastlk=False) for this clock model."
            )
        if sample_topology and fastlk:
            raise ValueError("fastlk expands around ONE topology; "
                             "it cannot support tree moves")
        self.engine = engine
        self._normal_approx = None
        self.model = model
        self.tt = time_tree
        self.rate_model = rate_model
        self.prior_spec = time_prior
        self.time_prior = time_prior.resolve(time_tree)
        self._priors = {}        # resolved time prior per child table
        self.s = settings or MCMCSettings()
        self.trait_x = (None if trait_x is None
                        else torch.as_tensor(np.asarray(trait_x), dtype=F64))
        self.trait_kind = trait_kind
        self.trait_nu = trait_nu
        self.sample_topology = sample_topology
        self.topo_moves_per_batch = (
            topo_moves_per_batch if topo_moves_per_batch is not None
            else max(4, time_tree.n_otu))

        n = time_tree.n_otu
        self.n_otu = n
        self.n_nodes = time_tree.n_nodes
        self.root = time_tree.root
        self.child = torch.as_tensor(np.asarray(time_tree.child,
                                                dtype=np.int32))
        self.parent = torch.as_tensor(np.asarray(time_tree.parent,
                                                 dtype=np.int64))
        self.tip_heights = _f64(time_tree.heights[:n])
        self.subst_fixed = {k: _f64(v) for k, v in subst_params.items()}
        self._movable_subst = [
            k for k in ("kappa", "alpha", "cov_delta", "cov_alpha")
            if k in subst_params]
        self.hyper_names = self.time_prior.hyper_names()
        self._internal = torch.arange(self.n_nodes) >= n
        self._non_root = torch.arange(self.n_nodes) != self.root

        # per-move step sizes (tuned on host during burn-in)
        self.step = np.array([
            0.5, 0.5, 0.2, 0.3, 0.3, 0.5, 0.3, 0.3, 0.3, 1.0, 0.5, 0.5,
            1.5, 0.3, 0.5, 0.3, 0.3, 0.5, 0.5, 0.3, 0.3, 0.4, 0.3, 0.3,
            0.01,
        ])
        relaxed = rate_model.kind != STRICT
        has_tr = trait_x is not None
        w = np.array([
            3.0 * (n - 2), 2.0, 2.0, 2.0,
            (1.5 * (2 * n - 2)) if relaxed else 0.0,
            2.0 if relaxed else 0.0,
            2.0 * len(self.hyper_names), 7.0, 7.0,
            6.0 if relaxed else 0.0,
            2.0 if has_tr else 0.0,  # trait_s2
            (1.5 * (2 * n - 2)) if has_tr and trait_kind == "rrw"
            else 0.0,               # trait_scaler
            6.0,                    # tree_clock_swap (lnL-invariant)
            1.0 * max(n - 3, 0),    # subtree_scale
            6.0,                    # updown_root_clock
            (1.0 * (n - 1)) if relaxed else 0.0,
            2.0 if rate_model.kind in ("lognormal", "thorne")
            else 0.0,               # nu_rates_updown
            2.0 * (n - 2),          # height_jitter
            3.0 if relaxed else 0.0,  # updown_t_br
            2.0 if relaxed else 0.0,  # subtree_rates
            1.5,                    # time_slice
            2.0 if relaxed else 0.0,  # time_slice_br
            5.0 if "cov_delta" in subst_params else 0.0,
            5.0 if "cov_alpha" in subst_params else 0.0,
            # mala_times: one move updates ALL heights + the clock and
            # needs the likelihood's gradient: on the plain (CPU) path
            # only; the kernels have no backward pass
            (0.5 * n) if engine.device.type == "cpu" and not fastlk
            else 0.0,
        ])
        if "kappa" not in subst_params:
            w[7] = 0.0
        if "alpha" not in subst_params:
            w[8] = 0.0
        if fastlk:
            # expansion is only valid at the expansion-point model
            w[7] = w[8] = 0.0
            w[self.MOVE_NAMES.index("cov_switch")] = 0.0
            w[self.MOVE_NAMES.index("cov_rates")] = 0.0
            self._movable_subst = []
        self.move_w = w / w.sum()
        self._cum_w = np.cumsum(self.move_w)
        # fixed MALA metric: per-node height scales from the initial
        # tree's feasible windows (tips get 1 but are masked out)
        h0 = np.asarray(time_tree.heights, dtype=np.float64)
        par0 = np.asarray(time_tree.parent)
        ch0 = np.asarray(time_tree.child)
        mh = np.ones(self.n_nodes)
        for i in range(n - 1):
            u = n + i
            lo = max(h0[ch0[i, 0]], h0[ch0[i, 1]])
            hi = h0[par0[u]] if u != self.n_nodes - 1 \
                else h0[u] * 1.5 + 1e-6
            mh[u] = max(abs(hi - lo), 1e-4)
        self._mala_mh = _f64(mh)

        if fastlk:
            # expand at the initial time tree's durations (phyml_tpu's
            # expansion point), on the engine's device in float64
            from phyml_tpu_torch.optim.fastlk import fit_normal_approx
            dt0 = h0[par0] - h0
            dt0[self.root] = 0.0
            tree0 = TreeArrays(child=self.child, blen=torch.as_tensor(
                np.maximum(dt0, 0.0), device=engine.device))
            self._normal_approx = fit_normal_approx(
                engine, self.subst_fixed, tree0, engine.weights)

        # (variate kinds, apply) of every move, in MOVE_NAMES order:
        # "u" uniform [0, 1), "z" standard normal, (lo, hi) an integer
        # in [lo, hi), ("z", k) k standard normals
        nn_, root = self.n_nodes, self.root
        self.moves = [
            (((0, n - 2), "u"), self._mv_height_slide),
            (("u",), self._mv_root_scale),
            (("u",), self._mv_tree_scale),
            (("u",), self._mv_clock_scale),
            (((0, nn_ - 1), "z"), self._mv_rate_walk),
            (("u",), self._mv_nu_scale),
            (((0, max(len(self.hyper_names), 1)), "u", "z"),
             self._mv_hyper_scale),
            (("u",), self._mv_subst("kappa", 0.05, 100.0)),
            (("u",), self._mv_subst("alpha", 0.01, 100.0)),
            (("u",), self._mv_rates_clock_swap),
            (("u",), self._mv_trait_s2),
            (((0, nn_ - 1), "z"), self._mv_trait_scaler),
            (("u",), self._mv_tree_clock_swap),
            (((n, root), "u"), self._mv_subtree_scale),
            (("u",), self._mv_updown_root_clock),
            (((0, n - 1), "z"), self._mv_rate_exchange),
            (("u",), self._mv_nu_rates_updown),
            (((0, n - 2), "u"), self._mv_height_jitter),
            (((0, n - 2), "u"), self._mv_updown_t_br),
            (((n, root), "z"), self._mv_subtree_rates),
            (("u", "u"), self._mv_time_slice),
            (("u", "u"), self._mv_time_slice_br),
            (("u",), self._mv_subst("cov_delta", 0.01, 100.0)),
            (("u",), self._mv_subst("cov_alpha", 0.01, 100.0)),
            ((("z", nn_), ("z", 1), ("z", nn_),
              ("z", len(self._movable_subst))), self._mv_mala_times),
        ]

    # ------------------------------------------------------------------
    # joint posterior
    # ------------------------------------------------------------------
    def prior_of(self, child) -> TimePrior:
        """The time prior resolved on a child table: calibrations name
        clades by their taxa, so their nodes (and the calibrated Yule's
        bounds) follow the topology the chain is at."""
        host = np.ascontiguousarray(np.asarray(child, dtype=np.int32))
        key = host.tobytes()
        hit = self._priors.get(key)
        if hit is None:
            if np.array_equal(host, np.asarray(self.tt.child)):
                hit = self.time_prior
            else:
                # tips keep their heights (the calibrated Yule's
                # floors); internal nodes get their postorder ids above
                # every tip, so TimeTree.mrca's lowest common ancestor
                # is the youngest by this table alone
                n = self.n_otu
                hts = np.asarray(self.tt.heights, dtype=np.float64).copy()
                hts[n:] = hts[:n].max() + 1.0 + np.arange(n - 1)
                hit = self.prior_spec.resolve(TimeTree(
                    n_otu=n, child=host, heights=hts,
                    names=list(self.tt.names)))
            if len(self._priors) > 4096:
                self._priors.clear()
            self._priors[key] = hit
        return hit

    def _blen(self, state: ChainState):
        dt = state.heights[state.parent] - state.heights
        dt = torch.where(self._non_root, dt, torch.zeros_like(dt))
        rates = self.rate_model.rates(state.log_r, self.root)
        blen = torch.exp(state.log_clock) * rates * dt
        return blen, dt

    def _params(self, state: ChainState) -> dict:
        return {**self.subst_fixed, **state.subst}

    def _lnL(self, state: ChainState):
        """lnL (float64 0-d host tensor) through the engine: one pass
        of the single-pass kernel on the card, its plain version on the
        CPU; with fastlk, the normal approximation's quadratic surface
        (≙ Lk_Normal_Approx lk.c:2521), no tree traversal."""
        eng = self.engine
        blen, _ = self._blen(state)
        if self._normal_approx is not None:
            # only valid while substitution parameters stay at their
            # expansion values, so fastlk chains hold them fixed (as
            # the reference does)
            return self._normal_approx.loglik(blen).detach().to("cpu")
        tree = TreeArrays(child=state.child,
                          blen=blen.to(eng.device, eng.dtype))
        sys = eng.system_of(self._params(state))
        if self.rate_model.kind == GUINDON:
            # Guindon 2012 branch-length-integrated clock: P matrices
            # are the Gamma-MGF expectation E[P(L)] with within-branch
            # rate variance nu (gamma_mgf_bl path, lk.c:2310-2323 ->
            # PMat_MGF_Gamma models.c:1044)
            lnl = eng._loglik_mgf_sys(sys, tree, torch.exp(state.log_nu))
        else:
            lnl = eng._loglik_sys(sys, tree)
        return lnl.detach().to("cpu", F64)

    def _lnL_autograd(self, state: ChainState):
        """lnL differentiable in the state's heights, clock, rates and
        substitution scalars: the plain scan on the CPU engine's tips in
        float64 (LikelihoodEngine.loglik_functional)."""
        eng = self.engine
        blen, _ = self._blen(state)
        lam, V, Vinv, pi, w, pinv = self.model.class_system(
            self._params(state))
        if self.rate_model.kind == GUINDON:
            lam = mgf_rates(lam, torch.exp(state.log_nu))
        return eng.loglik_functional((lam, V, Vinv, pi, w, pinv),
                                     state.child, blen)

    def _log_prior(self, state: ChainState):
        dt = state.heights[state.parent] - state.heights
        dt = torch.where(self._non_root, dt, torch.zeros_like(dt))
        if float(torch.min(dt.detach())) < -1e-12:
            return _f64(NEG_INF)
        prior = self.prior_of(state.child)
        nu = torch.exp(state.log_nu)
        lp = self.rate_model.log_prior(state.log_r, dt, state.parent,
                                       nu, self.root)
        lp = lp + prior.log_prior(state.heights, self.n_otu, state.hyper)
        lp = lp + prior.log_calibrations(state.heights)
        # hyperpriors: Exp(1) on positive hypers + nu, N(m, sd) on
        # log clock, N(0, 3^2) on growth
        for nm in self.hyper_names:
            v = state.hyper[nm]
            if nm == "growth":
                lp = lp - 0.5 * (v / 3.0) ** 2
            else:
                lp = lp - v
        lp = lp - nu
        z = ((state.log_clock - self.s.clock_prior_mean_log)
             / self.s.clock_prior_sd_log)
        lp = lp - 0.5 * z * z
        if self.trait_x is not None:
            # location/trait likelihood rides in the prior slot so it
            # is recomputed for every move touching heights or the
            # movement parameters (float64 host arithmetic, kept
            # differentiable for MALA); state.child, so genealogy moves
            # re-derive the integrated kinds' MRCA table, and only rrw
            # reads the edge scalers and nu
            from phyml_tpu_torch.bayes.traits import location_loglik
            s2x = torch.exp(state.log_s2x)
            lk_x = location_loglik(
                self.trait_kind, self.trait_x, state.child,
                torch.clamp(dt, min=0.0), s2x, log_scalers=state.trait_lr,
                nu=self.trait_nu)
            lp = lp + lk_x - s2x  # Exp(1) hyperprior on sigma^2
        return lp

    # ------------------------------------------------------------------
    # moves: apply(state, step, *variates) -> (proposal, log Hastings,
    # affects lnL)
    # ------------------------------------------------------------------
    def _window(self, st, i):
        """(node n + i, its oldest child's height, its parent's)."""
        u = self.n_otu + i
        c0, c1 = st.child[i].tolist()
        lo = torch.maximum(st.heights[c0], st.heights[c1])
        return u, lo, st.heights[int(st.parent[u])]

    def _root_window(self, st):
        return self._window(st, self.root - self.n_otu)[1]

    def _mv_height_slide(self, st, step, i, u):
        node, lo, hi = self._window(st, i)
        h = torch.maximum(u * (hi - lo) + lo, lo)
        return st._replace(heights=_set(st.heights, node, h)), 0.0, True

    def _mv_root_scale(self, st, step, u):
        lo = self._root_window(st)
        m = torch.exp(step * (u - 0.5))
        h = lo + m * (st.heights[self.root] - lo)
        return (st._replace(heights=_set(st.heights, self.root, h)),
                float(torch.log(m)), True)

    def _scaled_internal(self, st, m):
        return torch.where(self._internal, st.heights * m, st.heights)

    def _mv_tree_scale(self, st, step, u):
        m = torch.exp(step * (u - 0.5))
        log_h = (self.n_otu - 1) * float(torch.log(m))
        return st._replace(heights=self._scaled_internal(st, m)), log_h, \
            True

    def _mv_clock_scale(self, st, step, u):
        d = step * (u - 0.5)
        return st._replace(log_clock=st.log_clock + d), 0.0, True

    def _mv_rate_walk(self, st, step, k, z):
        return (st._replace(log_r=_set(st.log_r, k, st.log_r[k] + step * z)),
                0.0, True)

    def _mv_nu_scale(self, st, step, u):
        d = step * (u - 0.5)
        # under the Guindon integrated clock, nu is the within-branch
        # rate variance fed to the MGF likelihood (loglik_mgf), so a
        # nu move changes lnL, not just the prior
        return (st._replace(log_nu=st.log_nu + d), 0.0,
                self.rate_model.kind == GUINDON)

    def _mv_hyper_scale(self, st, step, j, u, z):
        if not self.hyper_names:
            return st, 0.0, False
        nm = self.hyper_names[j]
        hyper = dict(st.hyper)
        if nm == "growth":
            hyper[nm] = hyper[nm] + step * z
            log_h = 0.0
        else:
            m = torch.exp(step * (u - 0.5))
            hyper[nm] = hyper[nm] * m
            log_h = float(torch.log(m))
        return st._replace(hyper=hyper), log_h, False

    def _mv_subst(self, name, lo, hi):
        def mv(st, step, u):
            if name not in st.subst:
                return st, 0.0, False
            m = torch.exp(step * (u - 0.5))
            v = st.subst[name] * m
            # A proposal outside [lo, hi] is REJECTED (log-Hastings
            # -inf), not clipped: clipping puts an atom at the bound
            # with no matching reverse density and biases the
            # posterior near the bounds.
            if not lo <= float(v) <= hi:
                return st, NEG_INF, True
            return (st._replace(subst={**st.subst, name: v}),
                    float(torch.log(m)), True)
        return mv

    def _mv_rates_clock_swap(self, st, step, u):
        """Mixing move: scale all relative rates by m and the clock by
        1/m — leaves branch lengths (and lnL) invariant, moves the
        prior decomposition (≙ MCMC_Rates_Shrink-style moves).  A pure
        translation in (log_r, log_clock) space: |J| = 1 and the
        proposal is symmetric, so the Hastings term vanishes."""
        log_m = step * (u - 0.5)
        return (st._replace(log_r=st.log_r + log_m,
                            log_clock=st.log_clock - log_m), 0.0, False)

    def _mv_trait_s2(self, st, step, u):
        d = step * (u - 0.5)
        return st._replace(log_s2x=st.log_s2x + d), 0.0, False

    def _mv_trait_scaler(self, st, step, k, z):
        return (st._replace(trait_lr=_set(st.trait_lr, k,
                                          st.trait_lr[k] + step * z)),
                0.0, False)

    def _mv_tree_clock_swap(self, st, step, u):
        """Scale ALL internal heights by m and the clock by 1/m:
        branch lengths (and lnL) are invariant, the (times, rate)
        decomposition moves (≙ MCMC_Updown_T_Cr mcmc.c).  Hastings:
        (n-1) log m from the height scaling, 0 from the clock
        translation in log space."""
        m = torch.exp(step * (u - 0.5))
        log_m = torch.log(m)
        # blen invariance (lnL reuse) only holds when every tip sits
        # at height 0: with heterochronous tips the tip-edge dt is not
        # scaled uniformly, so the likelihood must be recomputed
        affects = bool(torch.any(self.tip_heights != 0.0))
        return (st._replace(heights=self._scaled_internal(st, m),
                            log_clock=st.log_clock - log_m),
                (self.n_otu - 1) * float(log_m), affects)

    def _strict_subtree(self, st, u):
        """Mask of the internal nodes strictly below node u."""
        mask = _descendants(st.child.numpy(), self.n_otu, u)
        mask[u] = False
        mask[:self.n_otu] = False
        return torch.as_tensor(mask)

    def _mv_subtree_scale(self, st, step, k, u):
        """Scale the internal heights STRICTLY below a random internal
        non-root node k by m (≙ the reference's subtree-height moves);
        infeasible proposals (child older than parent) die in the
        prior's feasibility check."""
        scaled = self._strict_subtree(st, k)
        m = torch.exp(step * (u - 0.5))
        h = torch.where(scaled, st.heights * m, st.heights)
        return (st._replace(heights=h),
                int(scaled.sum()) * float(torch.log(m)), True)

    def _mv_updown_root_clock(self, st, step, u):
        """Scale the root height toward/away from its children by m
        and the clock by 1/m: the root-edge lengths stay near-constant
        while (root age, clock) decorrelate (≙ MCMC_Updown_T_Cr,
        mcmc.c).  Hastings: log m from the height part."""
        lo = self._root_window(st)
        m = torch.exp(step * (u - 0.5))
        h = lo + m * (st.heights[self.root] - lo)
        log_m = torch.log(m)
        return (st._replace(heights=_set(st.heights, self.root, h),
                            log_clock=st.log_clock - log_m),
                float(log_m), True)

    def _mv_rate_exchange(self, st, step, i, z):
        """Antithetic rate update on the two child edges of a random
        internal node: +d on one, -d on the other (≙ the reference's
        exchange-between-adjacent-edges moves)."""
        c0, c1 = st.child[i].tolist()
        d = step * z
        log_r = st.log_r.clone()
        log_r[c0] = log_r[c0] + d
        log_r[c1] = log_r[c1] - d
        return st._replace(log_r=log_r), 0.0, True

    def _mv_nu_rates_updown(self, st, step, u):
        """Scale the per-edge log-rate deviations by m and nu by m^2:
        the standardized rate field is invariant.  Hastings: (n_edges)
        log m from the log_r scaling (the log_nu translation has unit
        Jacobian)."""
        m = torch.exp(step * (u - 0.5))
        log_m = torch.log(m)
        log_r = torch.where(self._non_root, st.log_r * m, st.log_r)
        return (st._replace(log_r=log_r, log_nu=st.log_nu + 2.0 * log_m),
                (self.n_nodes - 1) * float(log_m), True)

    def _mv_height_jitter(self, st, step, i, u):
        """Reflected local jitter of one internal non-root height
        within its (oldest child, parent) window (≙ MCMC_Times
        windowed slides)."""
        node, lo, hi = self._window(st, i)
        w = hi - lo
        d = step * w * (u - 0.5)
        x = torch.remainder(st.heights[node] + d - lo, 2.0 * w)
        h = lo + torch.minimum(x, 2.0 * w - x)    # reflect into (lo,hi)
        return st._replace(heights=_set(st.heights, node, h)), 0.0, True

    def _mv_updown_t_br(self, st, step, i, u):
        """Move one internal non-root height while RESCALING the three
        incident edges' relative rates so every branch length is
        exactly invariant — lnL is reused (≙ MCMC_Updown_T_Br mcmc.c).
        Jacobian: m from the height map times dt_e/dt'_e per rescaled
        rate."""
        node, lo, hi = self._window(st, i)
        c0, c1 = st.child[i].tolist()
        h = st.heights
        m = torch.exp(step * (u - 0.5))
        h_new = torch.clamp(lo + m * (h[node] - lo), lo + 1e-12, hi - 1e-12)
        dts = [(hi - h[node], hi - h_new), (h[node] - h[c0], h_new - h[c0]),
               (h[node] - h[c1], h_new - h[c1])]
        # blen invariance (the basis for reusing lnL) requires the
        # rate compensation r' = r * dt/dt' to be EXACT: reject any
        # proposal touching a near-degenerate gap rather than clamp
        eps = 1e-9
        feasible = bool(h_new > lo) and bool(h_new < hi) and all(
            bool(a > eps) and bool(b > eps) for a, b in dts)
        lr = st.log_r.clone()
        for e, (a, b) in zip((node, c0, c1), dts):
            lr[e] = lr[e] + (torch.log(torch.clamp(a, min=eps))
                             - torch.log(torch.clamp(b, min=eps)))
        log_h = float(torch.log(m)) if feasible else NEG_INF
        return (st._replace(heights=_set(h, node, h_new if feasible
                                         else h[node]), log_r=lr),
                log_h, False)

    def _mv_subtree_rates(self, st, step, k, z):
        """Translate the log-rates of every edge strictly below a
        random internal node by d (≙ MCMC_Subtree_Rates)."""
        mask = _descendants(st.child.numpy(), self.n_otu, k)
        mask[k] = False
        log_r = torch.where(torch.as_tensor(mask), st.log_r + step * z,
                            st.log_r)
        return st._replace(log_r=log_r), 0.0, True

    def _slice(self, st, step, u_tau, u_m):
        """(slice height tau, m, internal nodes above tau, heights
        scaled about tau)."""
        tau = u_tau * st.heights[self.root]
        m = torch.exp(step * (u_m - 0.5))
        above = self._internal & (st.heights > tau)
        return m, above, torch.where(above, tau + m * (st.heights - tau),
                                     st.heights)

    def _mv_time_slice(self, st, step, u_tau, u_m):
        """Scale every node height ABOVE a random time slice tau by m
        (h' = tau + m (h - tau)) (≙ MCMC_Time_Slice, mcmc.c:6591-6668).
        Hastings: the height Jacobian plus the state-dependent slice
        draw (tau ~ U(0, h_root); the reverse draws from
        U(0, h_root')): n_above log m + log h_root - log h_root'."""
        m, above, h = self._slice(st, step, u_tau, u_m)
        log_h = float(int(above.sum()) * torch.log(m)
                      + torch.log(st.heights[self.root])
                      - torch.log(h[self.root]))
        return st._replace(heights=h), log_h, True

    def _mv_time_slice_br(self, st, step, u_tau, u_m):
        """time_slice with exact branch-length compensation: rates on
        every edge whose duration changed are rescaled by dt/dt', so
        all branch lengths (and lnL) are invariant (≙ MCMC_Updown_T_Br
        generalized to a slice)."""
        m, above, h_new = self._slice(st, step, u_tau, u_m)
        one = torch.ones_like(h_new)
        dt_old = torch.where(self._non_root,
                             st.heights[st.parent] - st.heights, one)
        dt_new = torch.where(self._non_root, h_new[st.parent] - h_new, one)
        eps = 1e-9
        changed = torch.abs(dt_new - dt_old) > 0.0
        if not bool(torch.all(~changed | ((dt_new > eps)
                                          & (dt_old > eps)))):
            return st, NEG_INF, False
        comp = torch.where(changed,
                           torch.log(torch.clamp(dt_old, min=eps))
                           - torch.log(torch.clamp(dt_new, min=eps)),
                           torch.zeros_like(h_new))
        log_h = float(int(above.sum()) * torch.log(m)
                      + torch.log(st.heights[self.root])
                      - torch.log(h_new[self.root]))
        return st._replace(heights=h_new, log_r=st.log_r + comp), log_h, \
            False

    def mala_grad(self, st, h, lc, lr, lsub):
        """Gradient of the joint log-posterior in (heights, log clock,
        log-rates, log substitution scalars) at st with those replaced
        (the target of the original scalars: + sum(lsub), the
        log-parameterization's Jacobian); non-finite entries -> 0."""
        snames = self._movable_subst
        xs = [x.detach().clone().requires_grad_() for x in (h, lc, lr, lsub)]
        subst = {**st.subst, **{nm: torch.exp(xs[3][j])
                                for j, nm in enumerate(snames)}}
        s2 = st._replace(heights=xs[0], log_clock=xs[1], log_r=xs[2],
                         subst=subst)
        f = self._lnL_autograd(s2) + self._log_prior(s2) + torch.sum(xs[3])
        gs = torch.autograd.grad(f, xs, allow_unused=True)
        return [torch.zeros_like(x) if g is None else
                torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                for g, x in zip(gs, xs)]

    def _mv_mala_times(self, st, step, xi_h, xi_c, xi_r, xi_s):
        """Metropolis-adjusted Langevin move over (all internal
        heights, log clock, log-rates, log substitution scalars): one
        gradient of the joint log-posterior drives a drift, so every
        height moves together.  Exact MALA Hastings with the
        reverse-gradient term; a fixed diagonal metric (each height on
        the scale of its window in the initial tree)."""
        internal = self._internal.to(F64)
        r_mask = self._non_root.to(F64) * (
            1.0 if self.rate_model.kind != STRICT else 0.0)
        snames = self._movable_subst
        lsub0 = (torch.stack([torch.log(st.subst[nm]) for nm in snames])
                 if snames else torch.zeros(0, dtype=F64))
        masks = (internal, 1.0, r_mask, 1.0)
        scales = (self._mala_mh, 1.0, 1.0, 1.0)
        x0 = (st.heights, st.log_clock, st.log_r, lsub0)

        def grad(x):
            return [g * mk for g, mk in zip(self.mala_grad(st, *x), masks)]

        eps = step
        g0 = grad(x0)
        xi = (xi_h * internal, xi_c.reshape(()), xi_r * r_mask, xi_s)
        x1 = tuple(x + 0.5 * eps * eps * sc * sc * g + eps * sc * z
                   for x, g, z, sc in zip(x0, g0, xi, scales))
        g1 = grad(x1)

        def logq(x_to, x_from, g_from, mask, scale):
            mu = x_from + 0.5 * eps * eps * scale * scale * g_from
            r = (x_to - mu) * mask / (eps * scale)
            return -torch.sum(r * r) / 2.0

        log_h = sum(logq(a, b, g, mk, sc) - logq(b, a, g_a, mk, sc)
                    for a, b, g, g_a, mk, sc in zip(x0, x1, g1, g0, masks,
                                                    scales))
        # the chain's accept ratio uses the ORIGINAL-space densities,
        # so the log-parameterization's Jacobian enters as Hastings
        if snames:
            log_h = log_h + (torch.sum(x1[3]) - torch.sum(lsub0))
        subst = {**st.subst, **{nm: torch.exp(x1[3][j])
                                for j, nm in enumerate(snames)}}
        return (st._replace(heights=x1[0], log_clock=x1[1], log_r=x1[2],
                            subst=subst), float(log_h), True)

    # ------------------------------------------------------------------
    def draw(self, mv: int, gen: torch.Generator) -> list:
        """The variates of move mv, drawn from gen."""
        out = []
        for kind in self.moves[mv][0]:
            if kind == "u":
                out.append(torch.rand((), generator=gen, dtype=F64))
            elif kind == "z":
                out.append(torch.randn((), generator=gen, dtype=F64))
            elif kind[0] == "z":
                out.append(torch.randn((kind[1],), generator=gen,
                                       dtype=F64))
            else:
                out.append(int(torch.randint(kind[0], kind[1], (),
                                             generator=gen)))
        return out

    def propose(self, st: ChainState, mv: int, step: float, variates):
        """(proposal, log Hastings, affects lnL) of move mv."""
        return self.moves[mv][1](st, step, *variates)

    def _step(self, st: ChainState, gen: torch.Generator):
        u = float(torch.rand((), generator=gen, dtype=F64))
        mv = min(int(np.searchsorted(self._cum_w, u, side="right")),
                 len(self.moves) - 1)
        prop, log_h, affects = self.propose(st, mv, float(self.step[mv]),
                                            self.draw(mv, gen))
        lp_new = self._log_prior(prop)
        # an infeasible proposal (prior or Hastings -inf) is rejected
        # without its lnL: negative durations never reach the engine
        if affects and float(lp_new) > NEG_INF / 2 and log_h > NEG_INF / 2:
            lnL_new = self._lnL(prop)
        else:
            lnL_new = st.lnL
        log_alpha = float((lnL_new + lp_new) - (st.lnL + st.lp)) + log_h
        accept = float(torch.log(torch.rand((), generator=gen,
                                            dtype=F64))) < log_alpha
        if accept:
            return prop._replace(lnL=lnL_new, lp=lp_new), mv, True
        return st, mv, False

    # ------------------------------------------------------------------
    # topology moves (host-side, between batches)
    # ------------------------------------------------------------------
    # The reference's dating MCMC mixes rare structural moves
    # (MCMC_Prune_Regraft + variants, mcmc.c:6591-6668) with the dense
    # scalar moves.  Topology proposals run between batches (each needs
    # tree surgery + one posterior evaluation), with the postorder
    # child table renumbered after every accepted move so the engine's
    # slot schedule stays valid.

    def _eval_posterior(self, st: ChainState):
        return self._lnL(st), self._log_prior(st)

    def _narrow_exchange(self, child, parent, heights, rng):
        """Narrow exchange: swap a random child g of internal node c
        with c's sibling s (symmetric proposal; invalid if the moved
        sibling would be older than its new parent).  Returns
        (child', parent', log_hastings) or None."""
        n = self.n_otu
        c = int(rng.integers(n, self.root))       # internal, non-root
        p = int(parent[c])
        row_p = child[p - n]
        s = int(row_p[1] if int(row_p[0]) == c else row_p[0])
        gi = int(rng.integers(0, 2))
        g = int(child[c - n][gi])
        if heights[c] <= heights[s]:
            return None                            # h(c) must exceed h(s)
        ch = child.copy()
        pa = parent.copy()
        ch[p - n] = [c, g]
        ch[c - n][gi] = s
        pa[g] = p
        pa[s] = c
        return ch, pa, 0.0

    def _in_subtree(self, pa, b, root_of):
        while b != self.root:
            if b == root_of:
                return True
            b = int(pa[b])
        return b == root_of

    def _spanning(self, pa, heights, hp, x, p, exclude):
        """Edges b (above node b) spanning height hp, outside the pruned
        subtree of x, other than x, p and `exclude`."""
        out = []
        for b in range(self.root):
            a = int(pa[b])
            if heights[a] > hp >= heights[b] and b != x and b != p \
                    and b != exclude and not self._in_subtree(pa, b, x):
                out.append(b)
        return out

    def _regraft(self, child, parent, x, p, g, s, b):
        """Prune p (with x below it) and regraft it onto edge b: g
        adopts s in place of p, b's parent adopts p in place of b, and
        p's children become {x, b}."""
        n = self.n_otu
        a = int(parent[b])
        ch = child.copy()
        pa = parent.copy()
        ch[g - n] = [s if int(v) == p else int(v) for v in ch[g - n]]
        pa[s] = g
        ch[a - n] = [p if int(v) == b else int(v) for v in ch[a - n]]
        pa[p] = a
        ch[p - n] = [x, b]
        pa[b] = p
        return ch, pa

    def _prune_point(self, child, parent, x):
        """(p, g, s): x's parent, grandparent and sibling, or None
        where x hangs from the root."""
        n = self.n_otu
        p = int(parent[x])
        if p == self.root:
            return None
        row_p = child[p - n]
        s = int(row_p[1] if int(row_p[0]) == x else row_p[0])
        return p, int(parent[p]), s

    def _spr_times(self, child, parent, heights, rng):
        """Prune-regraft at fixed height: detach node x (with its
        parent p), regraft p into a random edge spanning h(p)
        (≙ MCMC_Prune_Regraft, mcmc.c).  Hastings = log F - log R
        where F/R count spanning edges before/after."""
        x = int(rng.integers(0, self.root))        # any non-root node
        return self._spr_times_at(child, parent, heights, rng, x)

    def _spr_times_weighted(self, child, parent, heights, rng,
                            lam: float = 0.7):
        """Prune-regraft at fixed height with LOCALITY-WEIGHTED target
        choice: a spanning edge b is picked with probability
        proportional to lam^hops(p, b), with the exact Hastings
        correction for the asymmetric choice
        (≙ MCMC_Prune_Regraft_Weighted / spr_weighted,
        mcmc.c:6604-6607)."""
        x = int(rng.integers(0, self.root))
        pt = self._prune_point(child, parent, x)
        if pt is None:
            return None
        p, g, s = pt
        hp = heights[p]

        def path_to_root(pa, u):
            out = [u]
            while out[-1] != self.root:
                out.append(int(pa[out[-1]]))
            return out

        def hops(pa, u, v):
            pu = path_to_root(pa, u)
            pv = path_to_root(pa, v)
            su = {q: k for k, q in enumerate(pu)}
            for k, q in enumerate(pv):
                if q in su:
                    return su[q] + k
            return len(pu) + len(pv)

        cands = self._spanning(parent, heights, hp, x, p, s)
        if not cands:
            return None
        wts = np.array([lam ** hops(parent, p, b) for b in cands])
        wts = wts / wts.sum()
        bi = int(rng.choice(len(cands), p=wts))
        b = int(cands[bi])
        log_p_fwd = float(np.log(wts[bi]))
        ch, pa = self._regraft(child, parent, x, p, g, s, b)
        # reverse: from the NEW tree, the reverse move regrafts p
        # onto edge s; its choice probability uses the NEW distances
        rev_cands = self._spanning(pa, heights, hp, x, p, b)
        if s not in rev_cands:
            return None
        wts_r = np.array([lam ** hops(pa, p, bb) for bb in rev_cands])
        wts_r = wts_r / wts_r.sum()
        log_p_rev = float(np.log(wts_r[rev_cands.index(s)]))
        return ch, pa, log_p_rev - log_p_fwd

    def _spr_times_root(self, child, parent, heights, rng):
        """Prune-regraft restricted to the DEEP region: prune nodes
        whose parent sits in the oldest quartile of internal heights
        (the reference gives root-adjacent rearrangements their own
        tuned moves, spr_root mcmc.c:6604-6607).  Hastings adds the
        forward / reverse prune-set size ratio on top of the
        target-count ratio."""
        n = self.n_otu
        hint = np.sort(heights[n:])
        thresh = float(hint[int(0.75 * len(hint))])

        def deep_set(pa):
            return [x for x in range(self.root)
                    if int(pa[x]) != self.root
                    and heights[int(pa[x])] >= thresh]

        deep = deep_set(parent)
        if not deep:
            return None
        x = int(deep[rng.integers(0, len(deep))])
        res = self._spr_times_at(child, parent, heights, rng, x)
        if res is None:
            return None
        ch, pa, log_h = res
        deep_new = deep_set(pa)
        if x not in deep_new:
            return None
        log_h += float(np.log(len(deep)) - np.log(len(deep_new)))
        return ch, pa, log_h

    def _spr_times_at(self, child, parent, heights, rng, x):
        """_spr_times with the pruned node given (shared machinery)."""
        pt = self._prune_point(child, parent, x)
        if pt is None:
            return None
        p, g, s = pt
        hp = heights[p]
        cands = self._spanning(parent, heights, hp, x, p, s)
        if not cands:
            return None
        b = int(cands[rng.integers(0, len(cands))])
        ch, pa = self._regraft(child, parent, x, p, g, s, b)
        R = len(self._spanning(pa, heights, hp, x, p, b))
        if R == 0:
            return None
        return ch, pa, float(np.log(len(cands)) - np.log(R))

    @staticmethod
    def _renumber_postorder(child, parent, n_otu):
        """Renumber internal nodes of a (possibly non-postorder) child
        table into valid postorder (children strictly below parents).
        Returns (child', parent', perm) with perm[old_id] = new_id
        (identity on tips; root maps to root)."""
        n_nodes = 2 * n_otu - 1
        root = n_nodes - 1
        kids = {n_otu + i: [int(child[i, 0]), int(child[i, 1])]
                for i in range(n_otu - 1)}
        # find current root: node that is its own parent
        cur_root = int(np.nonzero(parent == np.arange(n_nodes))[0][0])
        perm = np.arange(n_nodes)
        order = []
        stack = [(cur_root, False)]
        while stack:
            u, done = stack.pop()
            if u < n_otu:
                continue
            if done:
                order.append(u)
            else:
                stack.append((u, True))
                for v in kids[u]:
                    stack.append((v, False))
        for new_i, old in enumerate(order):
            perm[old] = n_otu + new_i
        assert perm[cur_root] == root
        new_child = np.zeros_like(child)
        new_parent = np.zeros(n_nodes, dtype=parent.dtype)
        for old in order:
            i_new = perm[old] - n_otu
            new_child[i_new] = [perm[kids[old][0]], perm[kids[old][1]]]
        for u in range(n_nodes):
            new_parent[perm[u]] = perm[int(parent[u])]
        return new_child, new_parent, perm

    def topology_step(self, st: ChainState, rng) -> tuple:
        """One host-side topology proposal (narrow exchange or one of
        the prune-regraft-on-times moves) + MH accept.  Returns
        (state, kind, accepted)."""
        child = st.child.numpy()
        parent = st.parent.numpy()
        heights = st.heights.numpy()
        kind = str(rng.choice(
            ["narrow", "spr", "spr_weighted", "spr_root"],
            p=[0.35, 0.25, 0.25, 0.15]))
        fns = {"narrow": self._narrow_exchange,
               "spr": self._spr_times,
               "spr_weighted": self._spr_times_weighted,
               "spr_root": self._spr_times_root}
        res = fns[kind](child, parent, heights, rng)
        if res is None:
            return st, kind, False
        ch, pa, log_h = res
        ch2, pa2, perm = self._renumber_postorder(ch, pa, self.n_otu)
        inv = torch.as_tensor(np.argsort(perm))
        prop = st._replace(
            child=torch.as_tensor(ch2.astype(np.int32)),
            parent=torch.as_tensor(pa2.astype(np.int64)),
            heights=st.heights[inv], log_r=st.log_r[inv],
            trait_lr=st.trait_lr[inv])
        lnL_new, lp_new = self._eval_posterior(prop)
        log_alpha = float(lnL_new + lp_new - st.lnL - st.lp) + log_h
        if np.log(rng.random()) < log_alpha:
            return prop._replace(lnL=lnL_new, lp=lp_new), kind, True
        return st, kind, False

    # ------------------------------------------------------------------
    def init_state(self, subst_params=None) -> ChainState:
        z = torch.zeros((), dtype=F64)
        st = ChainState(
            child=self.child,
            parent=self.parent,
            heights=_f64(self.tt.heights).clone(),
            log_r=torch.zeros(self.n_nodes, dtype=F64),
            log_clock=z,
            log_nu=_f64(-1.0),
            hyper=self.time_prior.default_hyper(),
            subst={k: _f64(v) for k, v in
                   (subst_params or self.subst_fixed).items()
                   if k in self._movable_subst},
            log_s2x=z,
            trait_lr=torch.zeros(self.n_nodes, dtype=F64),
            lnL=z,
            lp=z,
        )
        return st._replace(lnL=self._lnL(st), lp=self._log_prior(st))

    def run(self, state: ChainState | None = None, trace_fh=None,
            verbose=False, checkpoint_path: str | None = None,
            checkpoint_every_s: float = 300.0):
        """Run the chain; returns (final state, trace [T, 5],
        acceptance-rate vector).  Trace columns: posterior, lnL,
        root height, log clock, log nu (≙ the phytime trace file,
        mcmc.c:2588 MCMC_Print_Param).

        checkpoint_path: persist (state, iteration, tuned steps, the
        generators' states) atomically every checkpoint_every_s seconds
        and at the end, and resume from it when it exists (the
        reference's checkpoint.c is an empty stub)."""
        from phyml_tpu_torch.bayes.diagnostics import ess_report
        from phyml_tpu_torch.utils.checkpoint import load_chain, save_chain

        s = self.s
        st = state if state is not None else self.init_state()
        done = 0
        traces = []
        gen = torch.Generator().manual_seed(s.seed)
        topo_rng = np.random.default_rng(s.seed + 77003)
        resumed: dict = {}
        if checkpoint_path is not None:
            hit = load_chain(checkpoint_path, ChainState)
            if hit is not None:
                st, done, self.step, gen_state, resumed = hit
                gen.set_state(gen_state)
                if "topo_rng_state" in resumed:
                    # resume the host topology-proposal stream where it
                    # left off instead of replaying it from the start
                    topo_rng.bit_generator.state = \
                        resumed["topo_rng_state"]
                if verbose:
                    print(f"  mcmc resumed at iteration {done}")
        self.topo_tries = int(resumed.get("topo_tries", 0))
        self.topo_accepts = int(resumed.get("topo_accepts", 0))
        self.topo_samples = []   # (iter, child table) after each batch
        tot_tries = np.zeros(len(self.MOVE_NAMES), dtype=np.int64)
        tot_accs = np.zeros(len(self.MOVE_NAMES), dtype=np.int64)
        if trace_fh is not None:
            trace_fh.write("iter\tposterior\tlnL\troot_height\t"
                           "clock\tnu\n")
        ck_last = time.monotonic()
        while done < s.n_iter:
            n = min(s.batch, s.n_iter - done)
            tries = np.zeros(len(self.MOVE_NAMES), dtype=np.int64)
            accs = np.zeros(len(self.MOVE_NAMES), dtype=np.int64)
            rows = []
            for _ in range(n):
                st, mv, acc = self._step(st, gen)
                tries[mv] += 1
                accs[mv] += acc
                rows.append((float(st.lnL + st.lp), float(st.lnL),
                             float(st.heights[self.root]),
                             float(st.log_clock), float(st.log_nu)))
            if self.sample_topology:
                for _ in range(self.topo_moves_per_batch):
                    st, _kind, acc = self.topology_step(st, topo_rng)
                    self.topo_tries += 1
                    self.topo_accepts += int(acc)
                self.topo_samples.append((done + n, st.child.numpy().copy()))
            tot_tries += tries
            tot_accs += accs
            tr = np.asarray(rows)
            traces.append(tr)
            if trace_fh is not None:
                for j in range(0, n, s.thin):
                    trace_fh.write(
                        f"{done + j}\t{tr[j,0]:.4f}\t{tr[j,1]:.4f}\t"
                        f"{tr[j,2]:.6f}\t{np.exp(tr[j,3]):.6g}\t"
                        f"{np.exp(tr[j,4]):.6g}\n")
            done += n
            if done <= s.burnin:
                # host-side tuning (≙ MCMC_Adjust_Tuning_Parameter)
                rate = accs / np.maximum(tries, 1)
                lo, hi = s.target_accept
                for i in range(len(self.step)):
                    if i == 0 or tries[i] == 0:
                        continue  # window slide is self-tuning
                    if rate[i] < lo:
                        self.step[i] *= 0.7
                    elif rate[i] > hi:
                        self.step[i] *= 1.4
                self.step = np.clip(self.step, 1e-4, 20.0)
            # after the tuning, so that a resume steps as the chain would
            if checkpoint_path is not None and (
                    time.monotonic() - ck_last >= checkpoint_every_s
                    or done >= s.n_iter):
                save_chain(checkpoint_path, st, done, self.step,
                           gen.get_state(),
                           extra={"topo_rng_state":
                                  topo_rng.bit_generator.state,
                                  "topo_tries": self.topo_tries,
                                  "topo_accepts": self.topo_accepts})
                ck_last = time.monotonic()
            if verbose:
                print(f"  mcmc iter {done}/{s.n_iter} "
                      f"posterior={float(st.lnL + st.lp):.3f} "
                      f"lnL={float(st.lnL):.3f}")
        acc_rate = tot_accs / np.maximum(tot_tries, 1)
        if not traces:
            # resumed at (or past) n_iter: no batches ran this call
            self.ess = {}
            return st, np.zeros((0, 5)), acc_rate
        trace_all = np.concatenate(traces, axis=0)
        self.ess = ess_report(trace_all,
                              burnin_rows=min(s.burnin,
                                              trace_all.shape[0] // 2))
        if trace_fh is not None:
            trace_fh.write("# ESS: " + "  ".join(
                f"{k}={v:.1f}" for k, v in self.ess.items()) + "\n")
            if self.sample_topology and self.topo_tries:
                trace_fh.write(
                    f"# topology moves: {self.topo_accepts}/"
                    f"{self.topo_tries} accepted\n")
        if verbose:
            print("  ESS:", {k: round(v, 1)
                             for k, v in self.ess.items()})
        return st, trace_all, acc_rate
