"""PhyREX (bayes/phyrex.py, the trait half of bayes/mcmc.py and
bayes/geo.py) against phyml_tpu on the CPU; the <phyrex> XML root is in
tests/test_torch_phyrex_xml.py.

The alignment is tests/test_torch_bayes.py's (6 taxa, 120 sites,
HKY85+G4 down a coalescent chronogram); the chains start from that
chronogram with its heights scaled by HEIGHT_SCALE (unit-scale
durations, where every movement model's density is well conditioned:
tests/test_torch_traits.py) and score tip coordinates simulated as
Brownian motion down it.  Both packages run float64 engines.  Held:

* the move weights for every trait kind, and the log prior (the
  location term and the Exp(1) hyperprior on sigma^2 included) at a
  perturbed state within 1e-9 relative (PRIOR_REL; for ibm, iwn and
  iou the location term against the mpmath oracle of
  tests/test_torch_traits.py, the rest within 1e-9); the MALA gradient
  with trait_x within 1e-6 of jax.grad of phyml_tpu's target for rrw,
  within 1e-4 of its largest entry for ibm (IBM_GRAD_REL: the same
  conditioning); 40 topology_step calls from one numpy seed carrying the RRW
  scalers (trait_lr) as phyml_tpu's do, with the same accept decisions;
* one rrw chain in each package (2,000 iterations): the posterior mean
  of log sigma^2 (log_s2x) within 4 Monte Carlo standard errors;
* ancestral_locations (message passing) and its dense oracle, each
  against phyml_tpu's within 1e-10;
* GeoModel.loglik within 1e-10 relative at a few labelings and
  parameters, GeoModel.mcmc's trace draw for draw, and its default
  device raising without a card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu.bayes import geo as jgeo
from phyml_tpu.bayes import phyrex as jphx
from phyml_tpu.bayes.chrono import TimeTree as JTimeTree
from phyml_tpu.bayes.mcmc import MCMC as JMCMC
from phyml_tpu.bayes.mcmc import MCMCSettings as JSettings
from phyml_tpu.bayes.rates import RateModel as JRates
from phyml_tpu.bayes.times import TimePrior as JPrior
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.ops.likelihood import LikelihoodEngine as JEngine
from phyml_tpu_torch.bayes import geo as tgeo
from phyml_tpu_torch.bayes import phyrex as tphx
from phyml_tpu_torch.bayes.diagnostics import effective_sample_size
from phyml_tpu_torch.bayes.mcmc import MCMC as TMCMC
from phyml_tpu_torch.bayes.mcmc import MCMCSettings as TSettings
from phyml_tpu_torch.bayes.rates import RateModel as TRates
from phyml_tpu_torch.bayes.times import TimePrior as TPrior
from phyml_tpu_torch.interop import chain_state_from_numpy, params_from_numpy
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine
from test_torch_bayes import N_TAXA, _numpy_state, _problem, _tt_port

PRIOR_REL = 1e-9
GRAD_TOL = 1e-6
IBM_GRAD_REL = 1e-4
HEIGHT_SCALE = 8.0
TRAIT_KINDS = ["rw", "rrw", "ibm", "iwn", "iou"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _coords(tt, seed=5, s2=0.5):
    """Tip coordinates [n, 2]: Brownian motion down tt from (10, 40)."""
    rng = np.random.default_rng(seed)
    par, dt = tt.parent, tt.edge_durations()
    x = np.zeros((tt.n_nodes, 2))
    x[tt.root] = (10.0, 40.0)
    for u in range(tt.n_nodes - 2, -1, -1):
        x[u] = x[par[u]] + rng.normal(size=2) * np.sqrt(s2 * dt[u])
    return x[:tt.n_otu]


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """(scaled JAX chronogram, JAX alignment, port alignment, coords)."""
    jtt, jaln, taln = _problem(tmp_path_factory.mktemp("phyrex"))
    tt = JTimeTree(n_otu=jtt.n_otu, child=np.asarray(jtt.child).copy(),
                   heights=np.asarray(jtt.heights) * HEIGHT_SCALE,
                   names=list(jtt.names))
    return tt, jaln, taln, _coords(tt)


def _chains(problem, trait_kind="rrw", settings=None, with_trait=True,
            **kw):
    """(phyml_tpu MCMC, port MCMC) with trait_x, the coalescent prior
    (run_phyrex's), a lognormal clock, float64 engines."""
    jtt, jaln, taln, x = problem
    jm = JModel(datatype="nt", name="HKY85", n_classes=4)
    tm = TModel(datatype="nt", name="HKY85", n_classes=4)
    jp = jm.init_params(jaln.obs_state_freqs)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    jeng = JEngine(jaln, jm, dtype=jnp.float64)
    teng = TEngine(taln, tm, dtype=torch.float64, device="cpu")
    tr = dict(trait_x=x, trait_kind=trait_kind) if with_trait else {}
    jmc = JMCMC(jeng, jm, jp, jtt, JRates(kind="lognormal"),
                JPrior(kind="coalescent"),
                settings=JSettings(**(settings or {})), **tr, **kw)
    tmc = TMCMC(teng, tm, tp, _tt_port(jtt), TRates(kind="lognormal"),
                TPrior(kind="coalescent"),
                settings=TSettings(**(settings or {})), **tr, **kw)
    return jmc, tmc


def _trait_state(jmc, seed=3):
    """phyml_tpu's initial state moved off its defaults (log-rates,
    clock, the coalescent theta, sigma^2 and the RRW scalers), its lnL
    and prior recomputed."""
    rng = np.random.default_rng(seed)
    st = jmc.init_state()
    st = st._replace(
        log_r=jnp.asarray(0.3 * rng.standard_normal(jmc.n_nodes)),
        log_clock=jnp.asarray(-1.5),
        hyper={k: v * 1.3 for k, v in st.hyper.items()},
        log_s2x=jnp.asarray(-0.6),
        trait_lr=jnp.asarray(0.4 * rng.standard_normal(jmc.n_nodes)))
    return st._replace(lnL=jnp.asarray(jmc._lnL(st)), lp=jmc._log_prior(st))


# ----------------------------------------------------------------------
# the chain
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", [None] + TRAIT_KINDS)
def test_move_weights_match(problem, kind):
    jmc, tmc = _chains(problem, trait_kind=kind or "rrw",
                       with_trait=kind is not None)
    np.testing.assert_allclose(tmc.move_w, np.asarray(jmc.move_w),
                               rtol=1e-15, atol=0)
    s2 = TMCMC.MOVE_NAMES.index("trait_s2")
    assert (tmc.move_w[s2] > 0) == (kind is not None)
    assert (tmc.move_w[s2 + 1] > 0) == (kind == "rrw")


@pytest.mark.parametrize("kind", TRAIT_KINDS)
def test_log_prior_with_traits_matches(problem, kind):
    """_log_prior and _lnL at the start and at a perturbed state, the
    location term included.  For the integrated kinds the location term
    (IntegratedModel.marginal_loglik at root_var 1e6, ill-conditioned
    in float64 in both packages: tests/test_torch_traits.py) is held to
    the 60-digit oracle as there, and the rest of the log prior within
    PRIOR_REL."""
    from phyml_tpu.bayes.traits import location_loglik as jloc
    from phyml_tpu_torch.bayes.traits import location_loglik as tloc
    from test_torch_traits import ORACLE_FACTOR, _mp_marginal

    jmc, tmc = _chains(problem, trait_kind=kind)
    x = problem[3]
    for js in (jmc.init_state(), _trait_state(jmc)):
        ts = chain_state_from_numpy(_numpy_state(js))
        a, b = float(tmc._log_prior(ts)), float(jmc._log_prior(js))
        if kind in ("ibm", "iwn", "iou"):
            # the port's log prior is its bare chain's plus the location
            # term and the hyperprior; the bare ones agree within
            # PRIOR_REL, the location term with the oracle
            h, par = np.asarray(js.heights), np.asarray(js.parent)
            dt = np.maximum(h[par] - h, 0.0)
            dt[jmc.root] = 0.0
            s2 = float(np.exp(js.log_s2x))
            lj = float(jloc(kind, jnp.asarray(x), js.child, jnp.asarray(dt),
                            s2))
            lt = float(tloc(kind, torch.as_tensor(x), ts.child,
                            torch.as_tensor(dt), s2))
            exact = _mp_marginal(kind, x, np.asarray(js.child), dt, s2, 1.0,
                                 1e6)
            assert abs(lt - exact) <= max(ORACLE_FACTOR * abs(lj - exact),
                                          1e-10 * abs(exact))
            jbare, tbare = _chains(problem, with_trait=False)
            bare = float(tbare._log_prior(ts))
            assert abs(a - (bare + lt - s2)) <= 1e-12 * max(1.0, abs(a))
            a, b = bare, float(jbare._log_prior(js))
        assert abs(a - b) <= PRIOR_REL * max(1.0, abs(b)), (a, b)
        assert abs(float(tmc._lnL(ts)) - float(jmc._lnL(js))) <= 1e-6


@pytest.mark.parametrize("kind", ["rrw", "ibm"])
def test_mala_gradient_with_traits_matches_jax_grad(problem, kind):
    jmc, tmc = _chains(problem, trait_kind=kind)
    js = _trait_state(jmc)
    ts = chain_state_from_numpy(_numpy_state(js))
    snames = jmc._movable_subst

    def logpost(h, lc, lr, lsub):
        subst = {**js.subst, **{nm: jnp.exp(lsub[j])
                                for j, nm in enumerate(snames)}}
        s2 = js._replace(heights=h, log_clock=lc, log_r=lr, subst=subst)
        return jmc._lnL(s2) + jmc._log_prior(s2) + jnp.sum(lsub)

    lsub = jnp.stack([jnp.log(js.subst[nm]) for nm in snames])
    gj = jax.grad(logpost, argnums=(0, 1, 2, 3))(
        js.heights, js.log_clock, js.log_r, lsub)
    gt = tmc.mala_grad(ts, ts.heights, ts.log_clock, ts.log_r,
                       torch.log(torch.stack([ts.subst[nm]
                                              for nm in snames])))
    internal = np.arange(jmc.n_nodes) >= jmc.n_otu
    non_root = np.arange(jmc.n_nodes) != jmc.root
    for a, b, mask in zip(gt, gj, (internal, True, non_root, True)):
        b = np.where(np.isfinite(np.asarray(b)), np.asarray(b), 0.0)
        # ibm's location term is ill-conditioned in float64 (see
        # test_log_prior_with_traits_matches): its gradient is held
        # relative to its largest entry
        tol = GRAD_TOL if kind == "rrw" else IBM_GRAD_REL * np.abs(b).max()
        np.testing.assert_allclose(a.numpy() * mask, b * mask, rtol=0,
                                   atol=tol)
    # the location term moves the heights' gradient
    _, bare = _chains(problem, with_trait=False)
    g0 = bare.mala_grad(ts, ts.heights, ts.log_clock, ts.log_r,
                        torch.log(torch.stack([ts.subst[nm]
                                               for nm in snames])))[0]
    assert float(torch.abs(gt[0] - g0)[internal].max()) > 1e-3


def test_topology_steps_carry_the_rrw_scalers(problem):
    """40 topology_step calls from one state (random trait_lr) and
    one numpy seed: the same kinds, accept decisions, child tables and
    trait_lr permutations."""
    jtt, jaln, taln, x = problem
    start = JTimeTree.coalescent(N_TAXA, np.random.default_rng(99),
                                 theta=0.4 * HEIGHT_SCALE,
                                 names=list(jtt.names))
    jmc, tmc = _chains((start, jaln, taln, x), trait_kind="rrw",
                       sample_topology=True)
    js = _trait_state(jmc)
    ts = chain_state_from_numpy(_numpy_state(js))
    rj, rt = np.random.default_rng(77), np.random.default_rng(77)
    accepted = 0
    for _ in range(40):
        js, kj, aj = jmc.topology_step(js, rj)
        ts, kt, at = tmc.topology_step(ts, rt)
        assert (kt, at) == (kj, aj)
        accepted += at
        np.testing.assert_array_equal(ts.child.numpy(), np.asarray(js.child))
        np.testing.assert_array_equal(ts.trait_lr.numpy(),
                                      np.asarray(js.trait_lr))
    assert accepted > 0


def test_rrw_chains_agree_in_distribution(problem):
    """One rrw chain in each package (2,000 iterations, 500 burn-in):
    the posterior mean of log sigma^2 within 4 Monte Carlo standard
    errors (sqrt(var / ESS) of each chain, combined); phyml_tpu's read
    at the end of each 20-iteration batch, the port's every iteration."""
    settings = dict(n_iter=2000, burnin=500, batch=20, seed=4)
    jmc, tmc = _chains(problem, trait_kind="rrw", settings=settings)
    jv, tv = [], []
    jbatch = jmc._jit_batch

    def jrecord(*a, **k):
        out = jbatch(*a, **k)
        jv.append(float(out[0].log_s2x))
        return out

    tstep = tmc._step

    def trecord(st, gen):
        out = tstep(st, gen)
        tv.append(float(out[0].log_s2x))
        return out

    jmc._jit_batch = jrecord
    tmc._step = trecord
    jmc.run()
    tmc.run()
    a, b = np.asarray(jv[500 // 20:]), np.asarray(tv[500:])
    se = np.hypot(a.std() / np.sqrt(effective_sample_size(a)),
                  b.std() / np.sqrt(effective_sample_size(b)))
    print(f"log sigma^2: phyml_tpu {a.mean():.4f}  port {b.mean():.4f}  "
          f"standard error {se:.4f}")
    assert abs(a.mean() - b.mean()) <= 4.0 * se


def test_ancestral_locations_match(problem):
    """Message passing and the dense oracle, with and without RRW
    scalers, against phyml_tpu's; the two agree with each other."""
    jtt, _, _, x = problem
    tt = _tt_port(jtt)
    sc = np.exp(0.3 * np.random.default_rng(2).standard_normal(tt.n_nodes))
    for scalers in (None, sc):
        bp = tphx.ancestral_locations(tt, x, 0.7, edge_scalers=scalers)
        dense = tphx.ancestral_locations_dense(tt, x, 0.7,
                                               edge_scalers=scalers)
        np.testing.assert_allclose(bp, jphx.ancestral_locations(
            jtt, x, 0.7, edge_scalers=scalers), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(dense, jphx.ancestral_locations_dense(
            jtt, x, 0.7, edge_scalers=scalers), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(bp, dense, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# GEO
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def geo_case():
    """A 9-taxon coalescent chronogram on a 5-location landscape."""
    rng = np.random.default_rng(21)
    tt = JTimeTree.coalescent(9, rng, theta=1.5)
    coords = rng.uniform(0, 10, size=(5, 2))
    tip_loc = rng.integers(0, 5, size=9)
    return tt, coords, tip_loc


def test_geo_loglik_and_mcmc_match(geo_case):
    tt, coords, tip_loc = geo_case
    jm = jgeo.GeoModel(coords, tt, tip_loc)
    tm = tgeo.GeoModel(coords, _tt_port(tt), tip_loc, device="cpu")
    rng = np.random.default_rng(4)
    infeasible = 0
    for k in range(6):
        il = (jm.init_locations(rng) if k % 3 else
              rng.integers(0, 5, size=tt.n_otu - 1))
        for s, lb, ta in ((1.0, 1.0, 1.0), (2.5, 0.3, 0.7)):
            a = float(tm.loglik(il, s, lb, ta))
            b = float(jm.loglik(il, s, lb, ta))
            infeasible += b == jgeo.NEG_INF
            assert abs(a - b) <= 1e-10 * max(1.0, abs(b)), (a, b)
    assert 0 < infeasible < 12
    js, jl, jt, jil, jtr = jm.mcmc(n_iter=200, seed=3)
    ts, tl, tt_, til, ttr = tm.mcmc(n_iter=200, seed=3)
    np.testing.assert_allclose(ttr, jtr, rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(til, jil)
    assert (ts, tl, tt_) == pytest.approx((js, jl, jt), rel=1e-10)


def test_geo_model_defaults_to_the_card(geo_case):
    tt, coords, tip_loc = geo_case
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tgeo.GeoModel(coords, _tt_port(tt), tip_loc)
    with pytest.raises(RuntimeError, match="CUDA device"):
        importlib.import_module("phyml_tpu_torch.bayes.phyrex").run_phyrex(
            None, None, None, model=TModel(datatype="nt", name="HKY85"))
