"""The Bayesian dating chain (phytime) against phyml_tpu on the CPU.

Both packages read one alignment simulated by phyml_tpu down a
6-taxon coalescent chronogram (120 sites, HKY85+G4, as
tests/test_bayes.py:16-46), in float64, and are held:

* at shared states (carried across with interop.chain_state_from_numpy):
  TimeTree.from_topology; every TimePrior kind's log_prior and
  log_calibrations, the calibrated-Yule mixture among them; every
  RateModel kind's log_prior and rates; pmat_mgf_gamma (P, not
  eigenvectors); loglik_mgf, MCMC._blen, _lnL, _log_prior and
  init_state; move_w; the MALA gradient against jax.grad.  Priors
  within 1e-9 relative, lnL and gradients within 1e-6 absolute
  (PRIOR_REL, LNL_TOL);
* move by move: every scalar move's proposal and log Hastings, from
  the variates phyml_tpu drew (the same jax.random calls on the same
  key), within 1e-12 (MOVE_TOL);
* topology moves: 50 topology_step calls from one state and one numpy
  seed give the same kinds, child tables, heights and accept decisions;
* whole chains: one 6-taxon chain in each package (lognormal clock,
  birth-death prior, a root calibration, 3,000 iterations): posterior
  means of the root height and the log clock within 4 Monte Carlo
  standard errors (sqrt(var / ESS) of each chain, combined);
* the port's own invariants: the cached lnL equals a recompute within
  1e-6, one seed gives one chain, a checkpoint resume ends where the
  uninterrupted chain ends, the Guindon chain runs on the MGF path,
  and trait_x, covarion and fastlk chains build (trait_x with
  phyml_tpu's move weights; tests/test_torch_phyrex.py and
  tests/test_torch_fastlk.py hold them to phyml_tpu).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu.bayes import invitee as jinv
from phyml_tpu.bayes.chrono import TimeTree as JTimeTree
from phyml_tpu.bayes.mcmc import MCMC as JMCMC
from phyml_tpu.bayes.mcmc import MCMCSettings as JSettings
from phyml_tpu.bayes.rates import RateModel as JRates
from phyml_tpu.bayes.times import Calibration as JCal
from phyml_tpu.bayes.times import TimePrior as JPrior
from phyml_tpu.evolve import simulate_alignment, write_phylip
from phyml_tpu.io.alignment import read_alignment as jread
from phyml_tpu.models.eigen import pmat_mgf_gamma as jpmat_mgf
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.ops.likelihood import LikelihoodEngine as JEngine
from phyml_tpu.ops.likelihood import TreeArrays as JTree
from phyml_tpu.topology import Topology as JTopology
from phyml_tpu_torch.bayes import invitee as tinv
from phyml_tpu_torch.bayes.chrono import TimeTree as TTimeTree
from phyml_tpu_torch.bayes.diagnostics import effective_sample_size
from phyml_tpu_torch.bayes.mcmc import MCMC as TMCMC
from phyml_tpu_torch.bayes.mcmc import MCMCSettings as TSettings
from phyml_tpu_torch.bayes.rates import RateModel as TRates
from phyml_tpu_torch.bayes.times import Calibration as TCal
from phyml_tpu_torch.bayes.times import TimePrior as TPrior
from phyml_tpu_torch.interop import (
    chain_state_from_numpy, params_from_numpy, tree_arrays_from_numpy,
)
from phyml_tpu_torch.io.alignment import read_alignment as tread
from phyml_tpu_torch.models.eigen import pmat_mgf_gamma as tpmat_mgf
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine
from phyml_tpu_torch.topology import Topology as TTopology

PRIOR_REL = 1e-9
LNL_TOL = 1e-6
MOVE_TOL = 1e-12
N_TAXA, N_SITES = 6, 120
RATE_KINDS = ["strict", "lognormal", "thorne", "guindon"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread: the chain is thousands of small ops, which
    an oversubscribed OpenMP region under the suite's workers slows."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(tmp_path, seed=7, n_taxa=N_TAXA, n_sites=N_SITES):
    """(JAX chronogram, JAX alignment, port alignment): sequences
    simulated by phyml_tpu under HKY85+G4 (kappa 4, alpha 0.8, unequal
    frequencies) down a coalescent chronogram, written once and read
    by both packages."""
    rng = np.random.default_rng(seed)
    tt = JTimeTree.coalescent(n_taxa, rng, theta=0.4)
    m = JModel(datatype="nt", name="HKY85", n_classes=4,
               freqs_mode="fixed",
               fixed_freqs=np.array([0.3, 0.2, 0.2, 0.3]))
    p = m.init_params()
    p["kappa"] = jnp.asarray(4.0)
    p["alpha"] = jnp.asarray(0.8)
    names, seqs = simulate_alignment(tt.to_topology(), m, p, n_sites, rng)
    path = str(tmp_path / f"aln{seed}.phy")
    write_phylip(path, list(tt.names), seqs)
    return tt, jread(path, datatype="nt"), tread(path, datatype="nt")


def _tt_port(jtt):
    return TTimeTree(n_otu=jtt.n_otu, child=np.asarray(jtt.child).copy(),
                     heights=np.asarray(jtt.heights).copy(),
                     names=list(jtt.names))


def _cals(jtt, cls):
    """A root calibration around the chronogram's root and a clade
    calibration on its first cherry's parent."""
    h = np.asarray(jtt.heights)
    c0, c1 = (int(x) for x in jtt.child[0])
    tips = [jtt.names[c] for c in (c0, c1) if c < jtt.n_otu]
    out = [cls(taxa=tuple(jtt.names), lower=0.5 * h[jtt.root],
               upper=3.0 * h[jtt.root])]
    if len(tips) == 2:
        out.append(cls(taxa=tuple(tips), lower=0.2 * h[jtt.n_otu],
                       upper=4.0 * h[jtt.n_otu]))
    return out


def _chains(jtt, jaln, taln, rate_kind="lognormal", prior_kind="birthdeath",
            cals=2, settings=None, **kw):
    """(phyml_tpu MCMC, port MCMC) on float64 engines, HKY85+G4 at
    the model's initial parameters; the first `cals` of _cals'
    calibrations."""
    jm = JModel(datatype="nt", name="HKY85", n_classes=4)
    tm = TModel(datatype="nt", name="HKY85", n_classes=4)
    jp = jm.init_params(jaln.obs_state_freqs)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    jeng = JEngine(jaln, jm, dtype=jnp.float64)
    teng = TEngine(taln, tm, dtype=torch.float64, device="cpu")
    jprior = JPrior(kind=prior_kind,
                    calibrations=tuple(_cals(jtt, JCal)[:cals]))
    tprior = TPrior(kind=prior_kind,
                    calibrations=tuple(_cals(jtt, TCal)[:cals]))
    js = JSettings(**(settings or {}))
    ts = TSettings(**(settings or {}))
    jmc = JMCMC(jeng, jm, jp, jtt, JRates(kind=rate_kind), jprior,
                settings=js, **kw)
    tmc = TMCMC(teng, tm, tp, _tt_port(jtt), TRates(kind=rate_kind),
                tprior, settings=ts, **kw)
    return jmc, tmc


def _numpy_state(st):
    return {k: ({k2: np.asarray(v2) for k2, v2 in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in st._asdict().items()}


def _perturbed(jmc, seed=3):
    """phyml_tpu's initial state moved off its defaults (random
    log-rates, clock, nu, hypers, kappa and alpha), with its lnL and
    prior recomputed: a state where every move changes something."""
    rng = np.random.default_rng(seed)
    st = jmc.init_state()
    st = st._replace(
        log_r=jnp.asarray(0.3 * rng.standard_normal(jmc.n_nodes)),
        log_clock=jnp.asarray(0.2), log_nu=jnp.asarray(-0.7),
        hyper={**st.hyper, "birth": jnp.asarray(1.7),
               "death": jnp.asarray(0.4), "growth": jnp.asarray(0.3)},
        subst={k: v * 1.2 for k, v in st.subst.items()})
    return st._replace(lnL=jnp.asarray(jmc._lnL(st)), lp=jmc._log_prior(st))


def _close(a, b, tol, rel=False):
    a, b = float(a), float(b)
    assert abs(a - b) <= tol * (max(abs(a), abs(b)) if rel else 1.0), (a, b)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    return _problem(tmp_path_factory.mktemp("bayes"))


# ----------------------------------------------------------------------
# deterministic pieces
# ----------------------------------------------------------------------
def test_time_tree_from_topology_matches(problem):
    rng = np.random.default_rng(4)
    jt = JTopology.random(9, rng)
    tt_j = JTimeTree.from_topology(jt, names=[f"t{i}" for i in range(9)])
    tt_t = TTimeTree.from_topology(
        TTopology(jt.n_otu, np.asarray(jt.edges), np.asarray(jt.blen)),
        names=[f"t{i}" for i in range(9)])
    np.testing.assert_array_equal(tt_t.child, tt_j.child)
    np.testing.assert_allclose(tt_t.heights, tt_j.heights, rtol=0, atol=0)
    assert tt_t.to_newick() == tt_j.to_newick()
    assert tt_t.mrca([0, 1, 2]) == tt_j.mrca([0, 1, 2])


def _heights_state(jtt, seed):
    h = np.asarray(jtt.heights, dtype=np.float64).copy()
    h[jtt.n_otu:] *= np.random.default_rng(seed).uniform(0.9, 1.1)
    return h


@pytest.mark.parametrize("kind", ["yule", "birthdeath", "coalescent",
                                  "expcoalescent", "uniform",
                                  "calibrated_yule"])
def test_time_priors_match(problem, kind):
    jtt = problem[0]
    hyper = dict(birth=1.6, death=0.45, theta=0.7, growth=0.35)
    jp = JPrior(kind=kind, calibrations=tuple(_cals(jtt, JCal))).resolve(jtt)
    tp = TPrior(kind=kind, calibrations=tuple(_cals(jtt, TCal))).resolve(
        _tt_port(jtt))
    for seed in range(3):
        h = _heights_state(jtt, seed)
        lp_j = jp.log_prior(jnp.asarray(h), jtt.n_otu,
                            {k: jnp.asarray(v) for k, v in hyper.items()})
        lp_t = tp.log_prior(torch.as_tensor(h), jtt.n_otu,
                            {k: torch.tensor(v, dtype=torch.float64)
                             for k, v in hyper.items()})
        _close(lp_t, lp_j, PRIOR_REL, rel=True)
        _close(tp.log_calibrations(torch.as_tensor(h)),
               jp.log_calibrations(jnp.asarray(h)), PRIOR_REL, rel=True)
    # outside a calibration window both reject
    bad = np.asarray(jtt.heights, dtype=np.float64).copy()
    bad[jtt.root] *= 10.0
    assert float(jp.log_calibrations(jnp.asarray(bad))) < -1e20 or \
        kind == "calibrated_yule"
    assert float(tp.log_calibrations(torch.as_tensor(bad))) == \
        float(jp.log_calibrations(jnp.asarray(bad)))


def test_calibrated_yule_mixture_matches(problem):
    """Two candidate clades for one calibration, weighted 0.7/0.3
    (TIMES_Calib_Cond_Prob invitee.c:718)."""
    jtt = problem[0]
    names = jtt.names

    def mixture(mod, tt):
        cal = mod.MultiCalibration(
            choices=(mod.CladeChoice(taxa=(names[0], names[1]), proba=0.7),
                     mod.CladeChoice(taxa=(names[2], names[3]), proba=0.3)),
            lower=0.0, upper=float(np.max(jtt.heights)) * 2)
        return mod.CalibratedYule(tt, (cal,))

    cj, ct = mixture(jinv, jtt), mixture(tinv, _tt_port(jtt))
    assert ct.n_combos == cj.n_combos == 2
    for b in (0.6, 1.0, 2.5):
        _close(ct.log_prior(torch.as_tensor(np.asarray(jtt.heights)),
                            torch.tensor(b, dtype=torch.float64)),
               cj.log_prior(jnp.asarray(jtt.heights), jnp.asarray(b)),
               PRIOR_REL, rel=True)


@pytest.mark.parametrize("kind", RATE_KINDS)
def test_rate_priors_match(problem, kind):
    jtt = problem[0]
    rng = np.random.default_rng(11)
    n_nodes = jtt.n_nodes
    log_r = 0.4 * rng.standard_normal(n_nodes)
    dt = np.asarray(jtt.edge_durations())
    par = np.asarray(jtt.parent)
    for nu in (0.05, 0.6, 2.0):
        lp_j = JRates(kind=kind).log_prior(
            jnp.asarray(log_r), jnp.asarray(dt), jnp.asarray(par),
            jnp.asarray(nu), jtt.root)
        lp_t = TRates(kind=kind).log_prior(
            torch.as_tensor(log_r), torch.as_tensor(dt),
            torch.as_tensor(par.astype(np.int64)),
            torch.tensor(nu, dtype=torch.float64), jtt.root)
        _close(lp_t, lp_j, PRIOR_REL, rel=True)
    np.testing.assert_allclose(
        TRates(kind=kind).rates(torch.as_tensor(log_r), jtt.root).numpy(),
        np.asarray(JRates(kind=kind).rates(jnp.asarray(log_r), jtt.root)),
        rtol=1e-15, atol=0)


@pytest.mark.parametrize("sigma", [0.0, 1e-13, 0.02, 0.7])
def test_pmat_mgf_gamma_matches(sigma):
    """P, not eigenvectors: the port is pmat at the substituted
    eigenvalues, phyml_tpu exponentiates the MGF; both switch to plain
    P(t) at sigma <= 1e-12."""
    jm = JModel(datatype="nt", name="GTR", n_classes=4)
    jp = jm.init_params(np.array([0.3, 0.2, 0.2, 0.3]))
    jp["rr_val"] = jnp.log(jnp.asarray([1.2, 3.0, 0.8, 1.1, 4.0, 1.0]))
    jp["alpha"] = jnp.asarray(0.6)
    lam, V, Vinv = (np.array(x) for x in jm.class_system(jp)[:3])
    t = np.random.default_rng(2).uniform(0.0, 1.5, (11, 4))
    pj = np.asarray(jpmat_mgf(jnp.asarray(lam), jnp.asarray(V),
                              jnp.asarray(Vinv), jnp.asarray(t), sigma))
    pt = tpmat_mgf(torch.as_tensor(lam), torch.as_tensor(V),
                   torch.as_tensor(Vinv), torch.as_tensor(t), sigma).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("sigma", [0.0, 0.05, 0.8])
def test_loglik_mgf_matches(problem, sigma):
    jtt, jaln, taln = problem
    jmc, tmc = _chains(jtt, jaln, taln, rate_kind="guindon")
    blen = np.maximum(np.asarray(jtt.edge_durations()), 0.0) * 1.3
    jtree = JTree(child=jnp.asarray(jtt.child, dtype=jnp.int32),
                  blen=jnp.asarray(blen))
    ttree = tree_arrays_from_numpy(jtt.child, blen, device="cpu",
                                   dtype=torch.float64)
    lj = jmc.engine.loglik_mgf(jmc.subst_fixed, jtree, sigma)
    lt = tmc.engine.loglik_mgf(tmc.subst_fixed, ttree, sigma)
    _close(lt, lj, LNL_TOL)
    if sigma > 0:
        # the integrated P differs from plain P(t) at these sigmas
        assert abs(float(lt) - float(tmc.engine.loglik(
            tmc.subst_fixed, ttree))) > 1e-3


@pytest.mark.parametrize("rate_kind", RATE_KINDS)
def test_chain_pieces_match(problem, rate_kind):
    """init_state, move_w, _blen, _lnL and _log_prior at phyml_tpu's
    initial state and at a perturbed one, carried across."""
    jtt, jaln, taln = problem
    jmc, tmc = _chains(jtt, jaln, taln, rate_kind=rate_kind)
    np.testing.assert_allclose(tmc.move_w, np.asarray(jmc.move_w),
                               rtol=1e-15, atol=0)
    assert tmc.move_w[-1] > 0      # MALA on the CPU's plain path
    js0, ts0 = jmc.init_state(), tmc.init_state()
    _close(ts0.lnL, js0.lnL, LNL_TOL)
    _close(ts0.lp, js0.lp, PRIOR_REL, rel=True)
    for js in (js0, _perturbed(jmc)):
        ts = chain_state_from_numpy(_numpy_state(js))
        for a, b in zip(tmc._blen(ts), jmc._blen(js)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-14, atol=1e-300)
        _close(tmc._lnL(ts), jmc._lnL(js), LNL_TOL)
        _close(tmc._log_prior(ts), jmc._log_prior(js), PRIOR_REL, rel=True)


def test_mala_gradient_matches_jax_grad(problem):
    """The gradient MALA drifts along, in (heights, log clock,
    log-rates, log kappa, log alpha): torch.autograd through the plain
    scan (the discrete Gamma's alpha derivative included) against
    jax.grad through phyml_tpu's scan."""
    jtt, jaln, taln = problem
    jmc, tmc = _chains(jtt, jaln, taln, rate_kind="lognormal")
    js = _perturbed(jmc)
    ts = chain_state_from_numpy(_numpy_state(js))
    snames = jmc._movable_subst
    assert snames == tmc._movable_subst == ["kappa", "alpha"]

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
        np.testing.assert_allclose(a.numpy() * mask, b * mask, rtol=0,
                                   atol=LNL_TOL)
    assert np.abs(gt[0].numpy()[internal]).max() > 1.0


# ----------------------------------------------------------------------
# moves
# ----------------------------------------------------------------------
def _variates(name, key, jmc):
    """The variates phyml_tpu's move `name` draws from `key` (the same
    jax.random calls as its _mv_* method), in the port's order."""
    n, nn = jmc.n_otu, jmc.n_nodes
    r = jax.random
    split = lambda: r.split(key)
    if name in ("root_scale", "tree_scale", "clock_scale", "nu_scale",
                "subst_kappa", "subst_alpha", "rates_clock_swap",
                "trait_s2", "tree_clock_swap", "updown_root_clock",
                "nu_rates_updown"):
        return [float(r.uniform(key, ()))]
    k1, k2 = split()
    if name in ("height_slide", "height_jitter", "updown_t_br"):
        return [int(r.randint(k1, (), 0, n - 2)), float(r.uniform(k2, ()))]
    if name in ("rate_walk", "trait_scaler"):
        return [int(r.randint(k1, (), 0, nn - 1)), float(r.normal(k2, ()))]
    if name == "hyper_scale":
        return [int(r.randint(k1, (), 0, len(jmc.hyper_names))),
                float(r.uniform(k2, ())), float(r.normal(k2, ()))]
    if name == "subtree_scale":
        return [int(r.randint(k1, (), n, jmc.root)), float(r.uniform(k2, ()))]
    if name == "subtree_rates":
        return [int(r.randint(k1, (), n, jmc.root)), float(r.normal(k2, ()))]
    if name == "rate_exchange":
        return [int(r.randint(k1, (), 0, n - 1)), float(r.normal(k2, ()))]
    if name in ("time_slice", "time_slice_br"):
        return [float(r.uniform(k1, ())), float(r.uniform(k2, ()))]
    raise KeyError(name)


def _jax_move(jmc, name):
    if name.startswith("subst_"):
        nm = name[len("subst_"):]
        return jmc._mv_subst(nm, 0.05 if nm == "kappa" else 0.01, 100.0)
    return getattr(jmc, f"_mv_{name}")


SCALAR_MOVES = [nm for nm in JMCMC.MOVE_NAMES
                if nm not in ("mala_times", "cov_switch", "cov_rates")]


@pytest.mark.parametrize("rate_kind", ["lognormal", "guindon"])
def test_scalar_moves_match(problem, rate_kind):
    """Every scalar move's proposal, log Hastings and affects-lnL from
    the variates phyml_tpu drew, at a perturbed state, over 6 keys and
    two step sizes."""
    jtt, jaln, taln = problem
    jmc, tmc = _chains(jtt, jaln, taln, rate_kind=rate_kind,
                       prior_kind="birthdeath")
    js = _perturbed(jmc)
    ts = chain_state_from_numpy(_numpy_state(js))
    for name in SCALAR_MOVES:
        mv = TMCMC.MOVE_NAMES.index(name)
        for k in range(6):
            key = jax.random.PRNGKey(100 * mv + k)
            step = float(jmc.step[mv]) * (1.0 if k % 2 else 3.0)
            jp, jh, ja = _jax_move(jmc, name)(js, key, step)
            tp, th, ta = tmc.propose(
                ts, mv, step, [torch.tensor(v, dtype=torch.float64)
                               if isinstance(v, float) else v
                               for v in _variates(name, key, jmc)])
            assert bool(ta) == bool(ja), name
            _close(th, jh, MOVE_TOL * max(1.0, abs(float(jh))))
            for f in ("heights", "log_r", "log_clock", "log_nu",
                      "log_s2x", "trait_lr"):
                np.testing.assert_allclose(
                    getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                    rtol=MOVE_TOL, atol=MOVE_TOL, err_msg=f"{name} {f}")
            for d in ("hyper", "subst"):
                for nm, v in getattr(jp, d).items():
                    _close(getattr(tp, d)[nm], v, MOVE_TOL, rel=True)


def test_topology_steps_match(problem):
    """50 topology_step calls from one state and one numpy seed: the
    same kinds, child tables, heights and accept decisions."""
    jtt, jaln, taln = problem
    # a start away from the simulating topology, so that moves accept
    start = JTimeTree.coalescent(N_TAXA, np.random.default_rng(99),
                                 theta=0.4, names=list(jtt.names))
    jmc, tmc = _chains(start, jaln, taln, rate_kind="lognormal",
                       sample_topology=True, cals=0)
    js = jmc.init_state()
    ts = chain_state_from_numpy(_numpy_state(js))
    rj, rt = np.random.default_rng(77), np.random.default_rng(77)
    accepted = 0
    for _ in range(50):
        js, kj, aj = jmc.topology_step(js, rj)
        ts, kt, at = tmc.topology_step(ts, rt)
        assert (kt, at) == (kj, aj)
        accepted += at
        np.testing.assert_array_equal(ts.child.numpy(), np.asarray(js.child))
        np.testing.assert_array_equal(ts.parent.numpy(),
                                      np.asarray(js.parent))
        np.testing.assert_allclose(ts.heights.numpy(), np.asarray(js.heights),
                                   rtol=0, atol=0)
        _close(ts.lnL, js.lnL, LNL_TOL)
    assert accepted > 0


# ----------------------------------------------------------------------
# whole chains
# ----------------------------------------------------------------------
def test_chains_agree_in_distribution(problem):
    """One chain in each package (lognormal clock, birth-death, a root
    calibration, 3,000 iterations, 1,000 burn-in): posterior means of
    the root height and the log clock agree within 4 Monte Carlo
    standard errors.  On this fixture the standard errors are ~0.002-
    0.01 in root height and ~0.02-0.05 in log clock (each printed)."""
    jtt, jaln, taln = problem
    settings = dict(n_iter=3000, burnin=1000, batch=250, seed=5)
    jmc, tmc = _chains(jtt, jaln, taln, settings=settings, cals=1)
    _, tr_j, _ = jmc.run()
    _, tr_t, _ = tmc.run()
    for col, label in ((2, "root height"), (3, "log clock")):
        a, b = tr_j[1000:, col], tr_t[1000:, col]
        se = np.hypot(a.std() / np.sqrt(effective_sample_size(a)),
                      b.std() / np.sqrt(effective_sample_size(b)))
        print(f"{label}: phyml_tpu {a.mean():.5f}  port {b.mean():.5f}  "
              f"standard error {se:.5f}")
        assert abs(a.mean() - b.mean()) <= 4.0 * se, label


def _port_chain(problem, rate_kind="lognormal", n_iter=600, **kw):
    jtt, jaln, taln = problem
    _, tmc = _chains(jtt, jaln, taln, rate_kind=rate_kind,
                     settings=dict(n_iter=n_iter, burnin=200, batch=100,
                                   seed=9), **kw)
    return tmc


def test_cached_lnl_equals_recompute_and_seed_repeats(problem):
    tmc = _port_chain(problem, sample_topology=True,
                      topo_moves_per_batch=10)
    st, trace, acc = tmc.run()
    _close(st.lnL, tmc._lnL(st), LNL_TOL)
    _close(st.lp, tmc._log_prior(st), PRIOR_REL, rel=True)
    assert np.isfinite(trace).all() and trace[:, 0].std() > 0
    assert tmc.topo_tries == 60
    heights, par = st.heights.numpy(), st.parent.numpy()
    assert (heights[par] - heights)[:-1].min() >= -1e-12
    # the calibrated clades' MRCAs in the final tree hold their bounds
    tt = TTimeTree(n_otu=tmc.n_otu, child=st.child.numpy(),
                   heights=heights, names=tmc.tt.names)
    for c in tmc.prior_spec.calibrations:
        h = heights[c.resolved(tt).node]
        assert c.lower <= h <= c.upper
    again = _port_chain(problem, sample_topology=True,
                        topo_moves_per_batch=10)
    st2, trace2, _ = again.run()
    np.testing.assert_array_equal(trace2, trace)
    np.testing.assert_array_equal(st2.heights.numpy(), heights)


def test_checkpoint_resume_ends_where_the_chain_ends(problem, tmp_path):
    full = _port_chain(problem, n_iter=400, sample_topology=True,
                       topo_moves_per_batch=5)
    st_full, _, _ = full.run()
    ck = str(tmp_path / "chain.npz")
    half = _port_chain(problem, n_iter=200, sample_topology=True,
                       topo_moves_per_batch=5)
    half.run(checkpoint_path=ck)
    rest = _port_chain(problem, n_iter=400, sample_topology=True,
                       topo_moves_per_batch=5)
    st, trace, _ = rest.run(checkpoint_path=ck)
    assert trace.shape[0] == 200
    for f in ("child", "heights", "log_r", "log_clock", "lnL", "lp"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      getattr(st_full, f).numpy())
    assert rest.topo_tries == full.topo_tries


def test_guindon_chain_runs_on_the_mgf_path(problem, monkeypatch):
    tmc = _port_chain(problem, rate_kind="guindon", n_iter=200)
    calls = {"lnL": 0, "mgf": 0}

    def counted(fn, key):
        def run(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(tmc.engine, "_loglik_mgf_sys",
                        counted(tmc.engine._loglik_mgf_sys, "mgf"))
    monkeypatch.setattr(tmc, "_lnL", counted(tmc._lnL, "lnL"))
    st, _, _ = tmc.run()
    assert calls["mgf"] == calls["lnL"] > 50
    blen, _ = tmc._blen(st)
    tree = tree_arrays_from_numpy(st.child.numpy(), blen.numpy(),
                                  device="cpu", dtype=torch.float64)
    _close(st.lnL, tmc.engine.loglik_mgf(
        {**tmc.subst_fixed, **st.subst}, tree, torch.exp(st.log_nu)),
        LNL_TOL)


@pytest.mark.parametrize("what", ["trait_x", "fastlk", "covarion"])
def test_refusals_name_their_roadmap_items(problem, what):
    """trait_x, covarion and fastlk, each refused until its port, now
    build chains: with trait_x the trait moves get phyml_tpu's weights
    (tests/test_torch_phyrex.py holds the chain to phyml_tpu), the
    covarion moves are drawn (tests/test_torch_covarion.py), and a
    fastlk chain holds its substitution parameters and MALA off
    (tests/test_torch_fastlk.py)."""
    jtt, jaln, taln = problem
    tm = TModel(datatype="nt", name="HKY85", n_classes=4,
                covarion=what == "covarion")
    tp = tm.init_params(taln.obs_state_freqs)
    eng = TEngine(taln, tm, dtype=torch.float64, device="cpu")
    if what == "covarion":
        mc = TMCMC(eng, tm, tp, _tt_port(jtt), TRates(), TPrior())
        assert mc.move_w[TMCMC.MOVE_NAMES.index("cov_switch")] > 0
        return
    if what == "fastlk":
        mc = TMCMC(eng, tm, tp, _tt_port(jtt), TRates(), TPrior(),
                   fastlk=True)
        for nm in ("subst_kappa", "subst_alpha", "mala_times"):
            assert mc.move_w[TMCMC.MOVE_NAMES.index(nm)] == 0.0
        assert mc._normal_approx is not None
        return
    jm = JModel(datatype="nt", name="HKY85", n_classes=4)
    jp = jm.init_params(jaln.obs_state_freqs)
    x = np.random.default_rng(2).normal(size=(N_TAXA, 2))
    jmc = JMCMC(JEngine(jaln, jm, dtype=jnp.float64), jm, jp, jtt, JRates(),
                JPrior(), trait_x=x)
    mc = TMCMC(eng, tm, tp, _tt_port(jtt), TRates(), TPrior(), trait_x=x)
    np.testing.assert_allclose(mc.move_w, np.asarray(jmc.move_w), rtol=1e-15)
    for nm in ("trait_s2", "trait_scaler"):
        assert mc.move_w[TMCMC.MOVE_NAMES.index(nm)] > 0
    st = mc.init_state()
    assert np.isfinite(float(st.lp)) and np.isfinite(float(st.lnL))
