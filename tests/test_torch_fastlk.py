"""The fastlk normal approximation and Brent's method of the port
against phyml_tpu, on the CPU.

On the dating fixture of tests/test_torch_bayes.py (6 taxa, 120 sites,
HKY85+G4, float64 engines):

* `fit_normal_approx` at the chronogram's durations (where a fastlk
  chain expands): lnL0, the gradient and the Hessian within 1e-6
  relative (NA_REL) of phyml_tpu's `jax.hessian`, the root slot left
  out (its length is 0 and unused, so its derivatives are the roundoff
  of P(0), different in each package, and the mask drops them); the
  same on a 12-taxon GTR+G4+I tree, and chunked against unchunked;
* `NormalApprox.loglik` at perturbed lengths, against phyml_tpu's and
  near the exact lnL;
* `MCMC(fastlk=True)`: the move-weight vector equal to phyml_tpu's (the
  substitution moves and MALA off), and a 40-step chain fed
  phyml_tpu's variates (tests/test_torch_bayes.py's `_variates`): the
  same proposals, approximate lnL, priors and accept decisions;
* the refusals phyml_tpu keeps: fastlk under the Guindon clock and
  with topology moves;
* `brent_maximize` and `bracket_maximum` against phyml_tpu's on three
  functions: the same points and values.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu.ops.likelihood import TreeArrays as JTree
from phyml_tpu.optim import brent as jbrent
from phyml_tpu.optim.fastlk import fit_normal_approx as jfit
from phyml_tpu_torch.bayes.mcmc import MCMC as TMCMC
from phyml_tpu_torch.bayes.rates import RateModel as TRates
from phyml_tpu_torch.bayes.times import TimePrior as TPrior
from phyml_tpu_torch.interop import chain_state_from_numpy, tree_arrays_from_numpy
from phyml_tpu_torch.optim import brent as tbrent
from phyml_tpu_torch.optim import brent_maximize
from phyml_tpu_torch.optim.fastlk import fit_normal_approx as tfit
from test_torch_bayes import (
    _chains, _jax_move, _numpy_state, _problem, _tt_port, _variates,
)
from test_torch_bionj import _engines

NA_REL = 1e-6
STEP_TOL = 1e-9


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    return _problem(tmp_path_factory.mktemp("fastlk"))


def _close_rel(got, want, rel=NA_REL):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _compare(ta, ja, n_free):
    """Two NormalApprox on their first n_free slots."""
    _close_rel(float(ta.lnL0), float(ja.lnL0))
    _close_rel(ta.grad.numpy()[:n_free], np.asarray(ja.grad)[:n_free])
    _close_rel(ta.hess.numpy()[:n_free, :n_free],
               np.asarray(ja.hess)[:n_free, :n_free])
    np.testing.assert_array_equal(ta.mask.numpy(), np.asarray(ja.mask))


def test_normal_approx_matches_phyml_tpu_on_the_chronogram(problem):
    jtt, jaln, taln = problem
    jmc, tmc = _chains(jtt, jaln, taln, fastlk=True)
    ja, ta = jmc._normal_approx, tmc._normal_approx
    assert ta.hess.dtype == torch.float64 and ta.hess.device.type == "cpu"
    _compare(ta, ja, jmc.n_nodes - 1)
    assert np.abs(ta.hess.numpy()).max() > 1.0
    # symmetric, and the quadratic surface at perturbed lengths
    h = ta.hess.numpy()[:-1, :-1]
    np.testing.assert_allclose(h, h.T, rtol=0, atol=1e-8 * np.abs(h).max())
    rng = np.random.default_rng(2)
    b0 = ta.b0.numpy()
    for scale in (1e-3, 1e-2):
        b = b0 * np.exp(scale * rng.standard_normal(b0.shape))
        want = float(ja.loglik(jnp.asarray(b)))
        _close_rel(float(ta.loglik(torch.as_tensor(b))), want)
    # near the expansion point the surface is the exact lnL to o(db^2)
    b = b0 + 1e-4 * np.abs(rng.standard_normal(b0.shape))
    b[-1] = 0.0
    tree = tree_arrays_from_numpy(np.asarray(jtt.child), b, device="cpu",
                                  dtype=torch.float64)
    exact = float(tmc.engine.loglik(tmc.subst_fixed, tree))
    assert abs(float(ta.loglik(torch.as_tensor(b))) - exact) < 1e-3


def test_normal_approx_matches_phyml_tpu_gtr_invar(tmp_path):
    """GTR+G4+I at 12 taxa on a time-like tree (every non-root edge
    positive), and chunked vmaps against one."""
    jeng, jp, teng, tp, topo = _engines("nt", tmp_path, invar=True)
    rv = topo.rooted()
    blen = np.asarray(rv.node_blen).copy()
    blen[:-1] = np.maximum(blen[:-1], 0.01)
    ja = jfit(jeng, jp, JTree(child=jnp.asarray(rv.child, dtype=jnp.int32),
                              blen=jnp.asarray(blen)), jeng.weights)
    tree = tree_arrays_from_numpy(rv.child, blen, device="cpu",
                                  dtype=torch.float64)
    ta = tfit(teng, tp, tree)
    _compare(ta, ja, teng.n_nodes - 1)
    tb = tfit(teng, tp, tree, chunk_size=5)
    np.testing.assert_allclose(tb.hess.numpy(), ta.hess.numpy(), rtol=0,
                               atol=1e-10)


def test_fastlk_move_weights_match_phyml_tpu(problem):
    jtt, jaln, taln = problem
    for kind in ("lognormal", "strict"):
        jmc, tmc = _chains(jtt, jaln, taln, rate_kind=kind, fastlk=True)
        np.testing.assert_allclose(tmc.move_w, np.asarray(jmc.move_w),
                                   rtol=1e-15, atol=0)
        assert tmc._movable_subst == jmc._movable_subst == []
        names = TMCMC.MOVE_NAMES
        for nm in ("subst_kappa", "subst_alpha", "mala_times"):
            assert tmc.move_w[names.index(nm)] == 0.0


def test_fastlk_chain_fed_phyml_tpu_variates(problem):
    """40 steps over the lnL-affecting moves with nonzero weight, each
    fed the variates phyml_tpu drew: the same proposal, Hastings term,
    approximate lnL, prior and accept decision (one shared uniform),
    and the chain goes on from the accepted state in both."""
    jtt, jaln, taln = problem
    jmc, tmc = _chains(jtt, jaln, taln, rate_kind="lognormal", fastlk=True)
    js = jmc.init_state()
    ts = chain_state_from_numpy(_numpy_state(js))
    assert abs(float(ts.lnL) - float(js.lnL)) <= STEP_TOL * abs(float(js.lnL))
    names = [nm for i, nm in enumerate(TMCMC.MOVE_NAMES)
             if tmc.move_w[i] > 0 and nm != "mala_times"]
    rng = np.random.default_rng(8)
    accepted = 0
    for k in range(40):
        name = names[k % len(names)]
        mv = TMCMC.MOVE_NAMES.index(name)
        key = jax.random.PRNGKey(1000 + k)
        step = float(jmc.step[mv])
        jp, jh, ja = _jax_move(jmc, name)(js, key, step)
        tp, th, ta = tmc.propose(
            ts, mv, step, [torch.tensor(v, dtype=torch.float64)
                           if isinstance(v, float) else v
                           for v in _variates(name, key, jmc)])
        assert bool(ta) == bool(ja), name
        j_lp, t_lp = float(jmc._log_prior(jp)), float(tmc._log_prior(tp))
        j_l = float(jmc._lnL(jp)) if ja else float(js.lnL)
        t_l = float(tmc._lnL(tp)) if ta else float(ts.lnL)
        assert abs(t_l - j_l) <= STEP_TOL * max(1.0, abs(j_l)), name
        if j_lp > -1e20:
            assert abs(t_lp - j_lp) <= STEP_TOL * max(1.0, abs(j_lp)), name
        u = math.log(rng.random())
        j_acc = j_lp > -1e20 and u < (j_l + j_lp) - float(js.lnL + js.lp) \
            + float(jh)
        t_acc = t_lp > -1e20 and u < (t_l + t_lp) - float(ts.lnL + ts.lp) \
            + float(th)
        assert t_acc == j_acc, name
        if j_acc:
            accepted += 1
            js = jp._replace(lnL=jnp.asarray(j_l), lp=jnp.asarray(j_lp))
            ts = tp._replace(lnL=torch.tensor(t_l, dtype=torch.float64),
                             lp=torch.tensor(t_lp, dtype=torch.float64))
    assert accepted > 5
    np.testing.assert_allclose(ts.heights.numpy(), np.asarray(js.heights),
                               rtol=1e-12, atol=1e-12)


def test_fastlk_chain_runs_without_a_traversal(problem, monkeypatch):
    """A port fastlk chain: its lnL never reaches the engine once the
    approximation is fitted, and its cached lnL is the surface's."""
    jtt, jaln, taln = problem
    _, tmc = _chains(jtt, jaln, taln, rate_kind="strict", fastlk=True,
                     settings=dict(n_iter=300, burnin=100, batch=100,
                                   seed=4))

    def no_pass(*a, **k):
        raise AssertionError("a fastlk chain ran a likelihood pass")

    for nm in ("_loglik_sys", "loglik", "_loglik_mgf_sys"):
        monkeypatch.setattr(tmc.engine, nm, no_pass)
    st, trace, _ = tmc.run()
    assert np.isfinite(trace[:, 0]).all()
    assert abs(float(st.lnL) - float(tmc._lnL(st))) < 1e-6


@pytest.mark.parametrize("what", ["guindon", "sample_topology"])
def test_fastlk_refusals_kept(problem, what):
    jtt, jaln, taln = problem
    from phyml_tpu_torch.models.substitution import SubstModel as TModel
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine

    tm = TModel(datatype="nt", name="HKY85", n_classes=4)
    eng = TEngine(taln, tm, dtype=torch.float64, device="cpu")
    kw = dict(fastlk=True)
    rates = TRates(kind="guindon" if what == "guindon" else "lognormal")
    if what == "sample_topology":
        kw["sample_topology"] = True
    msg = "Guindon" if what == "guindon" else "ONE topology"
    with pytest.raises(ValueError, match=msg):
        TMCMC(eng, tm, tm.init_params(taln.obs_state_freqs), _tt_port(jtt),
              rates, TPrior(), **kw)


FUNCS = [
    ("quadratic", lambda x: -(x - 0.3) ** 2, 0.0, 2.0),
    ("log-like", lambda x: 3.0 * math.log(x) - 2.0 * x, 1e-3, 10.0),
    ("cosine", lambda x: math.cos(x) + 0.1 * x, -2.0, 2.0),
]


@pytest.mark.parametrize("name, f, lo, hi", FUNCS, ids=[f[0] for f in FUNCS])
def test_brent_matches_phyml_tpu(name, f, lo, hi):
    for x0 in (None, 0.5 * (lo + hi)):
        for tol in (1e-4, 1e-8):
            want = jbrent.brent_maximize(f, lo, hi, tol=tol, x0=x0)
            assert brent_maximize(f, lo, hi, tol=tol, x0=x0) == want
    assert tbrent.bracket_maximum(f, lo + 0.1, lo + 0.2) == \
        jbrent.bracket_maximum(f, lo + 0.1, lo + 0.2)
