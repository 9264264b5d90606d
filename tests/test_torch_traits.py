"""The PhyREX movement models (bayes/traits.py) against phyml_tpu on
the CPU.

Inputs are made from a seed with numpy on 8- and 13-taxon coalescent
chronograms with D = 2 coordinates (simulated as Brownian motion down
the tree) and handed to both packages in float64 (phyml_tpu under
jax_enable_x64, as tests/conftest.py sets it).  Held within 1e-10
relative (DENS_REL): brownian_loglik, the RRW edge variances and
scaler prior, IntegratedModel.transition and transition_logpdf for
ibm, iwn and iou, location_loglik for rw and rrw; the MRCA tables
(tips, and all nodes) and the parent vector exactly, phyml_tpu's
traced table included, on the start genealogy and on genealogies
after topology moves; posterior_state_samples from one numpy seed (the
same draws) within 1e-9.  Gradients (which MALA takes) within 1e-8
relative of jax.grad.

marginal_loglik (the integrated kinds' location term) is held to a
60-digit mpmath evaluation of the same construction: the port's error
at most ORACLE_FACTOR times phyml_tpu's, or 1e-10 relative.  The
construction is ill-conditioned in float64 in both packages: at the
default root_var = 1e6 the [n, n] tip covariance has a condition
number of 1e11-1e16 on these trees (short cherries: IBM's dt^3 / 3),
and IOU inverts transition products e^{-theta dt}; the two LAPACKs
then differ by up to 1e-2 relative while each stays near the exact
value's own float64 error.  On a 6-taxon tree of unit-scale edges the
gradient agrees within 1e-8 relative of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu.bayes import traits as jtr
from phyml_tpu.bayes.chrono import TimeTree as JTimeTree
from phyml_tpu_torch.bayes import traits as ttr

DENS_REL = 1e-10
GRAD_REL = 1e-8
ORACLE_FACTOR = 32.0
KINDS = ["rw", "rrw", "ibm", "iwn", "iou"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(n, seed, theta=0.7):
    """(chronogram, tip coordinates [n, 2], dt [2n-1], RRW log
    scalers [2n-1]) from one numpy seed: the coordinates Brownian
    motion (sigma^2 0.8) down the tree from the origin."""
    rng = np.random.default_rng(seed)
    tt = JTimeTree.coalescent(n, rng, theta=theta)
    dt = tt.edge_durations()
    par = tt.parent
    xs = np.zeros((tt.n_nodes, 2))
    for u in range(tt.n_nodes - 2, -1, -1):
        xs[u] = xs[par[u]] + np.sqrt(0.8 * dt[u]) * rng.normal(size=2)
    lr = 0.4 * rng.standard_normal(tt.n_nodes)
    return tt, xs[:n], dt, lr


def _unit_tree():
    """A 6-taxon chronogram of unit-scale edges, and coordinates:
    the case where every kind's construction is well conditioned."""
    child = np.array([[0, 1], [2, 3], [6, 4], [7, 5], [8, 9]])
    heights = np.array([0, 0, 0, 0, 0, 0, 1.1, 0.9, 2.2, 1.7, 3.1])
    tt = JTimeTree(n_otu=6, child=child, heights=heights,
                   names=[f"t{i}" for i in range(6)])
    x = np.random.default_rng(8).normal(size=(6, 2)) * 1.5
    return tt, x, tt.edge_durations()


def _mp_marginal(kind, x, child, dt, s2, theta, root_var, dps=60):
    """marginal_loglik at dps digits: the same construction (T, Sigma
    down the tree, G = T^-1 Sigma T^-T, S from the MRCA table, its
    Cholesky) in mpmath."""
    import mpmath as mp

    with mp.workdps(dps):
        n, D = x.shape
        N = 2 * n - 1
        par = [N - 1] * N
        for i in range(n - 1):
            par[int(child[i, 0])] = par[int(child[i, 1])] = n + i
        anc = []
        for u in range(n):
            p = [u]
            while p[-1] != N - 1:
                p.append(par[p[-1]])
            anc.append(p)
        mrca = [[next(a for a in anc[j] if a in set(anc[i]))
                 for j in range(n)] for i in range(n)]
        s2, rv, th = mp.mpf(s2), mp.mpf(root_var), mp.mpf(theta)
        d = [mp.mpf(float(v)) for v in dt]
        S = mp.matrix(n, n)
        if kind == "iwn":
            cum = [mp.mpf(0)] * N
            for u in range(N - 2, -1, -1):
                cum[u] = cum[par[u]] + s2 * d[u] ** 2
            for i in range(n):
                for j in range(n):
                    S[i, j] = rv + cum[mrca[i][j]]
        else:
            Sig, T = [None] * N, [None] * N
            Sig[N - 1], T[N - 1] = rv * mp.eye(2), mp.eye(2)
            for u in range(N - 2, -1, -1):
                t = d[u]
                if kind == "ibm":
                    A = mp.matrix([[1, t], [0, 1]])
                    Q = s2 * mp.matrix([[t ** 3 / 3, t ** 2 / 2],
                                        [t ** 2 / 2, t]])
                else:
                    e = mp.exp(-th * t)
                    A = mp.matrix([[1, (1 - e) / th], [0, e]])
                    q12 = s2 / (2 * th ** 2) * (1 - e) ** 2
                    Q = mp.matrix([
                        [s2 / th ** 2 * (t - 2 * (1 - e) / th
                                         + (1 - e ** 2) / (2 * th)), q12],
                        [q12, s2 / (2 * th) * (1 - e ** 2)]])
                Sig[u] = A * Sig[par[u]] * A.T + Q
                T[u] = A * T[par[u]]
            G = [T[u] ** -1 * Sig[u] * (T[u] ** -1).T for u in range(N)]
            for i in range(n):
                for j in range(n):
                    S[i, j] = (T[i][0, :] * G[mrca[i][j]] * T[j][0, :].T)[0, 0]
        L = mp.cholesky(S)
        quad = mp.mpf(0)
        for k in range(D):
            z = mp.lu_solve(L, mp.matrix([mp.mpf(float(v)) for v in x[:, k]]))
            quad += sum(v ** 2 for v in z)
        ldet = 2 * sum(mp.log(L[i, i]) for i in range(n))
        return float(-(quad + D * ldet + D * n * mp.log(2 * mp.pi)) / 2)


def _mp_transition_logpdf(A, Q, states, parent, jitter=1e-12, dps=60):
    """transition_logpdf at dps digits from float64 (A, Q)."""
    import mpmath as mp

    with mp.workdps(dps):
        N, D = states.shape[:2]
        tot = mp.mpf(0)
        for u in range(N - 1):
            Qj = mp.matrix(Q[u].tolist()) + mp.mpf(jitter) * mp.eye(2)
            Au = mp.matrix(A[u].tolist())
            for k in range(D):
                r = mp.matrix(states[u, k].tolist()) \
                    - Au * mp.matrix(states[parent[u], k].tolist())
                tot += (r.T * Qj ** -1 * r)[0, 0]
            tot += D * (mp.log(mp.det(Qj)) + 2 * mp.log(2 * mp.pi))
        return float(-tot / 2)


CASES = [(8, 1), (13, 2)]


def _rel(a, b, rel=DENS_REL):
    a, b = float(a), float(b)
    assert abs(a - b) <= rel * max(1.0, abs(a), abs(b)), (a, b)


@pytest.mark.parametrize("n, seed", CASES)
def test_brownian_and_rrw_pieces_match(n, seed):
    tt, x, dt, lr = _case(n, seed)
    child = np.asarray(tt.child)
    ev = 0.7 * dt
    _rel(ttr.brownian_loglik(x, torch.as_tensor(child), ev),
         jtr.brownian_loglik(jnp.asarray(x), jnp.asarray(child),
                             jnp.asarray(ev)))
    root = tt.root
    np.testing.assert_allclose(
        ttr.rrw_edge_var(0.7, torch.as_tensor(dt), lr, root).numpy(),
        np.asarray(jtr.rrw_edge_var(0.7, jnp.asarray(dt), jnp.asarray(lr),
                                    root)), rtol=DENS_REL, atol=0)
    for nu in (1e-12, 0.3, 1.0):
        _rel(ttr.rrw_scaler_log_prior(lr, nu, root),
             jtr.rrw_scaler_log_prior(jnp.asarray(lr), jnp.asarray(nu),
                                      root))


@pytest.mark.parametrize("kind", ["ibm", "iwn", "iou"])
@pytest.mark.parametrize("n, seed", CASES)
def test_integrated_model_matches(kind, n, seed):
    """transition (A, Q) at every edge and transition_logpdf at random
    latent states within 1e-10 relative; marginal_loglik at root_var
    1e6 and 1 against the mpmath oracle; for theta 1 and 0.3."""
    tt, x, dt, _ = _case(n, seed)
    child = np.asarray(tt.child)
    rng = np.random.default_rng(seed + 10)
    states = rng.normal(size=(tt.n_nodes, 2, 2))
    jm, tm = jtr.IntegratedModel(kind=kind), ttr.IntegratedModel(kind=kind)
    for theta in (1.0, 0.3):
        ja, jq = jm.transition(jnp.asarray(dt), 0.8, theta)
        ta, tq = tm.transition(torch.as_tensor(dt), 0.8, theta)
        # relative to the largest entry: IOU's q11 cancels at short
        # edges, where one ulp of exp(-theta dt) moves its last digits
        for a, b in ((ta, ja), (tq, jq)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=DENS_REL,
                                       atol=DENS_REL * np.abs(b).max())
        t = tm.transition_logpdf(states, torch.as_tensor(child), dt, 0.8,
                                 theta)
        j = jm.transition_logpdf(jnp.asarray(states), jnp.asarray(child),
                                 jnp.asarray(dt), 0.8, theta)
        if kind != "iwn":
            _rel(t, j)
        else:
            # IWN's Q is singular (rank one) but for the 1e-12 jitter:
            # its inverse's condition number is ~1e12 in both packages
            exact = _mp_transition_logpdf(np.asarray(ja), np.asarray(jq),
                                          states, tt.parent)
            assert abs(float(t) - exact) <= max(
                ORACLE_FACTOR * abs(float(j) - exact),
                DENS_REL * abs(exact)), (float(t), float(j), exact)
        # at 13 taxa and root_var 1e6 the covariance is singular to
        # float64 (condition number ~1e16: phyml_tpu's Cholesky fails
        # on the iou case), so there neither value means anything
        for rv in ((1e6, 1.0) if n < 10 else (1.0,)):
            exact = _mp_marginal(kind, x, child, dt, 0.8, theta, rv)
            t = float(tm.marginal_loglik(x, torch.as_tensor(child), dt, 0.8,
                                         theta, root_var=rv))
            j = float(jm.marginal_loglik(jnp.asarray(x), child,
                                         jnp.asarray(dt), 0.8, theta,
                                         root_var=rv))
            assert abs(t - exact) <= max(ORACLE_FACTOR * abs(j - exact),
                                         DENS_REL * abs(exact)), \
                (rv, t, j, exact)


def _location_grad_check(kind, x, child, dt, lr, s2):
    """location_loglik and its gradient in (dt, sigma^2, RRW scalers)
    against phyml_tpu's value and jax.grad; returns both values."""
    def jf(dt_, s2_, lr_):
        return jtr.location_loglik(kind, jnp.asarray(x), jnp.asarray(child),
                                   dt_, s2_, log_scalers=lr_,
                                   nu=jnp.asarray(0.6))

    args = (jnp.asarray(dt), jnp.asarray(s2), jnp.asarray(lr))
    want = jf(*args)
    gj = jax.grad(jf, argnums=(0, 1, 2))(*args)
    ts = [torch.tensor(np.asarray(a), requires_grad=True) for a in args]
    got = ttr.location_loglik(kind, torch.as_tensor(x),
                              torch.as_tensor(child), ts[0], ts[1],
                              log_scalers=ts[2], nu=0.6)
    gt = torch.autograd.grad(got, ts, allow_unused=True)
    got = got.detach()
    for a, b in zip(gt, gj):
        b = np.asarray(b)
        a = np.zeros_like(b) if a is None else a.numpy()
        np.testing.assert_allclose(a, b, rtol=GRAD_REL,
                                   atol=GRAD_REL * np.abs(b).max())
    return float(got), float(want)


@pytest.mark.parametrize("kind", ["rw", "rrw"])
def test_brownian_location_loglik_and_gradient_match(kind):
    """rw and rrw on a 13-taxon coalescent tree (the child table
    traced in phyml_tpu, as a chain with topology moves scores it)."""
    tt, x, dt, lr = _case(13, 3)
    _rel(*_location_grad_check(kind, x, np.asarray(tt.child), dt, lr, 1.3))


@pytest.mark.parametrize("kind", ["ibm", "iwn", "iou"])
def test_integrated_location_loglik_and_gradient_match(kind):
    """The integrated kinds where their construction is well
    conditioned (the unit-scale tree; root_var 1e6 as the chain
    scores it): the value within 1e-10 relative, the gradient within
    1e-8 of jax.grad; on the 13-taxon coalescent tree the value
    against the mpmath oracle."""
    tt, x, dt = _unit_tree()
    child = np.asarray(tt.child)
    t, j = _location_grad_check(kind, x, child, dt, np.zeros(tt.n_nodes),
                                1.3)
    exact = _mp_marginal(kind, x, child, dt, 1.3, 1.0, 1e6)
    assert abs(t - exact) <= max(ORACLE_FACTOR * abs(j - exact),
                                 DENS_REL * abs(exact)), (t, j, exact)
    tt, x, dt, _ = _case(8, 3)
    child = np.asarray(tt.child)
    exact = _mp_marginal(kind, x, child, dt, 1.3, 1.0, 1e6)
    t = float(ttr.location_loglik(kind, torch.as_tensor(x),
                                  torch.as_tensor(child), dt, 1.3))
    j = float(jtr.location_loglik(kind, jnp.asarray(x), jnp.asarray(child),
                                  jnp.asarray(dt), 1.3))
    assert abs(t - exact) <= max(ORACLE_FACTOR * abs(j - exact),
                                 DENS_REL * abs(exact)), (t, j, exact)


def _move_genealogies(tt, n_moves, seed):
    """Child tables visited by accepted narrow exchanges and
    prune-regrafts from tt (the chain's own proposals, renumbered to
    postorder)."""
    from phyml_tpu_torch.bayes.mcmc import MCMC

    rng = np.random.default_rng(seed)
    mc = MCMC.__new__(MCMC)
    mc.n_otu, mc.root = tt.n_otu, tt.root
    child = np.asarray(tt.child, dtype=np.int64)
    parent = np.asarray(tt.parent, dtype=np.int64)
    heights = np.asarray(tt.heights)
    out = []
    while len(out) < n_moves:
        fn = mc._narrow_exchange if rng.random() < 0.5 else mc._spr_times
        res = fn(child, parent, heights, rng)
        if res is None:
            continue
        ch, pa, _ = res
        child, parent, perm = MCMC._renumber_postorder(ch, pa, tt.n_otu)
        heights = heights[np.argsort(perm)]
        out.append(child.copy())
    return out


@pytest.mark.parametrize("n, seed", CASES)
def test_mrca_tables_match_exactly(n, seed):
    """_mrca_table (tips), _mrca_table_all (all nodes, with the parent
    vector) and _parent_from_child against phyml_tpu's host and traced
    tables, on the start genealogy and 12 after topology moves."""
    tt, *_ = _case(n, seed)
    tables = [np.asarray(tt.child, dtype=np.int64)] + \
        _move_genealogies(tt, 12, seed)
    traced = jax.jit(jtr._mrca_table_traced, static_argnums=1)
    for child in tables:
        want = jtr._mrca_table(child, n)
        np.testing.assert_array_equal(ttr._mrca_table(child, n), want)
        np.testing.assert_array_equal(
            np.asarray(traced(jnp.asarray(child), n)), want)
        tm, tp = ttr._mrca_table_all(child, n)
        jm, jp = jtr._mrca_table_all(child, n)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(
            ttr._parent_from_child(torch.as_tensor(child), n).numpy(),
            np.asarray(jtr._parent_from_child(jnp.asarray(child), n)))
    assert len({c.tobytes() for c in tables}) > 3


@pytest.mark.parametrize("kind", ["ibm", "iwn", "iou"])
def test_posterior_state_samples_match(kind):
    """The exact moments (mean, sd) within 1e-9, and for ibm and iwn
    the same draws from one numpy seed (both packages draw with the
    same Generator calls), on the unit-scale tree.  IOU's latent
    covariance has near-degenerate eigenvalues, so its symmetric square
    root's eigenbasis turns with the last ulp of the transitions: its
    draws are held in distribution (2,048 of them, each package's mean
    within 5 standard errors of the exact mean)."""
    tt, x, dt = _unit_tree()
    child = np.asarray(tt.child)
    S = 2048 if kind == "iou" else 16
    j = jtr.posterior_state_samples(kind, x, child, dt, 0.9, n_samples=S,
                                    rng=np.random.default_rng(11))
    t = ttr.posterior_state_samples(kind, x, torch.as_tensor(child), dt, 0.9,
                                    n_samples=S,
                                    rng=np.random.default_rng(11))
    for a, b in zip(t[1:], j[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-9,
                                   atol=1e-9 * np.abs(b).max())
    if kind != "iou":
        np.testing.assert_allclose(t[0], j[0], rtol=1e-9,
                                   atol=1e-9 * np.abs(j[0]).max())
        return
    mean, sd = j[1], j[2]
    for smp in (t[0], j[0]):
        se = sd / np.sqrt(S)
        gap = np.abs(smp.mean(0) - mean)
        assert np.all(gap <= 5.0 * se + 1e-12), gap.max()


def test_path_cumsum_matches():
    tt, _, dt, _ = _case(13, 5)
    par = np.asarray(tt.parent, dtype=np.int64)
    np.testing.assert_allclose(
        ttr._path_cumsum(torch.as_tensor(dt), torch.as_tensor(par),
                         tt.n_nodes).numpy(),
        np.asarray(jtr._path_cumsum(jnp.asarray(dt), jnp.asarray(par),
                                    tt.n_nodes)), rtol=DENS_REL, atol=0)
