"""The covarion (M4) model of the port against phyml_tpu, on the CPU.

The same simulated alignment (tests/test_torch_bionj.py's, 12 taxa,
200 sites, GTR+G4 or LG+G4) goes through both packages in float64:

* the big Q and pi of `m4_exchangeabilities` against phyml_tpu's and
  against a literal transcription of the reference's M4_Update_Qmat
  (copied from tests/test_covarion.py), within 1e-12;
* `class_system` (eigenvalues, pi and P(t): not eigenvectors, whose
  signs differ between libraries) for the 'fixed', 'alpha' and 'free'
  modes, within 1e-12 (P(t) 1e-10);
* the engine's lnL for each mode at 2 and 3 hidden classes, DNA and
  amino acids (and +I, whose invariant term marginalizes the hidden
  classes out of pi), and amino acids at 4 (80 states, past the CUDA
  kernels' ladder), within 1e-6;
* one branch-length round at 80 states, within 1e-6 in lnL and 1e-5 in
  every length;
* `optimize_scalars` with the `cov_*` slots, within 1e-6 in lnL;
* the CLI's `--cov`, `--cov_delta e`, `--cov_alpha e` and `--cov_free`
  runs (BioNJ, then the fit) against phyml_tpu.cli on the same files:
  the same tree, the stats lnL within 1e-6;
* the dating chain's covarion moves (`cov_switch`, `cov_rates`) fed the
  variates phyml_tpu drew, within 1e-12, and the chain's lnL at a
  covarion state within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu.models.covarion import m4_exchangeabilities as jm4
from phyml_tpu.models.eigen import pmat as jpmat
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.ops.likelihood import LikelihoodEngine as JEngine
from phyml_tpu.ops.likelihood import tree_arrays as jtree_arrays
from phyml_tpu.optim.round import optimize_scalars as jopt
from phyml_tpu.evolve import write_phylip
from phyml_tpu.io.alignment import read_alignment as jread
from phyml_tpu_torch.interop import (
    chain_state_from_numpy, params_from_numpy, tree_arrays_from_numpy,
)
from phyml_tpu_torch.io.alignment import read_alignment as tread
from phyml_tpu_torch.models.covarion import m4_exchangeabilities as tm4
from phyml_tpu_torch.models.eigen import pmat as tpmat
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine
from phyml_tpu_torch.optim.round import free_scalar_slots
from phyml_tpu_torch.optim.round import optimize_scalars as topt
from test_torch_bionj import _simulate, run_both_clis

Q_TOL = 1e-12
PMAT_TOL = 1e-10
LNL_TOL = 1e-6
MOVE_TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """As in tests/test_torch_bionj.py: one torch thread for the many
    small ops of the fits and the chain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# the big Q: a literal transcription of the reference (m4.c:324-523),
# as tests/test_covarion.py writes it
# ----------------------------------------------------------------------
def generic_qmat(rr_upper, pi):
    """Update_Qmat_Generic (models.c:430): q_ij = rr_ij * pi_j,
    normalized to mean rate 1; rr given as a symmetric matrix."""
    q = rr_upper * pi[None, :]
    np.fill_diagonal(q, 0.0)
    np.fill_diagonal(q, -q.sum(axis=1))
    mr = -np.sum(pi * np.diag(q))
    return q / mr


def ref_m4_qmat(E, o_fq, h_fq, multipl, delta):
    """Literal transcription of M4_Update_Qmat (m4.c:324-523)."""
    n_o, n_h = len(o_fq), len(h_fq)
    n_s = n_o * n_h

    o_mat = generic_qmat(E, o_fq)          # m4.c:434
    pi = np.array([o_fq[i % n_o] * h_fq[i // n_o] for i in range(n_s)])

    q = np.zeros((n_s, n_s))
    # diagonal blocks (m4.c:448-461)
    for i in range(n_s):
        for j in range(i + 1, n_s):
            if j // n_o == i // n_o:
                q[i, j] = o_mat[i % n_o, j % n_o] * multipl[i // n_o]
                q[j, i] = q[i, j] * o_fq[i % n_o] / o_fq[j % n_o]
    # observed-substitution normalization (m4.c:463-474)
    mr = sum(
        q[i].sum() * o_fq[i % n_o] * h_fq[i // n_o] for i in range(n_s)
    )
    q /= mr
    # switching blocks (m4.c:479-504)
    h_mat = generic_qmat(np.ones((n_h, n_h)), h_fq) * delta
    for i in range(n_s):
        for j in range(i + 1, n_s):
            if j // n_o != i // n_o and i % n_o == j % n_o:
                q[i, j] = h_mat[i // n_o, j // n_o]
                q[j, i] = q[i, j] * h_fq[i // n_o] / h_fq[j // n_o]
    np.fill_diagonal(q, 0.0)
    np.fill_diagonal(q, -q.sum(axis=1))
    return q, pi


def _q_of(S, pi):
    q = np.asarray(S) * np.asarray(pi)[None, :]
    np.fill_diagonal(q, 0.0)
    np.fill_diagonal(q, -q.sum(axis=1))
    return q


Q_CASES = [
    # (o_fq, h_fq, multipl, delta, kappa): DNA kappa patterns
    (np.array([0.29, 0.18, 0.26, 0.27]), np.full(3, 1 / 3),
     np.array([0.0, 1.0, 2.0]), 1.0, 4.0),
    (np.array([0.25, 0.25, 0.25, 0.25]), np.array([0.6, 0.4]),
     np.array([0.3, 2.05]), 0.37, 2.0),
    (np.array([0.4, 0.1, 0.2, 0.3]), np.array([0.2, 0.3, 0.5]),
     np.array([0.1, 0.7, 1.54]), 3.3, 7.5),
]


@pytest.mark.parametrize("o_fq,h_fq,multipl,delta,kappa", Q_CASES)
def test_m4_qmat_matches_reference_and_phyml_tpu(o_fq, h_fq, multipl,
                                                 delta, kappa):
    E = np.ones((4, 4))
    E[0, 2] = E[2, 0] = kappa
    E[1, 3] = E[3, 1] = kappa
    q_ref, pi_ref = ref_m4_qmat(E, o_fq, h_fq, multipl, delta)
    S_t, pi_t = tm4(*(torch.as_tensor(np.asarray(x, dtype=np.float64))
                      for x in (E, o_fq, h_fq, multipl, delta)))
    S_j, pi_j = jm4(*(jnp.asarray(x) for x in (E, o_fq, h_fq, multipl,
                                                 delta)))
    q_t = _q_of(S_t.numpy(), pi_t.numpy())
    np.testing.assert_allclose(pi_t.numpy(), pi_ref, rtol=0, atol=Q_TOL)
    np.testing.assert_allclose(q_t, q_ref, rtol=0, atol=Q_TOL)
    np.testing.assert_allclose(pi_t.numpy(), np.asarray(pi_j), rtol=0,
                               atol=Q_TOL)
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), rtol=0,
                               atol=Q_TOL)


def test_m4_amino_acid_qmat_matches_reference():
    """The amino-acid form: exchangeabilities seeded from LG's
    normalized Q (M4_Init_Model init.c:6417-6425), two hidden classes
    with free frequencies."""
    tm = TModel(datatype="aa", name="LG", covarion=True, n_hidden=2,
                cov_mode="free", n_classes=1, freqs_mode="model")
    from phyml_tpu_torch.models import matrices
    S, o_fq = (torch.as_tensor(x) for x in matrices.empirical_aa("LG"))
    E = tm._m4_observed_exch({}, S, o_fq)
    h_fq, multipl = np.array([0.35, 0.65]), np.array([0.4, 1.3])
    q_ref, pi_ref = ref_m4_qmat(E.numpy(), o_fq.numpy(), h_fq, multipl,
                                0.8)
    S_t, pi_t = tm4(E, o_fq, torch.as_tensor(h_fq),
                    torch.as_tensor(multipl), torch.tensor(0.8,
                                                           dtype=torch.float64))
    np.testing.assert_allclose(pi_t.numpy(), pi_ref, rtol=0, atol=Q_TOL)
    np.testing.assert_allclose(_q_of(S_t.numpy(), pi_t.numpy()), q_ref,
                               rtol=0, atol=Q_TOL)


# ----------------------------------------------------------------------
# class systems and the likelihood
# ----------------------------------------------------------------------
def _models(dt, mode, n_h, invar=False):
    kw = dict(datatype=dt, name="GTR" if dt == "nt" else "LG",
              n_classes=4, covarion=True, n_hidden=n_h, cov_mode=mode,
              invar=invar)
    return JModel(**kw), TModel(**kw)


def _params(jm, obs_freqs, seed):
    """phyml_tpu's starting parameters of jm moved off their defaults
    (random values for every free parameter), as numpy."""
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in jm.init_params(obs_freqs).items()}
    if "rr_val" in p:
        p["rr_val"] = np.log(rng.uniform(0.5, 4.0, 6))
    p["alpha"] = np.asarray(rng.uniform(0.4, 1.5))
    p["cov_delta"] = np.asarray(rng.uniform(0.3, 3.0))
    if "cov_alpha" in p:
        p["cov_alpha"] = np.asarray(rng.uniform(0.3, 2.0))
    if "cov_h_fq_raw" in p:
        p["cov_h_fq_raw"] = rng.uniform(0.5, 2.0, jm.n_hidden)
        p["cov_multipl_raw"] = rng.uniform(0.1, 2.0, jm.n_hidden)
    if "pinv" in p:
        p["pinv"] = np.asarray(0.15)
    return p


@pytest.mark.parametrize("dt,mode,n_h", [
    ("nt", "fixed", 3), ("nt", "alpha", 2), ("nt", "free", 3),
    ("aa", "fixed", 2), ("aa", "alpha", 3), ("aa", "free", 2)])
def test_class_system_matches_phyml_tpu(dt, mode, n_h):
    jm, tm = _models(dt, mode, n_h)
    assert tm.ns == jm.ns == n_h * (4 if dt == "nt" else 20)
    freqs = np.random.default_rng(1).dirichlet(np.ones(tm.obs_ns))
    p = _params(jm, freqs, seed=2)
    js = jm.class_system({k: jnp.asarray(v) for k, v in p.items()})
    ts = tm.class_system(params_from_numpy(p))
    for name, a, b in zip(("lam", "pi", "w", "pinv"), (js[0], *js[3:]),
                          (ts[0], *ts[3:])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=Q_TOL, err_msg=name)
    t = np.array([[0.05] * 4, [0.4] * 4])
    np.testing.assert_allclose(
        tpmat(*ts[:3], torch.as_tensor(t)).numpy(),
        np.asarray(jpmat(*js[:3], jnp.asarray(t))), rtol=0, atol=PMAT_TOL)


def _engines(dt, mode, n_h, tmp_path, invar=False, seed=5):
    """float64 engines of both packages on one simulated alignment, the
    covarion model, random parameters and the simulating tree."""
    names, seqs, topo = _simulate(dt, seed)
    path = str(tmp_path / f"aln_{dt}.phy")
    write_phylip(path, names, seqs)
    jaln, taln = jread(path, datatype=dt), tread(path, datatype=dt)
    jm, tm = _models(dt, mode, n_h, invar)
    p = _params(jm, jaln.obs_state_freqs, seed + 1)
    jeng = JEngine(jaln, jm, dtype=jnp.float64, use_pallas=False)
    teng = TEngine(taln, tm, dtype=torch.float64, device="cpu")
    rv = topo.rooted()
    jta = jtree_arrays(rv, dtype=jnp.float64)
    tta = tree_arrays_from_numpy(np.asarray(jta.child),
                                 np.asarray(jta.blen), device="cpu",
                                 dtype=torch.float64)
    return dict(jm=jm, tm=tm, jeng=jeng, teng=teng, jta=jta, tta=tta,
                jp={k: jnp.asarray(v) for k, v in p.items()},
                tp=params_from_numpy(p))


@pytest.mark.parametrize("dt,mode,n_h,invar", [
    ("nt", "fixed", 2, True), ("nt", "alpha", 3, False),
    ("nt", "free", 2, False), ("aa", "fixed", 3, False),
    ("aa", "alpha", 2, False), ("aa", "free", 3, False),
    ("aa", "alpha", 4, False), ("aa", "fixed", 4, False)])
def test_loglik_matches_phyml_tpu(dt, mode, n_h, invar, tmp_path):
    """lnL at 2 and 3 hidden classes in each mode, and amino acids at
    four (80 states, past the kernels' ladder: the big bodies' route,
    plain versions on the CPU); +I marginalizes the hidden classes out
    of pi for the invariant term."""
    pb = _engines(dt, mode, n_h, tmp_path, invar=invar)
    want = float(pb["jeng"].loglik(pb["jp"], pb["jta"]))
    got = float(pb["teng"].loglik(pb["tp"], pb["tta"]))
    assert abs(got - want) < LNL_TOL, (got, want)
    # the kernels' route (plain versions on the CPU) against the scan
    scan = pb["teng"].site_logliks_scan(pb["teng"].system_of(pb["tp"]),
                                        pb["tta"])
    assert abs(float(torch.sum(scan * pb["teng"].weights)) - want) < LNL_TOL


@pytest.mark.parametrize("mode", ["alpha", "free"])
def test_optimize_scalars_matches_phyml_tpu(mode, tmp_path):
    """One line-search round over every free scalar, the cov_* slots
    among them (delta; the hidden classes' gamma shape, or their free
    multipliers and frequencies), on DNA at two hidden classes."""
    pb = _engines("nt", mode, 2, tmp_path)
    jm, tm = pb["jm"], pb["tm"]
    jp, jl = jopt(pb["jeng"], jm, pb["jp"], pb["jta"])
    tp, tl = topt(pb["teng"], tm, pb["tp"], pb["tta"])
    assert abs(float(tl) - float(jl)) < LNL_TOL, (tl, jl)
    names = {s[0] for s in free_scalar_slots(tm, pb["tp"])}
    assert "cov_delta" in names
    for k in names:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-5, err_msg=k)


def test_branch_length_round_at_80_states(tmp_path):
    """One optimize_branch_lengths round (the edge dot products and the
    parallel Newton step: K5's route, its plain version on the CPU) at
    80 states, amino acids at four hidden classes, against phyml_tpu's:
    lnL within 1e-6, every branch length within 1e-5."""
    from phyml_tpu.optim.blen import optimize_branch_lengths as jblen
    from phyml_tpu_torch.optim.blen import optimize_branch_lengths as tblen

    pb = _engines("aa", "alpha", 4, tmp_path)
    assert pb["teng"].ns == 80
    jt, jl = jblen(pb["jeng"], pb["jp"], pb["jta"], max_rounds=1)
    tt, tl = tblen(pb["teng"], pb["tp"], pb["tta"], max_rounds=1)
    assert abs(float(tl) - float(jl)) < LNL_TOL, (tl, jl)
    np.testing.assert_allclose(tt.blen.numpy(), np.asarray(jt.blen),
                               rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
@pytest.mark.parametrize("flags", [
    ["--cov"],
    ["--cov_alpha", "e", "--cov_delta", "e", "--cov_ncats", "2"],
    ["--cov_free", "-o", "l"]],
    ids=["cov", "alpha-delta", "free"])
def test_cli_covarion_matches_phyml_tpu(flags, tmp_path, monkeypatch):
    """BioNJ, then the fixed-topology fit (`-o lr`; `-o l` for
    `--cov_free`, whose raw class frequencies are flat along their scale,
    so that a fit's ties fall to roundoff) under GTR+G4 with each
    covarion flag, on 6 taxa: the same tree, the stats lnL within 1e-6,
    and the stats file's covarion block."""
    runs = run_both_clis(tmp_path, monkeypatch, "nt",
                         ["-o", "lr", *flags], n_taxa=6, n_sites=120)
    (lj, tj), (lt, tt) = runs["jax"], runs["torch"]
    assert tt.rf_distance(tj) == 0
    assert abs(lt - lj) < LNL_TOL, (lt, lj)
    assert "Covarion (M4) model" in runs["torch_stats"]


# ----------------------------------------------------------------------
# the dating chain's covarion moves
# ----------------------------------------------------------------------
def test_mcmc_covarion_moves_match_phyml_tpu(tmp_path):
    """cov_switch (delta) and cov_rates (the hidden classes' gamma
    shape) from the variates phyml_tpu drew, at a perturbed state, over
    6 keys and two step sizes; the chain's lnL at that state."""
    from phyml_tpu.bayes.mcmc import MCMC as JMCMC
    from phyml_tpu.bayes.rates import RateModel as JRates
    from phyml_tpu.bayes.times import TimePrior as JPrior
    from phyml_tpu_torch.bayes.mcmc import MCMC as TMCMC
    from phyml_tpu_torch.bayes.rates import RateModel as TRates
    from phyml_tpu_torch.bayes.times import TimePrior as TPrior
    from test_torch_bayes import _problem, _tt_port

    jtt, jaln, taln = _problem(tmp_path)
    kw = dict(datatype="nt", name="HKY85", n_classes=4, covarion=True,
              n_hidden=2, cov_mode="alpha")
    jm, tm = JModel(**kw), TModel(**kw)
    jp = jm.init_params(jaln.obs_state_freqs)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    ttt = _tt_port(jtt)
    jmc = JMCMC(JEngine(jaln, jm, dtype=jnp.float64), jm, jp, jtt,
                JRates(kind="lognormal"), JPrior(kind="birthdeath"))
    tmc = TMCMC(TEngine(taln, tm, dtype=torch.float64, device="cpu"), tm,
                tp, ttt, TRates(kind="lognormal"), TPrior(kind="birthdeath"))
    np.testing.assert_allclose(tmc.move_w, np.asarray(jmc.move_w),
                               atol=1e-15)
    js = jmc.init_state()
    js = js._replace(subst={k: v * 1.3 for k, v in js.subst.items()})
    js = js._replace(lnL=jnp.asarray(jmc._lnL(js)), lp=jmc._log_prior(js))
    ts = chain_state_from_numpy({
        k: ({k2: np.asarray(v2) for k2, v2 in v.items()}
            if isinstance(v, dict) else np.asarray(v))
        for k, v in js._asdict().items()})
    assert abs(float(tmc._lnL(ts)) - float(js.lnL)) < LNL_TOL
    assert abs(float(tmc._log_prior(ts)) - float(js.lp)) \
        <= 1e-9 * abs(float(js.lp))
    for name, param in (("cov_switch", "cov_delta"),
                        ("cov_rates", "cov_alpha")):
        mv = TMCMC.MOVE_NAMES.index(name)
        for k in range(6):
            key = jax.random.PRNGKey(100 * mv + k)
            step = float(jmc.step[mv]) * (1.0 if k % 2 else 3.0)
            jnew, jh, ja = jmc._mv_subst(param, 0.01, 100.0)(js, key, step)
            u = float(jax.random.uniform(key, ()))
            tnew, th, ta = tmc.propose(
                ts, mv, step, [torch.tensor(u, dtype=torch.float64)])
            assert bool(ta) == bool(ja), name
            assert abs(float(th) - float(jh)) <= \
                MOVE_TOL * max(1.0, abs(float(jh))), name
            for nm, v in jnew.subst.items():
                a, b = float(tnew.subst[nm]), float(v)
                assert abs(a - b) <= MOVE_TOL * max(abs(a), abs(b)), nm
