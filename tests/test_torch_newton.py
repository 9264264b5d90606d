"""K6, the edge-length Newton solve (ops/newton.py, csrc/edge_newton.cu).

On the CPU: the plain version (`newton.solve_plain`, what
`LikelihoodEngine.newton_solve` runs for CPU tensors) gives bit for bit
the lengths of the three loops it replaced, kept below as they were
(`_nni_loop`: search/nni.py `_newton`; `_spr_loop`: search/spr.py
`_newton_1d`; `_blen_loop`: optim/blen.py `_newton_all_edges`), on the
very arguments their callers pass: the NNI scorer's [E, 3] rows with
its stride-0 scales, alone and on a stack of trees with a weight row a
tree; the branch-length round with its row mask, alone and stacked
with [R, 1, P] weights; the SPR scorer's [N, K] rows; +I on and off, 1
and 4 classes, 4 and 20 states.  And K6's wrapper refuses what the
kernel does not take.

On the card (marked `gpu`; the machine with the card has no JAX, so run
this file without the suite's conftest:
`python -m pytest tests/test_torch_newton.py --noconftest -m gpu`): K6
against the plain version on the same card tensors, in float32 and in
float64, at 4, 20 and 80 states and 1 and 4 classes, at the bench's
120 x 10,240 NNI
shapes, on a small tree whose rows take the cluster path, and its sums
entry (the sharded engine's) against edge_lnl_terms.  The kernel sums
over states and classes one term after another (PyTorch's reduction on
the card is a tree), with the card's expf/logf and fused multiply-adds:
its sums differ from the float32 plain version's by rounding, and its
lengths lie as far from the float64 plain version's as that version's
do, within a small factor.  Each tolerance below gives its reason.
"""

import numpy as np
import pytest
import torch

from phyml_tpu_torch.datatypes import AA_STATES, NT_STATES
from phyml_tpu_torch.evolve import simulate_alignment
from phyml_tpu_torch.io.alignment import compact
from phyml_tpu_torch.models.substitution import SubstModel
from phyml_tpu_torch.ops import newton
from phyml_tpu_torch.ops.likelihood import (
    LikelihoodEngine, TreeArrays, tree_arrays,
)
from phyml_tpu_torch.optim import blen
from phyml_tpu_torch.optim.blen import BL_MAX, BL_MIN
from phyml_tpu_torch.search import nni, spr
from phyml_tpu_torch.topology import Topology
from phyml_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The Tier-1 run's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the three loops K6 replaced, as they were ----------------------------

def _nni_loop(engine, d, sc_d, aux, t, iters=5):
    for _ in range(iters):
        _, d1, d2 = engine.edge_lnl_terms(d, sc_d, aux, t)
        nt = t - d1 / torch.where(d2 < 0, d2, -1.0)
        probe = torch.where(d1 > 0, t * 3.0, t / 3.0)
        tn = torch.where(d2 < -1e-12, nt, probe)
        tn = torch.minimum(torch.maximum(tn, t / 3.0), t * 3.0)
        t = torch.clamp(tn, BL_MIN, BL_MAX).to(t.dtype)
    return t


def _spr_loop(engine, d, sc_d, aux, t, iters):
    for _ in range(iters):
        _, d1, d2 = engine.edge_lnl_terms(d, sc_d, aux, t)
        newton_ = t - d1 / torch.where(d2 < 0, d2, -1.0)
        probe = torch.where(d1 > 0, t * 3.0, t / 3.0)
        tn = torch.where(d2 < -1e-12, newton_, probe)
        tn = torch.minimum(torch.maximum(tn, t / 3.0), t * 3.0)
        t = torch.clamp(tn, BL_MIN, BL_MAX).to(t.dtype)
    return t


def _blen_loop(engine, d, sc_d, aux, t0, mask):
    t = t0
    for _ in range(10):
        _, d1, d2 = engine.edge_lnl_terms(d, sc_d, aux, t)
        newton_ = t - d1 / torch.where(d2 < 0, d2, -1.0)
        probe = torch.where(d1 > 0, t * 3.0, t / 3.0)
        t_new = torch.where(d2 < -1e-12, newton_, probe)
        t_new = torch.minimum(torch.maximum(t_new, t / 3.0), t * 3.0)
        t_new = torch.clamp(t_new, BL_MIN, BL_MAX)
        t = torch.where(mask, t_new, t0).to(t0.dtype)
    return t


# ---- problems ---------------------------------------------------------------

def _problem(device, dtype, dt="nt", C=4, invar=False, n=10, sites=300,
             seed=0, n_hidden=0):
    """(engine, params, topology) on an alignment simulated down a random
    tree under GTR (nt) or LG (aa); n_hidden > 1 makes the engine's
    model the covarion one over the amino acids (20 n_hidden states)."""
    rng = np.random.default_rng(seed)
    name = "GTR" if dt == "nt" else "LG"
    sim = SubstModel(datatype=dt, name=name, n_classes=C, invar=invar)
    topo = Topology.random(n, rng, mean_blen=0.1)
    p0 = sim.init_params(np.full(sim.obs_ns, 1.0 / sim.obs_ns))
    if C > 1:
        p0["alpha"] = torch.tensor(0.6, dtype=torch.float64)
    names, seqs = simulate_alignment(topo, sim, p0, sites, rng)
    alphabet = NT_STATES if dt == "nt" else AA_STATES
    idx = np.array([[alphabet.index(ch) for ch in s] for s in seqs])
    enc = np.zeros(idx.shape + (len(alphabet),), dtype=np.float32)
    enc[np.arange(n)[:, None], np.arange(sites)[None], idx] = 1.0
    aln = compact(enc, names, dt)
    model = SubstModel(datatype=dt, name=name, n_classes=C, invar=invar,
                       covarion=n_hidden > 1, n_hidden=max(n_hidden, 2))
    params = model.init_params(aln.obs_state_freqs)
    if C > 1:
        params["alpha"] = torch.tensor(0.6, dtype=torch.float64)
    eng = LikelihoodEngine(aln, model, dtype=dtype, device=device)
    return eng, params, topo


def _captured(monkeypatch, eng, run):
    """The arguments of every newton_solve call `run()` makes."""
    calls = []
    real = eng.newton_solve

    def keep(d, sc, aux, t, iters, mask=None):
        calls.append((d, sc, dict(aux), t, iters, mask))
        return real(d, sc, aux, t, iters, mask)

    monkeypatch.setattr(eng, "newton_solve", keep)
    run()
    monkeypatch.undo()
    assert calls
    return calls


def _stack(eng, n, R, seed, dtype, device):
    """R random trees of n taxa (stacked TreeArrays), their NNI
    candidates [R, E, 5] and bootstrap-like weights [R, P]."""
    rng = np.random.default_rng(seed)
    rvs = [Topology.random(n, rng, mean_blen=0.1).rooted() for _ in range(R)]
    tas = [tree_arrays(rv, dtype=dtype, device=device) for rv in rvs]
    trees = TreeArrays(child=torch.stack([t.child for t in tas]),
                       blen=torch.stack([t.blen for t in tas]))
    cands = np.stack([nni.candidate_arrays(rv) for rv in rvs])
    W = torch.as_tensor(rng.integers(0, 3, (R, eng.P)), dtype=torch.float64,
                        device=device)
    return trees, cands, W


CASES = [("nt", 4, False), ("nt", 1, True), ("aa", 4, True),
         ("aa", 1, False)]
CPU = dict(device="cpu", dtype=torch.float64)


# ---- CPU: the plain version is the loops it replaced ----------------------

@pytest.mark.parametrize("dt,C,invar", CASES)
def test_plain_equals_the_nni_loop(monkeypatch, dt, C, invar):
    eng, params, topo = _problem(dt=dt, C=C, invar=invar, **CPU)
    rv = topo.rooted()
    tree = tree_arrays(rv, **CPU)
    calls = _captured(monkeypatch, eng, lambda: nni.nni_scores(
        eng, params, tree, nni.candidate_arrays(rv)))
    assert len(calls) == 8
    for d, sc, aux, t, iters, mask in calls:
        assert iters == 5 and mask is None and sc.stride(1) == 0
        got = newton.solve_plain(eng, d, sc, aux, t, iters)
        assert torch.equal(got, _nni_loop(eng, d, sc, aux, t))
        assert torch.equal(eng.newton_solve(d, sc, aux, t, iters), got)


@pytest.mark.parametrize("dt,C,invar", CASES[:2])
def test_plain_equals_the_stacked_nni_loop(monkeypatch, dt, C, invar):
    eng, params, _ = _problem(dt=dt, C=C, invar=invar, **CPU)
    trees, cands, W = _stack(eng, 10, 2, 5, **CPU)
    calls = _captured(monkeypatch, eng, lambda: nni.nni_scores_batched(
        eng, params, trees, cands, W))
    for d, sc, aux, t, iters, mask in calls:
        # one weight row a tree, for its E rows of three configurations
        assert aux["weights"].shape == (2 * 7, 1, eng.P)
        got = newton.solve_plain(eng, d, sc, aux, t, iters)
        assert torch.equal(got, _nni_loop(eng, d, sc, aux, t))


@pytest.mark.parametrize("dt,C,invar", CASES)
def test_plain_equals_the_blen_loop(monkeypatch, dt, C, invar):
    eng, params, topo = _problem(dt=dt, C=C, invar=invar, seed=1, **CPU)
    tree = tree_arrays(topo.rooted(), **CPU)
    calls = _captured(monkeypatch, eng, lambda: blen.optimize_branch_lengths(
        eng, params, tree, max_rounds=3))
    for d, sc, aux, t, iters, mask in calls:
        assert iters == 10 and mask is not None and not bool(mask.all())
        got = newton.solve_plain(eng, d, sc, aux, t, iters, mask)
        assert torch.equal(got, _blen_loop(eng, d, sc, aux, t, mask))


@pytest.mark.parametrize("dt,C,invar", CASES[:2])
def test_plain_equals_the_stacked_blen_loop(monkeypatch, dt, C, invar):
    eng, params, _ = _problem(dt=dt, C=C, invar=invar, seed=2, **CPU)
    trees, _, W = _stack(eng, 10, 3, 6, **CPU)
    calls = _captured(monkeypatch, eng,
                      lambda: blen.optimize_branch_lengths_batched(
                          eng, params, trees, W, max_rounds=2))
    for d, sc, aux, t, iters, mask in calls:
        assert aux["weights"].shape[1:] == (1, eng.P) and mask.dim() == 2
        got = newton.solve_plain(eng, d, sc, aux, t, iters, mask)
        assert torch.equal(got, _blen_loop(eng, d, sc, aux, t, mask))


@pytest.mark.parametrize("dt,C,invar", CASES)
def test_plain_equals_the_spr_loop(monkeypatch, dt, C, invar):
    eng, params, topo = _problem(dt=dt, C=C, invar=invar, seed=3, **CPU)
    rv = topo.rooted()
    tree = tree_arrays(rv, **CPU)
    moves = [spr.spr_move_arrays(rv, v) for v in spr.prune_candidates(rv)[:3]]
    masks = np.stack([m for m, _ in moves])
    valids = np.stack([v for _, v in moves])
    vs = spr.prune_candidates(rv)[:3]
    calls = _captured(monkeypatch, eng, lambda: spr.spr_scores_batched(
        eng, params, tree, masks, vs, valids))
    assert len(calls) == 6
    for d, sc, aux, t, iters, mask in calls:
        assert iters == 6 and t.shape == (eng.n_nodes, 3)
        got = newton.solve_plain(eng, d, sc, aux, t, iters)
        assert torch.equal(got, _spr_loop(eng, d, sc, aux, t, iters))


def test_no_iterations_keep_the_lengths():
    eng, params, topo = _problem(**CPU)
    tree = tree_arrays(topo.rooted(), **CPU)
    d, sc, aux = eng.edge_dotprods_sys(eng.system_of(params), tree)
    assert torch.equal(eng.newton_solve(d, sc, aux, tree.blen, 0),
                       tree.blen)


# ---- CPU: what K6's wrapper refuses ---------------------------------------

def _operands(device="cpu", dtype=torch.float32):
    eng, params, topo = _problem(device=device, dtype=dtype)
    tree = tree_arrays(topo.rooted(), device=device, dtype=dtype)
    d, sc, aux = eng.edge_dotprods_sys(eng.system_of(params), tree)
    return eng, d, sc, aux, tree.blen


def _k6(eng, d, sc, aux, t, mask=None):
    return newton.edge_newton(d, sc, aux, t, 5, mask, invar_ok=eng.invar_ok,
                              invar=eng.model.invar)


def test_wrapper_refuses_other_dtypes():
    eng, d, sc, aux, t = _operands(dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        _k6(eng, d, sc, aux, t)


def test_wrapper_refuses_a_strided_pattern_axis():
    eng, d, sc, aux, t = _operands()
    d2 = torch.cat([d, d], -1)[..., ::2]
    assert d2.shape == d.shape and d2.stride(-1) == 2
    with pytest.raises(ValueError, match="contiguous"):
        _k6(eng, d2, sc, aux, t)


@pytest.mark.parametrize("what", ["sc", "t", "weights", "mask", "lead"])
def test_wrapper_refuses_shapes_that_do_not_match(what):
    eng, d, sc, aux, t = _operands()
    mask = None
    if what == "sc":
        sc = sc[..., :-1]
    elif what == "t":
        t = t[:-1]
    elif what == "weights":
        aux = dict(aux, weights=aux["weights"][:-1])
    elif what == "mask":
        mask = torch.ones(3, dtype=torch.bool)
    else:
        d = d[None, None]
    with pytest.raises(ValueError, match="shape|leading axes"):
        _k6(eng, d, sc, aux, t, mask)
    # the engine's entry checks the same on any device
    with pytest.raises(ValueError, match="shape|leading axes"):
        eng.newton_solve(d, sc, aux, t, 5, mask)


def test_wrapper_refuses_cpu_tensors():
    eng, d, sc, aux, t = _operands()
    with pytest.raises(ValueError, match="CUDA"):
        _k6(eng, d, sc, aux, t)


def test_weight_groups():
    lead, P = (6, 3), 5
    assert newton._weight_groups((P,), lead, P) == 1
    assert newton._weight_groups((6, 1, P), lead, P) == 6
    assert newton._weight_groups((6, 3, P), lead, P) == 18
    assert newton._weight_groups((1, 1, P), lead, P) == 1
    assert newton._weight_groups((3, 1, P), lead, P) is None
    assert newton._weight_groups((6, 1, 1, P), lead, P) is None
    assert newton._weight_groups((6, 1, P + 1), lead, P) is None


# ---- the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD = dict(dtype=torch.float32)


def _k6_launches():
    return trace.snapshot().get("launch.K6", 0)


def _as64(aux):
    return {k: v.double() for k, v in aux.items()}


def _gap(x, y):
    return float((x.double() - y.double()).abs().max())


# Each row's float64 lnL at K6's length against that at the float32
# plain version's, within LNL_TOL of |lnL| plus SLOPE_LEN of |t dlnL/dt|
# (float64, at the float64 plain version's length).  Where the solve
# has converged the slope is ~0 and the lnL is flat to first order in
# the length, so the lnL gap is float32's rounding of a row's lnL, a
# float64 sum of float32 site terms (~1e-9 of |lnL|; LNL_TOL gives 10x).
# Where it has not (a short start the factor-of-3 clamp lets climb only
# so far, as the SPR scorer's pendant lengths), the last Newton step is
# taken far from the optimum and rounds with d2's float32 cancellation
# r2 - r1^2, ~1e-4 of the length; the lnL then moves by the slope times
# that, and SLOPE_LEN gives 10x.
LNL_TOL = 1e-8
SLOPE_LEN = 1e-3


def _check_solve(eng, d, sc, aux, t, iters, mask=None, label=""):
    """One K6 launch against the plain version on the same card tensors,
    in float32 and in float64.  Rows where `mask` is False keep t0
    exactly.  Each row is held by its own float64 lnL (LNL_TOL,
    SLOPE_LEN).  A length that float32 resolves only coarsely (a flat
    curve) may differ by much more than rounding from one float32
    evaluation to the next, so the lengths are held by their median
    relative gap to the float32 plain version's, below 1e-5, where a
    fault in the terms or the step would show, and by the quantiles of
    _check_to_float64.  Returns the relative gaps of K6's and the float32
    plain version's lengths to the float64 plain version's, for
    _check_to_float64."""
    before = _k6_launches()
    got = eng.newton_solve(d, sc, aux, t, iters, mask)
    assert _k6_launches() == before + 1
    plain = newton.solve_plain(eng, d, sc, aux, t, iters, mask)
    d64, sc64, aux64 = d.double(), sc.double(), _as64(aux)
    exact = newton.solve_plain(eng, d64, sc64, aux64, t.double(), iters,
                               mask)
    if mask is not None:
        keep = ~mask.expand(t.shape)
        assert bool(keep.any()) and torch.equal(got[keep], t[keep])
    lnl_k, lnl_p = (eng.edge_lnl_terms(d64, sc64, aux64, x.double())[0]
                    for x in (got, plain))
    lnl_x, d1_x, _ = eng.edge_lnl_terms(d64, sc64, aux64, exact)
    tol = LNL_TOL * lnl_x.abs() + SLOPE_LEN * (exact * d1_x).abs()
    over = float(((lnl_k - lnl_p).abs() / tol).max())
    rel = (got.double() - plain.double()).abs() / plain.double().abs()
    print(f"{label}: lengths max {float(rel.max()):.3e} median "
          f"{float(rel.median()):.3e}; lnL gap at most {over:.3e} of its "
          "tolerance")
    assert over <= 1.0
    assert float(rel.median()) <= 1e-5
    return ((got.double() - exact).abs().flatten() / exact.flatten(),
            (plain.double() - exact).abs().flatten() / exact.flatten())


# K6's gaps to the float64 plain version against the float32 plain
# version's, over every row a test solved: the median and the 99th
# percentile within F64_TIMES of the float32 plain version's.  Both are
# float32 evaluations of the same terms, rounded in another order (K6's
# state and class sums one term after another, fused multiply-adds, the
# card's expf/logf); a fault in the terms or the step moves the
# quantiles by orders of magnitude, rounding by a small factor.
F64_TIMES = 4.0


def _check_to_float64(gaps, label):
    k6 = torch.cat([g for g, _ in gaps])
    f32 = torch.cat([g for _, g in gaps])
    q = torch.tensor([0.5, 0.99], dtype=torch.float64, device=k6.device)
    qk, qp = torch.quantile(k6, q).tolist(), torch.quantile(f32, q).tolist()
    print(f"{label}: to float64 over {k6.numel()} rows, median / 99th "
          f"percentile K6 {qk[0]:.3e} / {qk[1]:.3e}, float32 plain "
          f"{qp[0]:.3e} / {qp[1]:.3e}")
    assert qk[0] <= F64_TIMES * qp[0], (qk, qp)
    assert qk[1] <= F64_TIMES * qp[1], (qk, qp)


@pytest.mark.gpu
@pytest.mark.parametrize("ns,C", [(4, 1), (4, 4), (20, 1), (20, 4),
                                  (80, 1), (80, 4)])
def test_k6_matches_plain(cuda, ns, C, monkeypatch):
    dt, hidden = ("nt", 0) if ns == 4 else ("aa", ns // 20)
    eng, params, topo = _problem(cuda, dt=dt, C=C, invar=C == 1, n=24,
                                 sites=1500, seed=ns + C, n_hidden=hidden,
                                 **CARD)
    assert eng.ns == ns
    rv = topo.rooted()
    tree = tree_arrays(rv, device=cuda, **CARD)
    d, sc, aux = eng.edge_dotprods_sys(eng.system_of(params), tree)
    idx = torch.arange(eng.n_nodes, device=cuda)
    mask = (idx != eng.n_nodes - 1) & (idx != int(tree.child[-1, 1]))
    gaps = [_check_solve(eng, d, sc, aux,
                         torch.clamp(tree.blen, BL_MIN, BL_MAX), 10, mask,
                         f"blen ns={ns} C={C}")]
    calls = _captured(monkeypatch, eng, lambda: nni.nni_scores(
        eng, params, tree, nni.candidate_arrays(rv)))
    for d, sc, aux, t, iters, mask in calls:
        gaps.append(_check_solve(eng, d, sc, aux, t, iters, mask,
                                 f"nni ns={ns} C={C}"))
    _check_to_float64(gaps, f"ns={ns} C={C}")


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["nt", "aa"])
def test_k6_at_the_bench_nni_shapes(cuda, dt, monkeypatch):
    """120 taxa x 10,240 sites: the NNI scorer's 8 solves are 8 launches,
    each [117, 3, 4, ns, P] rows of a block each."""
    eng, params, topo = _problem(cuda, dt=dt, n=120, sites=10240, seed=7,
                                 **CARD)
    rv = topo.rooted()
    tree = tree_arrays(rv, device=cuda, **CARD)
    before = _k6_launches()
    calls = _captured(monkeypatch, eng, lambda: nni.nni_scores(
        eng, params, tree, nni.candidate_arrays(rv)))
    assert _k6_launches() == before + 8 and len(calls) == 8
    d, sc, aux, t, iters, mask = calls[0]
    assert d.shape[:3] == (117, 3, 4)
    print(f"bench {dt}: {newton.geometry(351, eng.P, 4, eng.ns)}")
    _check_to_float64([_check_solve(eng, d, sc, aux, t, iters, mask,
                                    f"bench {dt}")], f"bench {dt}")


@pytest.mark.gpu
def test_k6_splits_the_rows_of_a_small_tree_over_a_cluster(cuda,
                                                           monkeypatch):
    eng, params, topo = _problem(cuda, dt="nt", n=12, sites=20000, seed=9,
                                 **CARD)
    rv = topo.rooted()
    tree = tree_arrays(rv, device=cuda, **CARD)
    calls = _captured(monkeypatch, eng, lambda: nni.nni_scores(
        eng, params, tree, nni.candidate_arrays(rv)))
    d, sc, aux, t, iters, mask = calls[0]
    geo = newton.geometry(d.shape[0] * 3, eng.P, eng.C, eng.ns)
    assert geo["cluster"] > 1, geo
    _check_to_float64([_check_solve(eng, d, sc, aux, t, iters, mask,
                                    "cluster")], "cluster")


@pytest.mark.gpu
@pytest.mark.parametrize("dt,C,invar", CASES)
def test_k6_sums_entry_matches_edge_lnl_terms(cuda, dt, C, invar,
                                              monkeypatch):
    """The sharded engine's entry: one iteration's three row sums, held
    to edge_lnl_terms in float32 within twice its gap to float64 (plus
    1e-9 of the sum of magnitudes, for rows where that gap is 0)."""
    eng, params, topo = _problem(cuda, dt=dt, C=C, invar=invar, n=16,
                                 sites=2000, seed=11, **CARD)
    rv = topo.rooted()
    tree = tree_arrays(rv, device=cuda, **CARD)
    calls = _captured(monkeypatch, eng, lambda: nni.nni_scores(
        eng, params, tree, nni.candidate_arrays(rv)))
    d, sc, aux, t, _, _ = calls[0]
    got = newton.edge_newton_sums(d, sc, aux, t, invar_ok=eng.invar_ok,
                                  invar=eng.model.invar)
    want = eng.edge_lnl_terms(d, sc, aux, t)
    want64 = eng.edge_lnl_terms(d.double(), sc.double(), _as64(aux),
                                t.double())
    site = eng.edge_site_terms(d, sc, aux, t)
    for k in range(3):
        scale = float((site[k].double().abs() * aux["weights"]).sum(-1).max())
        tol = 2 * _gap(want[k], want64[k]) + 1e-9 * scale
        assert _gap(got[k], want[k]) <= tol, (k, _gap(got[k], want[k]), tol)
