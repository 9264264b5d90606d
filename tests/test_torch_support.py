"""Branch supports of the port against phyml_tpu, on the CPU.

The same simulated alignment (phyml_tpu.evolve via
tests/test_torch_bionj.py::_simulate: 6 taxa x 100 sites of DNA under
GTR+G4 and of protein under LG+G4, the simulation's parameters held
fixed) and the same seeds go through both packages in float64
(phyml_tpu on its CPU path, no Pallas):

* `alrt_supports`, all five methods (aLRT statistic, its chi2 support,
  aBayes, SH-aLRT, RELL), within 1e-6; SH and RELL resample with the
  same numpy-drawn weight matrix;
* the serial `bootstrap_supports` with 2 replicates and the NNI search
  (FBP, TBE, Bayesian bootstrap): identical supports and replicate
  trees (RF 0); TBE against phyml_tpu's transfer supports of its FBP
  run's replicate trees (the same replicates and searches);
* the rapid bootstrap's pieces: `optimize_branch_lengths_batched` on 3
  stacked replicate trees with their own weights (lnL within 1e-6,
  lengths within 1e-5, and equal to 3 single optimizations of the
  port), `nni_scores_batched` (within 1e-6) and
  `bootstrap_supports_batched` with 3 replicates (identical supports;
  chunked one replicate at a time equal to one batch);
* the kernels' stacked plain versions (K3 with a child table per entry,
  K2 with a tree axis) equal their single-tree plain versions.

The CLI's support flags run against phyml_tpu.cli in
tests/test_torch_support_cli.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu.evolve import write_phylip
from phyml_tpu.io.alignment import read_alignment as jread
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.ops.likelihood import LikelihoodEngine as JEngine
from phyml_tpu.ops.likelihood import TreeArrays as JTreeArrays
from phyml_tpu.ops.likelihood import tree_arrays as jtree_arrays
from phyml_tpu.topology import Topology
from phyml_tpu_torch.interop import params_from_numpy, tree_arrays_from_numpy
from phyml_tpu_torch.io.alignment import read_alignment as tread
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.ops import clv as tclv
from phyml_tpu_torch.ops import edotp as tedotp
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine
from phyml_tpu_torch.ops.likelihood import TreeArrays
from test_torch_bionj import _simulate

jsup = importlib.import_module("phyml_tpu.search.support")
tsup = importlib.import_module("phyml_tpu_torch.search.support")
jblen = importlib.import_module("phyml_tpu.optim.blen")
tblen = importlib.import_module("phyml_tpu_torch.optim.blen")
jnni = importlib.import_module("phyml_tpu.search.nni")
tnni = importlib.import_module("phyml_tpu_torch.search.nni")

LNL_TOL = 1e-6
BLEN_TOL = 1e-5
# the port against itself: stacked against single-tree evaluation (the
# same arithmetic in another order)
SELF_TOL = 1e-8
# with the parameters fixed (`problem`) the serial bootstrap's searches
# take a few seconds a side on the CPU (the CLI tests run 8 x 150)
SIZE = dict(n_taxa=6, n_sites=100)
DATATYPES = ["nt", "aa"]
METHODS = ["alrt-stat", "alrt-chi2", "abayes", "sh", "rell"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """As in tests/test_torch_bionj.py: one torch thread for the many
    small ops of the search."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=DATATYPES)
def problem(request, tmp_path_factory):
    """float64 engines of both packages on one simulated alignment (kept
    for the module, so phyml_tpu compiles each program once), the
    simulation's parameters and tree."""
    dt = request.param
    names, seqs, truth = _simulate(dt, **SIZE)
    path = str(tmp_path_factory.mktemp(f"support_{dt}") / "aln.phy")
    write_phylip(path, names, seqs)
    jaln, taln = jread(path, datatype=dt), tread(path, datatype=dt)
    # the simulation's parameters, held fixed: the searches of the
    # serial bootstrap then fit lengths and topology only (the CLI tests,
    # tests/test_torch_support_cli.py, run it with the rates estimated)
    kw = dict(datatype=dt, name="GTR" if dt == "nt" else "LG",
              n_classes=4, optimize_rr=False, optimize_alpha=False)
    jm, tm = JModel(**kw), TModel(**kw)
    jp = jm.init_params(jaln.obs_state_freqs)
    if "rr_val" in jp:
        jp["rr_val"] = jnp.log(jnp.asarray([1.2, 3.0, 0.8, 1.1, 4.0, 1.0]))
    jp["alpha"] = jnp.asarray(0.7 if dt == "nt" else 0.9)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    jeng = JEngine(jaln, jm, dtype=jnp.float64, use_pallas=False)
    teng = TEngine(taln, tm, dtype=torch.float64, device="cpu")
    return dict(dt=dt, jeng=jeng, jm=jm, jp=jp, teng=teng, tm=tm, tp=tp,
                truth=truth, n=len(names))


def _jax_weights(p, W):
    """[R, P] pattern weights as phyml_tpu takes them: its pattern axis
    is padded (zero weight beyond the alignment's patterns)."""
    out = np.zeros((W.shape[0], p["jeng"].P))
    out[:, :W.shape[1]] = W
    return jnp.asarray(out)


def _stacked(p, R=3, seed=11):
    """R random replicate trees with their bootstrap weights, as
    phyml_tpu's and the port's stacked TreeArrays and [R, P] weights."""
    rng = np.random.default_rng(seed)
    rvs = [Topology.random(p["n"], rng, mean_blen=0.1).rooted()
           for _ in range(R)]
    W = np.stack([tsup.replicate_weights(p["teng"], seed, r, False)
                  for r in range(R)])
    jtas = [jtree_arrays(rv, dtype=jnp.float64) for rv in rvs]
    jtrees = JTreeArrays(child=jnp.stack([t.child for t in jtas]),
                         blen=jnp.stack([t.blen for t in jtas]))
    ttas = [tree_arrays_from_numpy(rv.child, rv.node_blen, device="cpu",
                                   dtype=torch.float64) for rv in rvs]
    ttrees = TreeArrays(child=torch.stack([t.child for t in ttas]),
                        blen=torch.stack([t.blen for t in ttas]))
    return rvs, W, jtrees, ttrees, ttas


@pytest.mark.parametrize("method", METHODS)
def test_alrt_supports_match_phyml_tpu(problem, method):
    p = problem
    want = jsup.alrt_supports(p["jeng"], p["jm"], p["jp"], p["truth"],
                              method=method, seed=3)
    got = tsup.alrt_supports(p["teng"], p["tm"], p["tp"], p["truth"],
                             method=method, seed=3)
    assert set(got) == set(want) and len(got) == p["n"] - 3
    for eid, v in want.items():
        assert abs(got[eid] - v) <= LNL_TOL, (eid, got[eid], v)
    if method != "alrt-stat":
        assert all(0.0 <= v <= 1.0 for v in got.values())


BOOT = dict(n_replicates=2, search="nni", seed=5, keep_trees=True)


@pytest.fixture(scope="module")
def jax_boot(problem):
    """phyml_tpu's serial bootstrap of the problem (two replicates, FBP):
    its supports and replicate trees."""
    p = problem
    return jsup.bootstrap_supports(p["jeng"], p["jm"], p["jp"], p["truth"],
                                   **BOOT)


def _jax_tbe(p, trees):
    """phyml_tpu's TBE supports of its replicate trees (its own
    counting, phyml_tpu/search/support.py:183-190): bootstrap_supports
    with tbe=True draws the same replicates and runs the same searches
    as with FBP, so only the counting differs."""
    n = p["n"]
    ref_bips = p["truth"].bipartitions()
    counts = {eid: 0.0 for eid in ref_bips.values()}
    for topo in trees:
        rep_masks = jsup._all_bip_masks(topo, n)
        for eid, mask in jsup._bip_masks(p["truth"], ref_bips, n).items():
            psz = min(mask.sum(), n - mask.sum())
            if psz > 1:
                d = jsup._min_transfer_dist(mask, rep_masks, n)
                counts[eid] += max(0.0, 1.0 - d / (psz - 1))
    return {eid: c / len(trees) for eid, c in counts.items()}


@pytest.mark.parametrize("variant", ["fbp", "tbe", "bayesian"])
def test_bootstrap_supports_match_phyml_tpu(problem, jax_boot, variant):
    """Two replicates, each a BioNJ start and the NNI search under the
    replicate's weights, through both packages' drivers; for TBE
    phyml_tpu's transfer supports of its FBP run's replicate trees."""
    p = problem
    if variant == "bayesian":
        want, jtrees = jsup.bootstrap_supports(
            p["jeng"], p["jm"], p["jp"], p["truth"], bayesian=True, **BOOT)
    else:
        want, jtrees = jax_boot
        if variant == "tbe":
            want = _jax_tbe(p, jtrees)
    got, ttrees = tsup.bootstrap_supports(
        p["teng"], p["tm"], p["tp"], p["truth"], tbe=variant == "tbe",
        bayesian=variant == "bayesian", **BOOT)
    assert [t.rf_distance(j) for t, j in zip(ttrees, jtrees)] == [0, 0]
    assert set(got) == set(want)
    for eid, v in want.items():
        assert abs(got[eid] - v) <= LNL_TOL, (eid, got[eid], v)


def test_optimize_branch_lengths_batched_matches_phyml_tpu(problem):
    p = problem
    rvs, W, jtrees, ttrees, ttas = _stacked(p)
    jt, jl = jblen.optimize_branch_lengths_batched(
        p["jeng"], p["jp"], jtrees, _jax_weights(p, W))
    tt, tl = tblen.optimize_branch_lengths_batched(
        p["teng"], p["tp"], ttrees, torch.as_tensor(W))
    assert tl.shape == (3,)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=0, atol=LNL_TOL)
    np.testing.assert_allclose(tt.blen.numpy(), np.asarray(jt.blen),
                               rtol=0, atol=BLEN_TOL)
    np.testing.assert_array_equal(tt.child.numpy(), np.asarray(jt.child))
    # each replicate as the port's own single-tree optimization
    for r in range(3):
        one, lnl = tblen.optimize_branch_lengths(
            p["teng"], p["tp"], ttas[r], weights=torch.as_tensor(W[r]))
        assert abs(lnl - tl[r]) <= SELF_TOL, (r, lnl, tl[r])
        np.testing.assert_allclose(tt.blen[r].numpy(), one.blen.numpy(),
                                   rtol=0, atol=SELF_TOL)


def test_nni_scores_batched_matches_phyml_tpu(problem):
    p = problem
    rvs, W, jtrees, ttrees, _ = _stacked(p, seed=12)
    cands = np.stack([jnni.candidate_arrays(rv) for rv in rvs])
    jl, jts = jnni.nni_scores_batched(p["jeng"], p["jp"], jtrees, cands,
                                      _jax_weights(p, W))
    tl, tts = tnni.nni_scores_batched(p["teng"], p["tp"], ttrees, cands,
                                      torch.as_tensor(W))
    assert tl.shape == (3, p["n"] - 3, 3)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LNL_TOL)
    for g, w in zip(tts, jts):
        np.testing.assert_allclose(g, w, rtol=0, atol=BLEN_TOL)


def test_bootstrap_supports_batched_matches_phyml_tpu(problem):
    """Three replicates, parameters frozen; the port chunked one
    replicate at a time gives the supports of one batch."""
    p = problem
    kw = dict(n_replicates=3, seed=9, keep_trees=True)
    want, jtrees = jsup.bootstrap_supports_batched(
        p["jeng"], p["jm"], p["jp"], p["truth"], **kw)
    got, ttrees = tsup.bootstrap_supports_batched(
        p["teng"], p["tm"], p["tp"], p["truth"], **kw)
    assert [t.rf_distance(j) for t, j in zip(ttrees, jtrees)] == [0] * 3
    assert got == pytest.approx(want, abs=LNL_TOL)
    chunked, ctrees = tsup.bootstrap_supports_batched(
        p["teng"], p["tm"], p["tp"], p["truth"], rep_chunk=1, **kw)
    assert chunked == got
    assert [t.rf_distance(c) for t, c in zip(ttrees, ctrees)] == [0] * 3


def test_rep_chunk_follows_the_memory_budget():
    """The chunk is the budget over REP_TENSORS [n_nodes, C, ns, P]
    tensors of the engine's dtype, at least 1 and at most the
    replicates (the CPU's fixed budget here)."""
    from types import SimpleNamespace

    per = lambda e: tsup.REP_TENSORS * e.n_nodes * e.C * e.ns * e.P * 8
    small = SimpleNamespace(n_nodes=23, C=4, ns=4, P=200,
                            dtype=torch.float64,
                            device=torch.device("cpu"))
    assert tsup.rep_chunk_for(small, 100) == 100
    assert tsup.rep_chunk_for(small, 7) == 7
    big = SimpleNamespace(n_nodes=255, C=4, ns=20, P=3945,
                          dtype=torch.float64, device=torch.device("cpu"))
    assert tsup.rep_chunk_for(big, 100) == \
        max(1, int(tsup.CPU_REP_BUDGET // per(big)))
    huge = SimpleNamespace(n_nodes=4095, C=8, ns=20, P=10 ** 5,
                           dtype=torch.float64, device=torch.device("cpu"))
    assert tsup.rep_chunk_for(huge, 100) == 1


@pytest.mark.parametrize("ns", [4, 20])
def test_stacked_plain_versions_equal_single_tree(ns):
    """K3's plain version with a child table per entry (one system
    broadcast, or one per entry) and K2's with a tree axis give, entry
    by entry, the single-tree plain versions; trees of different shapes
    share the stack."""
    rng = np.random.default_rng(ns)
    n, C, P, R = 9, 3, 37, 3
    rvs = [Topology.random(n, rng, mean_blen=0.2).rooted()
           for _ in range(R)]
    child = torch.stack([torch.as_tensor(rv.child.astype(np.int32))
                         for rv in rvs])
    tips = torch.as_tensor(rng.uniform(0.05, 1.0, (n, ns, P)))
    raw = torch.as_tensor(rng.uniform(0.0, 1.0, (R, 2 * n - 1, C, ns, ns)))
    pmats = raw / raw.sum(-1, keepdim=True)
    pi = torch.as_tensor(rng.dirichlet(np.ones(ns), C))
    logw = torch.log(torch.full((C,), 1.0 / C, dtype=torch.float64))
    got = tclv.uppass_site_lse_plain(child, tips, pmats, pi, logw)
    pis = torch.as_tensor(rng.dirichlet(np.ones(ns), (R, C)))
    got_b = tclv.uppass_site_lse_plain(child, tips, pmats, pis,
                                       logw.expand(R, C))
    V = torch.as_tensor(rng.normal(size=(C, ns, ns)))
    Vinv = torch.as_tensor(rng.normal(size=(C, ns, ns)))
    d, sc = tedotp.edge_dotprods_plain(child, tips, pmats, V, Vinv, pi)
    assert got.shape == (R, P) and d.shape == (R, 2 * n - 1, C, ns, P)
    for r in range(R):
        one = tclv.uppass_site_lse_plain(child[r], tips, pmats[r:r + 1],
                                         pi[None], logw[None])[0]
        torch.testing.assert_close(got[r], one, rtol=0, atol=0)
        one_b = tclv.uppass_site_lse_plain(child[r], tips, pmats[r:r + 1],
                                           pis[r:r + 1], logw[None])[0]
        torch.testing.assert_close(got_b[r], one_b, rtol=0, atol=0)
        d1, sc1 = tedotp.edge_dotprods_plain(child[r], tips, pmats[r], V,
                                             Vinv, pi)
        torch.testing.assert_close(d[r], d1, rtol=0, atol=0)
        torch.testing.assert_close(sc[r], sc1, rtol=0, atol=0)


def test_stacked_wrappers_check_their_operands():
    """The stacked forms' contract on CPU tensors: a schedule and child
    table per entry, one system or one per entry; a child table that is
    not a postorder, in any tree of a stack, is refused."""
    rng = np.random.default_rng(0)
    n, C, ns, P, R = 6, 2, 4, 8, 2
    rvs = [Topology.random(n, rng).rooted() for _ in range(R)]
    from phyml_tpu_torch.ops.clv_slots import build_slot_schedule
    scheds = [build_slot_schedule(n, rv.child) for rv in rvs]
    child = torch.stack([torch.as_tensor(rv.child.astype(np.int32))
                         for rv in rvs])
    sched = torch.stack([torch.as_tensor(s) for s, _ in scheds])
    n_slots = max(k for _, k in scheds)
    tips = torch.rand(n, ns, P, dtype=torch.float64)
    pm = torch.rand(R, 2 * n - 1, C, ns, ns, dtype=torch.float64)
    pi = torch.rand(C, ns, dtype=torch.float64)
    logw = torch.zeros(C, dtype=torch.float64)
    out = tclv.uppass_site_lse(child, tips, pm, pi, logw, sched=sched,
                               n_slots=n_slots)
    assert out.shape == (R, P)
    with pytest.raises(ValueError, match="schedule has shape"):
        tclv.uppass_site_lse(child, tips, pm, pi, logw, sched=sched[0],
                             n_slots=n_slots)
    with pytest.raises(ValueError, match="inconsistent"):
        # one system for all entries needs a child table per entry
        tclv.uppass_site_lse(child[0], tips, pm, pi, logw, sched=sched[0],
                             n_slots=n_slots)
    bad = child.clone()
    bad[1, 0, 0] = 2 * n - 2
    V = torch.rand(C, ns, ns, dtype=torch.float64)
    with pytest.raises(ValueError, match="postorder"):
        tedotp.edge_dotprods(bad, tips, pm, V, V, pi)
    with pytest.raises(ValueError, match="inconsistent"):
        tedotp.edge_dotprods(child, tips, pm[0], V, V, pi)
