"""The port's topology search against phyml_tpu, on the CPU.

The same simulated alignment (phyml_tpu.evolve, 12 taxa, GTR+G4 or
LG+G4; tests/test_torch_bionj.py's fixture) goes through both packages
in float64:

* `nni_scores`: lnL [E, 3] of every internal edge's three
  configurations and the four optimized lengths, within 1e-6;
* `spr_scores_batched` over a block of prune candidates: lnL [K, N]
  (the same targets ruled out) and the three junction lengths of the
  valid targets, within 1e-6;
* `nni_round` and `spr_round` from one start and one seed: the same
  topology, moves applied and lnL within 1e-6;
* the CLI's default run (no -u: BioNJ, then the NNI search with its
  SPR escapes and probes) and `-s SPR`, against phyml_tpu.cli on the
  same files (protein at 8 taxa x 150 sites): the same tree and the
  final lnL within 1e-6;
* the flags still unported stop the run naming their ROADMAP item, and
  the SPR block size follows the reference's rule.
"""

import importlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu.ops.likelihood import tree_arrays as jtree_arrays
from phyml_tpu.topology import Topology
from phyml_tpu_torch import cli as tcli
from phyml_tpu_torch.interop import tree_arrays_from_numpy
from test_torch_bionj import DATATYPES, N_TAXA, _engines, run_both_clis

jnni = importlib.import_module("phyml_tpu.search.nni")
jspr = importlib.import_module("phyml_tpu.search.spr")
tnni = importlib.import_module("phyml_tpu_torch.search.nni")
tspr = importlib.import_module("phyml_tpu_torch.search.spr")

LNL_TOL = 1e-6
BLEN_TOL = 1e-6
# the CLI runs' problems: protein at 8 taxa keeps phyml_tpu's side of a
# search under ~10 s on the CPU
CLI_SIZE = {"nt": {}, "aa": dict(n_taxa=8, n_sites=150)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """As in tests/test_torch_bionj.py: one torch thread for the many
    small ops of the search."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start(dt, tmp_path, seed=7):
    """Both engines, parameters and a random start topology with its
    tree arrays on each side."""
    jeng, jp, teng, tp, truth = _engines(dt, tmp_path)
    topo = Topology.random(N_TAXA, np.random.default_rng(seed),
                           mean_blen=0.1)
    rv = topo.rooted()
    jta = jtree_arrays(rv, dtype=jnp.float64)
    tta = tree_arrays_from_numpy(rv.child, rv.node_blen, device="cpu",
                                 dtype=torch.float64)
    return jeng, jp, teng, tp, topo, rv, jta, tta


@pytest.mark.parametrize("dt", DATATYPES)
def test_nni_scores_match_phyml_tpu(dt, tmp_path):
    jeng, jp, teng, tp, _, rv, jta, tta = _start(dt, tmp_path)
    cand = jnni.candidate_arrays(rv)
    np.testing.assert_array_equal(tnni.candidate_arrays(rv), cand)
    want_lnl, want_t = jnni.nni_scores(jeng, jp, jta, cand)
    got_lnl, got_t, site = tnni.nni_scores(teng, tp, tta, cand,
                                           return_site=True)
    assert got_lnl.shape == (N_TAXA - 3, 3)
    np.testing.assert_allclose(got_lnl, want_lnl, rtol=0, atol=LNL_TOL)
    for g, w in zip(got_t, want_t):
        np.testing.assert_allclose(g, w, rtol=0, atol=BLEN_TOL)
    np.testing.assert_allclose(
        (site * teng.weights.numpy()).sum(-1), got_lnl, rtol=0, atol=1e-9)
    # column 0 is the current configuration with its four lengths
    # optimized: never below the tree's lnL
    assert np.all(got_lnl[:, 0] >= float(teng.loglik(tp, tta)) - LNL_TOL)


@pytest.mark.parametrize("dt", DATATYPES)
def test_spr_scores_batched_match_phyml_tpu(dt, tmp_path):
    jeng, jp, teng, tp, _, rv, jta, tta = _start(dt, tmp_path)
    block = [v for v in jspr.prune_candidates(rv)
             if int(rv.parent[v]) != rv.n_nodes - 1][:5]
    mv = [jspr.spr_move_arrays(rv, v) for v in block]
    for (m, va), v in zip(mv, block):
        m2, va2 = tspr.spr_move_arrays(rv, v)
        np.testing.assert_array_equal(m2, m)
        np.testing.assert_array_equal(va2, va)
    masks = np.stack([m for m, _ in mv])
    valids = np.stack([va for _, va in mv])
    want = jspr.spr_scores_batched(jeng, jp, jta, masks, np.asarray(block),
                                   valids)
    got = tspr.spr_scores_batched(teng, tp, tta, masks, np.asarray(block),
                                  valids)
    assert got[0].shape == (len(block), 2 * N_TAXA - 1)
    np.testing.assert_array_equal(np.isneginf(got[0]), ~valids)
    np.testing.assert_array_equal(np.isneginf(want[0]), ~valids)
    np.testing.assert_allclose(got[0][valids], want[0][valids], rtol=0,
                               atol=LNL_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g[valids], w[valids], rtol=0,
                                   atol=BLEN_TOL)
    # one candidate alone scores as it does in the block
    one = tspr.spr_scores(teng, tp, tta, masks[2], block[2], valids[2])
    np.testing.assert_allclose(one[0][valids[2]], got[0][2][valids[2]],
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("dt", DATATYPES)
def test_nni_round_matches_phyml_tpu(dt, tmp_path):
    jeng, jp, teng, tp, topo, *_ = _start(dt, tmp_path)
    jt, jl, jn = jnni.nni_round(jeng, jp, topo.copy())
    tt, tl, tn = tnni.nni_round(teng, tp, topo.copy())
    assert tn == jn and tn > 0
    assert tt.rf_distance(jt) == 0
    assert abs(tl - jl) < LNL_TOL, (tl, jl)
    np.testing.assert_allclose(tt.blen, jt.blen, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dt", DATATYPES)
def test_spr_round_matches_phyml_tpu(dt, tmp_path):
    jeng, jp, teng, tp, topo, *_ = _start(dt, tmp_path)
    jt, jl, jn = jspr.spr_round(jeng, jp, topo.copy(),
                                rng=np.random.default_rng(3))
    tt, tl, tn = tspr.spr_round(teng, tp, topo.copy(),
                                rng=np.random.default_rng(3))
    assert tn == jn and tn > 0
    assert tt.rf_distance(jt) == 0
    assert abs(tl - jl) < LNL_TOL, (tl, jl)


@pytest.mark.parametrize("flags", [[], ["-s", "SPR"]], ids=["NNI", "SPR"])
@pytest.mark.parametrize("dt", DATATYPES)
def test_cli_search_matches_phyml_tpu(dt, flags, tmp_path, monkeypatch):
    """The default run (no -u, -o tlr) and -s SPR: same tree, same
    final lnL."""
    runs = run_both_clis(tmp_path, monkeypatch, dt, flags, **CLI_SIZE[dt])
    (lj, tj), (lt, tt) = runs["jax"], runs["torch"]
    assert tt.rf_distance(tj) == 0
    assert abs(lt - lj) < LNL_TOL, (lt, lj)
    stats = runs["torch_stats"]
    assert "BioNJ" in stats and (flags[-1] if flags else "NNI") in stats


@pytest.mark.parametrize("flag, item", [
    (["--distributed"], "'Supports, bootstrap and multi-GPU'"),
    (["--cov"], "'Covarion, mixtures and partitions'"),
    (["-m", "LG4X"], "'Covarion, mixtures and partitions'"),
    (["--checkpoint", "ck.pkl"], "'Remaining CLI flags and the checkpoint'"),
    (["--cv", "tip"], "'Auxiliary tools'")])
def test_flags_left_unported_stop_the_run(flag, item, tmp_path, capsys):
    aln = tmp_path / "aln.phy"
    aln.write_text(" 4 4\nA  ACGT\nB  ACGA\nC  ACTT\nD  AGGT\n")
    assert tcli.main(["-i", str(aln), "--platform", "cpu", *flag]) == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and flag[0] in err
    assert item in err


@pytest.mark.parametrize("ns, P, want", [
    (4, 3767, 6), (20, 3945, 1), (4, 200, 128), (4, 20, 32)])
def test_spr_block_size_follows_the_reference_rule(ns, P, want):
    """4 GiB over ~10 [n_nodes, C, ns, P] float32 temporaries per
    candidate, at most 128, at most the candidates rounded up to 32;
    the chip_smoke.py problems (128 taxa, C = 4) get 6 (DNA) and 1
    (protein)."""
    n = 128 if P > 100 else 16
    eng = SimpleNamespace(n_nodes=2 * n - 1, C=4, ns=ns, P=P)
    rv = Topology.random(n, np.random.default_rng(0)).rooted()
    assert tspr.default_batch_k(eng, rv) == want
