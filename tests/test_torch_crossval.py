"""Cross-validation of the port against phyml_tpu, on the CPU.

Simulated alignments (tests/test_torch_bionj.py's GTR+G4 one, and
DNA covarion from tests/test_torch_ancestral.py) go through both
packages' float64 engines on the same tree:

* `tip_predictive_probs` within 1e-8 (PROB_TOL), DNA and covarion
  (whose probabilities sum over the hidden classes);
* `tip_cv`: the same truth table, log predictive probabilities and
  score within 1e-8;
* `kfold_col_cv` and `kfold_pos_cv` from one numpy seed: the same folds
  and masked cells (phyml_tpu's draws in its order), the held-out
  totals within 1e-3 (REFIT_TOL: each fold refits, and the refits stop
  on tolerance);
* `roc_points`: the same curve;
* the `_phyml_cv.txt` of `--cv tip`, `--cv kfold.col` and `--cv
  kfold.pos` through both CLIs (`-u tree -o lr`): the same lines, the
  numbers in them within REFIT_TOL.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu import cli as jcli
from phyml_tpu.evolve import write_phylip
from phyml_tpu.io.alignment import read_alignment as jread
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.ops import crossval as jcv
from phyml_tpu.ops.likelihood import LikelihoodEngine as JEngine
from phyml_tpu.ops.likelihood import tree_arrays as jtree_arrays
from phyml_tpu_torch import cli as tcli
from phyml_tpu_torch.interop import params_from_numpy, tree_arrays_from_numpy
from phyml_tpu_torch.io.alignment import read_alignment as tread
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.ops import crossval as tcv
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine
from test_torch_ancestral import _covarion
from test_torch_bionj import _engines, _simulate

PROB_TOL = 1e-8
REFIT_TOL = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """As in tests/test_torch_bionj.py: one torch thread for the scan
    path's and the refits' many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(topo):
    rv = topo.rooted()
    return (jtree_arrays(rv, dtype=jnp.float64),
            tree_arrays_from_numpy(rv.child, rv.node_blen, device="cpu",
                                   dtype=torch.float64))


def _pair(kind, tmp_path):
    if kind == "covarion":
        jeng, jp, teng, tp, topo = _covarion(tmp_path)
    else:
        jeng, jp, teng, tp, topo = _engines("nt", tmp_path)
    return (jeng, jp, teng, tp) + _trees(topo)


@pytest.mark.parametrize("kind", ["gtr_g4", "covarion"])
def test_tip_predictive_probs_match_phyml_tpu(kind, tmp_path):
    jeng, jp, teng, tp, jta, tta = _pair(kind, tmp_path)
    want = jcv.tip_predictive_probs(jeng, jp, jta)
    got = tcv.tip_predictive_probs(teng, tp, tta)
    assert got.shape == (teng.n_otu, teng.aln.n_patterns, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-12)


@pytest.mark.parametrize("kind", ["gtr_g4", "covarion"])
def test_tip_cv_matches_phyml_tpu(kind, tmp_path):
    jeng, jp, teng, tp, jta, tta = _pair(kind, tmp_path)
    want = jcv.tip_cv(jeng, jp, jta)
    got = tcv.tip_cv(teng, tp, tta)
    np.testing.assert_array_equal(got["truth"], want["truth"])
    np.testing.assert_allclose(got["logpred"], want["logpred"], rtol=0,
                               atol=PROB_TOL)
    assert abs(got["score"] - want["score"]) <= PROB_TOL
    fj, tj = jcv.roc_points(want["probs"], want["truth"])
    ft, tt = tcv.roc_points(got["probs"], got["truth"])
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(tt, tj)


def _small(tmp_path, n_taxa=8, n_sites=100):
    """HKY85+G4 float64 engines of both packages on an 8-taxon
    simulated alignment, its simulating tree: the refits' problem."""
    names, seqs, topo = _simulate("nt", n_taxa=n_taxa, n_sites=n_sites)
    path = str(tmp_path / "small.phy")
    write_phylip(path, names, seqs)
    jaln, taln = jread(path, datatype="nt"), tread(path, datatype="nt")
    kw = dict(datatype="nt", name="HKY85", n_classes=4,
              optimize_alpha=True)
    jm, tm = JModel(**kw), TModel(**kw)
    jp = jm.init_params(jaln.obs_state_freqs)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    jeng = JEngine(jaln, jm, dtype=jnp.float64, use_pallas=False)
    teng = TEngine(taln, tm, dtype=torch.float64, device="cpu")
    return (jaln, taln, jm, tm, jeng, jp, teng, tp) + _trees(topo)


def test_kfold_col_cv_matches_phyml_tpu(tmp_path):
    jaln, taln, jm, tm, jeng, jp, teng, tp, jta, tta = _small(tmp_path)
    jt, jf = jcv.kfold_col_cv(jeng, jm, jp, jta, n_folds=3,
                              rng=np.random.default_rng(4))
    tt, tf = tcv.kfold_col_cv(teng, tm, tp, tta, n_folds=3,
                              rng=np.random.default_rng(4))
    assert len(tf) == len(jf) == 3
    np.testing.assert_allclose(tf, jf, rtol=0, atol=REFIT_TOL)
    assert abs(tt - jt) <= REFIT_TOL


def test_kfold_pos_cv_matches_phyml_tpu(tmp_path):
    jaln, taln, jm, tm, jeng, jp, teng, tp, jta, tta = _small(tmp_path)
    cells = {}

    def spy(mod, tag):
        real = mod.mask_cells

        def run(aln, c):
            cells[tag] = sorted((int(a), int(b)) for a, b in c)
            return real(aln, c)
        return run

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jcv, "mask_cells", spy(jcv, "jax"))
        mp.setattr(tcv, "mask_cells", spy(tcv, "torch"))
        js, jn = jcv.kfold_pos_cv(
            lambda a: JEngine(a, jm, dtype=jnp.float64, use_pallas=False),
            jaln, jm, jp, jta, mask_prob=0.1, rng=np.random.default_rng(6))
        ts, tn = tcv.kfold_pos_cv(
            lambda a: TEngine(a, tm, dtype=torch.float64, device="cpu"),
            taln, tm, tp, tta, mask_prob=0.1, rng=np.random.default_rng(6))
    finally:
        mp.undo()
    assert cells["torch"] == cells["jax"] and tn == jn > 0
    assert abs(ts - js) <= REFIT_TOL


def test_mask_cells_copies(tmp_path):
    _, taln, *_ = _small(tmp_path)
    masked = tcv.mask_cells(taln, [(0, 0), (2, 3)])
    assert (masked.partials[0, 0] == 1).all()
    assert (masked.partials[2, 3] == 1).all()
    assert taln.partials[0, 0].sum() == 1
    assert masked.names == taln.names


NUM = re.compile(r"-?\d+\.\d+")


@pytest.mark.parametrize("mode", ["tip", "kfold.col", "kfold.pos"])
def test_cli_cv_files_match_phyml_tpu(mode, tmp_path):
    names, seqs, topo = _simulate("nt", n_taxa=8, n_sites=100)
    out = {}
    for tag, main in (("jax", jcli.main), ("torch", tcli.main)):
        d = tmp_path / tag
        d.mkdir()
        aln = str(d / "aln.phy")
        write_phylip(aln, names, seqs)
        (d / "tree.nwk").write_text(topo.to_newick(names) + "\n")
        argv = ["-i", aln, "-u", str(d / "tree.nwk"), "-m", "HKY85", "-c",
                "4", "-o", "lr", "-b", "0", "--platform", "cpu",
                "--r_seed", "2", "--quiet", "--cv", mode]
        assert main(argv) == 0
        out[tag] = open(f"{aln}_phyml_cv.txt").read().splitlines()
    j, t = out["jax"], out["torch"]
    assert len(t) == len(j) > 3
    assert t[0] == f". Cross-validation mode: {mode}"
    for a, b in zip(j, t):
        assert NUM.sub("#", a) == NUM.sub("#", b), (a, b)
        np.testing.assert_allclose([float(x) for x in NUM.findall(b)],
                                   [float(x) for x in NUM.findall(a)],
                                   rtol=0, atol=REFIT_TOL, err_msg=a)
