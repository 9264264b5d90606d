"""The BioNJ start tree of the port against phyml_tpu, on the CPU.

The same simulated alignment (phyml_tpu.evolve, 12 taxa, GTR+G4 or
LG+G4) goes through both packages in float64:

* `class_system(fold_rates=False)`: its P(t) against the reference's
  (P(t), not eigenvectors: eigh's signs and order differ between
  libraries), within 1e-9; the default fold is unchanged;
* the pair counts F and the ML distance matrix D against
  `ml_pairwise_distances`, within 1e-6;
* the BioNJ tree: the same topology; from one D the same tree, edge
  for edge, with lengths within 1e-6;
* the engine's masked scan passes (`_up_pass` / `_down_pass` with prune
  masks, with and without a leading candidate axis) against the
  reference's under jax.vmap, within 1e-9;
* the CLI's `-o lr` run without `-u` (BioNJ, then the fit), and the
  search's `-s BEST` and `--rand_start` runs, against phyml_tpu.cli on
  the same files: the same tree and the final lnL within 1e-6.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu import cli as jcli
from phyml_tpu.evolve import simulate_alignment, write_phylip
from phyml_tpu.io.alignment import read_alignment as jread
from phyml_tpu.models.eigen import pmat as jpmat
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.ops.likelihood import LikelihoodEngine as JEngine
from phyml_tpu.ops.likelihood import tree_arrays as jtree_arrays
from phyml_tpu.topology import Topology
from phyml_tpu_torch import cli as tcli
from phyml_tpu_torch.interop import params_from_numpy, tree_arrays_from_numpy
from phyml_tpu_torch.io.alignment import read_alignment as tread
from phyml_tpu_torch.models.eigen import pmat as tpmat
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine

jdist = importlib.import_module("phyml_tpu.search.distances")
jbionj = importlib.import_module("phyml_tpu.search.bionj")
tdist = importlib.import_module("phyml_tpu_torch.search.distances")
tbionj = importlib.import_module("phyml_tpu_torch.search.bionj")

D_TOL = 1e-6
LNL_TOL = 1e-6
PASS_TOL = 1e-9
N_TAXA, N_SITES = 12, 200
DATATYPES = ["nt", "aa"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test here runs thousands of small tensor ops (the scan
    path's per-node steps, the search's host loops).  Under the suite's
    parallel workers every op's OpenMP region waits for threads that
    share the cores with the other workers, which slows such a test by
    an order of magnitude; one thread runs them at full speed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _simulate(dt, seed=5, n_taxa=N_TAXA, n_sites=N_SITES):
    """(names, seqs, true topology) under GTR+G4 or LG+G4."""
    rng = np.random.default_rng(seed)
    topo = Topology.random(n_taxa, rng, mean_blen=0.1)
    if dt == "nt":
        m = JModel(datatype="nt", name="GTR", n_classes=4,
                   freqs_mode="fixed",
                   fixed_freqs=np.array([0.3, 0.2, 0.3, 0.2]))
        p = m.init_params()
        p["rr_val"] = jnp.log(jnp.asarray([1.2, 3.0, 0.8, 1.1, 4.0, 1.0]))
        p["alpha"] = jnp.asarray(0.7)
    else:
        m = JModel(datatype="aa", name="LG", n_classes=4,
                   freqs_mode="model")
        p = m.init_params()
        p["alpha"] = jnp.asarray(0.9)
    names, seqs = simulate_alignment(topo, m, p, n_sites, rng)
    return names, seqs, topo


def _engines(dt, tmp_path, invar=False, seed=5):
    """float64 engines of both packages on one simulated alignment, and
    one parameter set (random where the model has free parameters)."""
    names, seqs, topo = _simulate(dt, seed)
    path = str(tmp_path / f"aln_{dt}.phy")
    write_phylip(path, names, seqs)
    jaln, taln = jread(path, datatype=dt), tread(path, datatype=dt)
    kw = dict(datatype=dt, name="GTR" if dt == "nt" else "LG",
              n_classes=4, invar=invar)
    jm, tm = JModel(**kw), TModel(**kw)
    rng = np.random.default_rng(seed + 1)
    jp = jm.init_params(jaln.obs_state_freqs)
    if "rr_val" in jp:
        jp["rr_val"] = jnp.log(jnp.asarray(rng.uniform(0.5, 4.0, 6)))
    jp["alpha"] = jnp.asarray(rng.uniform(0.4, 1.5))
    if invar:
        jp["pinv"] = jnp.asarray(0.2)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    jeng = JEngine(jaln, jm, dtype=jnp.float64, use_pallas=False)
    teng = TEngine(taln, tm, dtype=torch.float64, device="cpu")
    return jeng, jp, teng, tp, topo


@pytest.mark.parametrize("dt", DATATYPES)
def test_class_system_unfolded_pmats(dt, tmp_path):
    """fold_rates=False: unit-rate eigenvalues for every class, no
    1/(1-pinv) fold; P(t) as the reference's.  The default keeps both
    folds."""
    jeng, jp, teng, tp, _ = _engines(dt, tmp_path, invar=True)
    t = np.array([[0.01] * 4, [0.1] * 4, [0.7] * 4, [2.0] * 4])
    for fold in (False, True):
        js = jeng.model.class_system(jp, fold_rates=fold)
        ts = teng.model.class_system(tp, fold_rates=fold)
        want = np.asarray(jpmat(js[0], js[1], js[2], jnp.asarray(t)))
        got = tpmat(ts[0], ts[1], ts[2], torch.as_tensor(t)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=PASS_TOL)
    unf = teng.model.class_system(tp, fold_rates=False)[0]
    fold = teng.model.class_system(tp)[0]
    # every class shares the unit-rate spectrum; the fold scales it
    torch.testing.assert_close(unf, unf[:1].expand_as(unf))
    assert not torch.allclose(unf, fold)


@pytest.mark.parametrize("dt", DATATYPES)
def test_distances_match_phyml_tpu(dt, tmp_path):
    """Pair counts (i < j, row-major, definite states only) and D."""
    jeng, jp, teng, tp, _ = _engines(dt, tmp_path, invar=True)
    k = teng.P
    F_j = np.asarray(jdist._all_pair_counts(jeng.tips, jeng.weights))
    F_t = tdist._all_pair_counts(teng.tips, teng.weights).numpy()
    assert F_t.shape == F_j.shape == (N_TAXA * (N_TAXA - 1) // 2,
                                      teng.ns, teng.ns)
    np.testing.assert_allclose(F_t, F_j, rtol=0, atol=D_TOL)
    assert F_t.sum() > 0 and teng.tips.shape[-1] == k
    D_j = jdist.ml_pairwise_distances(jeng, jp)
    D_t = tdist.ml_pairwise_distances(teng, tp)
    np.testing.assert_allclose(D_t, D_j, rtol=0, atol=D_TOL)
    assert np.all(D_t == D_t.T) and np.all(np.diag(D_t) == 0)
    iu = np.triu_indices(N_TAXA, k=1)
    assert np.all((D_t[iu] >= tdist.DIST_MIN) & (D_t[iu] <= tdist.DIST_MAX))


def test_pair_counts_in_chunks(monkeypatch, tmp_path):
    """Chunked pair counts give the same F as one chunk."""
    _, _, teng, _, _ = _engines("aa", tmp_path)
    whole = tdist._all_pair_counts(teng.tips, teng.weights)
    monkeypatch.setattr(tdist, "_CHUNK_BYTES", 1)    # one pair a chunk
    torch.testing.assert_close(
        tdist._all_pair_counts(teng.tips, teng.weights), whole,
        rtol=0, atol=0)


@pytest.mark.parametrize("dt", DATATYPES)
def test_bionj_tree_matches_phyml_tpu(dt, tmp_path):
    """bionj_start: the same topology; on the same D, the same tree,
    edge for edge, with the same lengths.

    The two D agree to ~1e-15, but BioNJ's last join (4 clusters left)
    is a tie in exact arithmetic: the Q criterion of a pair equals that
    of its complement, so rounding picks the pair, and the two packages
    may join complementary pairs there.  The topology is the same; the
    lengths of the last three-star differ (ROADMAP Queue 3)."""
    jeng, jp, teng, tp, truth = _engines(dt, tmp_path)
    jt = jbionj.bionj_start(jeng, jp)
    tt = tbionj.bionj_start(teng, tp)
    assert tt.rf_distance(jt) == 0
    assert tt.rf_distance(truth) <= 2 * (N_TAXA - 3)
    D = jdist.ml_pairwise_distances(jeng, jp)
    jt, tt = jbionj.bionj(D), tbionj.bionj(D)
    np.testing.assert_array_equal(tt.edges, jt.edges)
    np.testing.assert_allclose(tt.blen, jt.blen, rtol=0, atol=D_TOL)


def _passes(dt, tmp_path, mask_shape, seed):
    jeng, jp, teng, tp, topo = _engines(dt, tmp_path, seed=seed)
    rng = np.random.default_rng(seed)
    jta = jtree_arrays(Topology.random(N_TAXA, rng).rooted(),
                       dtype=jnp.float64)
    tta = tree_arrays_from_numpy(np.asarray(jta.child), np.asarray(jta.blen),
                                 device="cpu", dtype=torch.float64)
    mask = None if mask_shape is None else \
        (rng.random(mask_shape + (N_TAXA - 1, 2)) < 0.25).astype(np.float32)
    js, ts = jeng.system_of(jp), teng.system_of(tp)
    jpm = jeng._pmats(js[0], js[1], js[2], jta.blen)
    tpm = teng._pmats(ts[0], ts[1], ts[2], tta.blen)

    def core(m):
        pup, clv, sc = jeng._up_pass(jpm, jta.child, m)
        out, sc_out = jeng._down_pass(jpm, jta.child, pup, sc, js[3], m)
        return pup, clv, sc, out, sc_out

    if mask is not None and mask.ndim == 3:
        want = jax.vmap(core)(jnp.asarray(mask))
    else:
        want = core(None if mask is None else jnp.asarray(mask))
    pup, clv, sc = teng._up_pass(tpm, tta.child, mask)
    got = (pup, clv, sc) + teng._down_pass(tpm, tta.child, pup, sc, ts[3],
                                           mask)
    return [np.asarray(w)[..., :teng.P] for w in want], got


@pytest.mark.parametrize("mask_shape", [None, (), (3,)],
                         ids=["unmasked", "one-mask", "candidates"])
@pytest.mark.parametrize("dt", DATATYPES)
def test_masked_passes_match_phyml_tpu(dt, mask_shape, tmp_path):
    """pup, clv, sc, out and sc_out of the (masked) passes, a leading
    candidate axis against jax.vmap over the masks."""
    want, got = _passes(dt, tmp_path, mask_shape, seed=3)
    lead = () if mask_shape is None else mask_shape
    assert got[0].shape == lead + (2 * N_TAXA - 1, 4, got[0].shape[-2],
                                   got[0].shape[-1])
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=PASS_TOL)


def test_unmasked_pass_unchanged_by_an_all_zero_mask(tmp_path):
    """A zero mask row changes nothing: the masked passes skip the
    masking arithmetic there and equal the unmasked ones."""
    _, _, teng, tp, _ = _engines("nt", tmp_path)
    rng = np.random.default_rng(1)
    tta = tree_arrays_from_numpy(
        Topology.random(N_TAXA, rng).rooted().child,
        rng.exponential(0.1, 2 * N_TAXA - 1), device="cpu",
        dtype=torch.float64)
    s = teng.system_of(tp)
    pm = teng._pmats(s[0], s[1], s[2], tta.blen)
    base = teng._up_pass(pm, tta.child)
    zero = teng._up_pass(pm, tta.child, np.zeros((2, N_TAXA - 1, 2)))
    for b, z in zip(base, zero):
        torch.testing.assert_close(z, b.expand_as(z), rtol=0, atol=0)


def _stats_lnl(monkeypatch, module):
    """Capture the full-precision lnL the CLI hands its stats writer."""
    seen = []
    real = module.format_stats

    def spy(**kw):
        seen.append(kw["lnl"])
        return real(**kw)

    monkeypatch.setattr(module, "format_stats", spy)
    return seen


def run_both_clis(tmp_path, monkeypatch, dt, flags, **size):
    """Both CLIs on the same simulated files (_simulate's, of `size`);
    returns {tag: (lnL, tree)} and {tag + "_stats": stats file text}."""
    import phyml_tpu.io.output as jout
    import phyml_tpu_torch.io.output as tout

    names, seqs, _ = _simulate(dt, **size)
    model = ["-m", "GTR"] if dt == "nt" else ["-d", "aa", "-m", "LG"]
    runs = {}
    for tag, main, mod in (("jax", jcli.main, jout),
                           ("torch", tcli.main, tout)):
        d = tmp_path / tag
        d.mkdir()
        aln = str(d / "aln.phy")
        write_phylip(aln, names, seqs)
        seen = _stats_lnl(monkeypatch, mod)
        argv = ["-i", aln, *model, "-c", "4", "-b", "0", "--platform",
                "cpu", "--r_seed", "1", "--quiet", *flags]
        assert main(argv) == 0
        with open(f"{aln}_phyml_tree.txt") as fh:
            runs[tag] = (float(seen[-1]), Topology.from_newick(fh.read(),
                                                              names))
        with open(f"{aln}_phyml_stats.txt") as fh:
            runs[tag + "_stats"] = fh.read()
    return runs


@pytest.mark.parametrize("dt", DATATYPES)
def test_cli_bionj_fit_matches_phyml_tpu(dt, tmp_path, monkeypatch):
    """`-o lr` without -u: BioNJ, then the fixed-topology fit."""
    runs = run_both_clis(tmp_path, monkeypatch, dt, ["-o", "lr"])
    (lj, tj), (lt, tt) = runs["jax"], runs["torch"]
    assert tt.rf_distance(tj) == 0
    assert abs(lt - lj) < LNL_TOL, (lt, lj)
    assert "BioNJ" in runs["torch_stats"]


@pytest.mark.parametrize("flags", [
    ["-s", "BEST"], ["--rand_start", "--n_rand_starts", "2"]],
    ids=["best", "rand-start"])
def test_cli_search_options_match_phyml_tpu(flags, tmp_path, monkeypatch):
    """-s BEST (NNI and SPR, the better kept) and --rand_start (random
    start trees drawn from the run's seed) on 8-taxon DNA: the same tree
    and final lnL as phyml_tpu.cli."""
    runs = run_both_clis(tmp_path, monkeypatch, "nt", flags, n_taxa=8,
                         n_sites=150)
    (lj, tj), (lt, tt) = runs["jax"], runs["torch"]
    assert tt.rf_distance(tj) == 0
    assert abs(lt - lj) < LNL_TOL, (lt, lj)
    assert ("random" if "--rand_start" in flags else "BEST") in \
        runs["torch_stats"]
