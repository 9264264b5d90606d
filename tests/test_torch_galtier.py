"""LG under Galtier's covarion-like model (80 states): the port against
the benchmark's plain reference (portbench/reference/models/LG_GALTIER.py,
reference/lnl.py, reference/nni.py), which imports nothing of the port.

On the CPU, in float64, at 8 taxa x 300 sites simulated by the
benchmark's generator at seeded random values of cov_alpha and
cov_delta:

* the generator: the port's Q (V diag(lam) V^-1 of `class_system`), pi
  and the observed-substitution scale against the reference's, at 2 and
  4 hidden classes;
* the tree's lnL;
* every internal edge's three NNI lnL and its aBayes support, from
  `alrt_supports(method="abayes")`;
* the harness's round trip: hidden states written as their letters,
  read back and folded onto 80 states, equal to the port's tip map.

On the card (marked `gpu`; run this file with `--noconftest -m gpu`,
the machine with the card has no JAX): the float32 card path against
the float64 reference at 16 taxa x 2,000 sites.
"""

import copy

import numpy as np
import pytest
import torch

from phyml_tpu_torch import cli
from phyml_tpu_torch.io.alignment import read_alignment
from phyml_tpu_torch.models.substitution import SubstModel
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
from phyml_tpu_torch.search import support
from phyml_tpu_torch.topology import Topology
from portbench import checks, gen, harness, registry, units
from portbench.reference import lnl as L
from portbench.reference import model as M
from portbench.reference import nni as N

CELL = "aa120x10240-galtier4.abayes"
G = registry.load("reference/models", "LG_GALTIER")
F64 = torch.float64

# Q from two eigendecompositions of one 80 x 80 float64 matrix: entries
# O(1), rounding ~1e-15 a product, 1e-14 seen
Q_TOL = 1e-12
# float64 on both sides, the same lengths; the two pruning orders and
# eigensystems differ by rounding (~1e-13 of |lnL| ~ 1e4)
LNL_TOL = 1e-7
# the same, after ten Newton steps from the same lengths (1e-11 seen)
NNI_TOL = 1e-6
# supports are ratios of exp(lnL) differences: as the differences
SUPPORT_TOL = 1e-6
# the card in float32 against float64: rounding of the 80-state pruning,
# relative to |lnL| (an H100 read 2.3e-7), and the NNI gaps in lnL units
# (an H100 read 3.8e-3 in the differences, 2.7e-4 in the log supports)
CARD_LNL_TOL = 2e-6
CARD_NNI_TOL = 0.03


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The Tier-1 run's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(taxa, sites):
    cfg = copy.deepcopy(harness.cell_of(harness.manifest(), CELL)[2])
    cfg["data"]["taxa"], cfg["data"]["sites"] = taxa, sites
    return cfg


def problem(tmp_path, taxa, sites, seed, device="cpu", dtype=F64):
    """(config, alignment path, port engine, model, params, topology,
    reference data, values): the cell's configuration cut to taxa x
    sites, its data and tree from the generator, the port's model at
    seeded random cov_alpha and cov_delta."""
    cfg = config(taxa, sites)
    aln_path, tree_path = gen.write_problem(cfg, seed, str(tmp_path))
    argv = ["-i", aln_path, "-u", tree_path] + cfg["phyml_args"]
    args = cli.build_parser().parse_args(argv)
    aln = read_alignment(aln_path, datatype=args.datatype)
    model = cli._build_model(args, aln)
    params = cli._init_params(args, model, aln)
    rng = np.random.default_rng(seed)
    params["cov_alpha"] = torch.tensor(rng.uniform(0.4, 2.0), dtype=F64)
    params["cov_delta"] = torch.tensor(rng.uniform(0.2, 1.5), dtype=F64)
    eng = LikelihoodEngine(aln, model, dtype=dtype, device=device)
    with open(tree_path) as fh:
        topo = Topology.from_newick(fh.read(), aln.names)
    data = L.data_of(aln_path, cfg)
    return (cfg, aln_path, eng, model, params, topo, data,
            units.values_of(params))


def port_nni(eng, model, params, topo):
    """(supports, cand, lnl [E, 3]) of one `alrt_supports` call, the
    scorer's lnL taken from the call inside it (as the harness does)."""
    seen = []

    def keep(orig):
        def nni_scores(*a, **kw):
            out = orig(*a, **kw)
            seen.append((np.asarray(a[3]).copy(),
                         np.asarray(out[0], dtype=np.float64).copy()))
            return out
        return nni_scores

    with units.patched(support, "nni_scores", keep):
        sup = support.alrt_supports(eng, model, params, topo,
                                    method="abayes")
    assert len(seen) == 1
    return sup, seen[0][0].astype(np.int64), seen[0][1]


def columns(tips_pn, weights):
    """{site column's bytes: summed weight} of tips [P, n, 80]."""
    out = {}
    for col, w in zip(tips_pn, weights):
        key = np.asarray(col, dtype=np.float64).tobytes()
        out[key] = out.get(key, 0.0) + float(w)
    return out


@pytest.mark.parametrize("K", [2, 4])
def test_generator_matches_the_port(K):
    rng = np.random.default_rng(40 + K)
    freqs = rng.dirichlet(np.full(20, 4.0))
    alpha, delta = rng.uniform(0.4, 2.0), rng.uniform(0.2, 1.5)
    model = SubstModel(datatype="aa", name="LG", n_classes=1,
                       covarion=True, n_hidden=K, cov_mode="alpha")
    params = model.init_params(freqs)
    params["cov_alpha"] = torch.tensor(alpha, dtype=F64)
    params["cov_delta"] = torch.tensor(delta, dtype=F64)
    lam, V, Vinv, pi, w, _ = model.class_system(params)
    Q = (V[0] * lam[0][None, :]) @ Vinv[0]

    x = torch.tensor(np.log([alpha, delta]), dtype=F64)
    S, pi_r, rate, w_r = G.mixture(x, torch.as_tensor(freqs), {"hidden": K})
    lam_r, V_r, Vinv_r = M.eigen(S[0].numpy(), pi_r[0].numpy())
    Q_r = (V_r * (lam_r * float(rate))[None, :]) @ Vinv_r
    assert S.shape == (1, 20 * K, 20 * K) and float(w_r) == 1.0
    assert np.abs(Q.numpy() - Q_r).max() < Q_TOL
    assert np.abs(pi[0].numpy() - pi_r[0].numpy()).max() < 1e-15
    # one observed substitution a unit of length; a class is left at
    # delta, so the total event rate is 1 + delta
    off = Q * (1.0 - torch.eye(20 * K, dtype=F64))
    total, obs = G.observed_rate(off, pi[0])
    assert float(obs) == pytest.approx(1.0, abs=1e-13)
    assert float(total) == pytest.approx(1.0 + delta, abs=1e-13)
    assert float(rate) == pytest.approx(1.0 + delta, abs=1e-13)


def test_tree_lnl_matches_the_reference(tmp_path):
    cfg, _, eng, model, params, topo, data, values = problem(
        tmp_path, 8, 300, 2 ** 31 + 11)
    ta = tree_arrays(topo.rooted(), dtype=F64, device="cpu")
    got = float(eng.loglik(params, ta))
    rt = L.root(topo.edges, len(data.names))
    want = L.loglik(rt, *L.system(cfg, data, values), data, topo.blen)
    assert abs(got - want) < LNL_TOL


def test_nni_lnl_and_abayes_match_the_reference(tmp_path):
    cfg, _, eng, model, params, topo, data, values = problem(
        tmp_path, 8, 300, 2 ** 31 + 12)
    sup, cand, lnl = port_nni(eng, model, params, topo)
    r_cand, eid, ref = N.nni_lnl(cfg, data, np.asarray(topo.edges),
                                 np.asarray(topo.blen), values)
    _, diff, log_sup = checks.nni_reading(r_cand, eid, ref, cand, lnl, sup)
    assert np.abs(lnl - ref).max() < NNI_TOL
    assert diff < NNI_TOL
    assert log_sup < SUPPORT_TOL
    for e, s in zip(eid, N.abayes(ref)):
        assert sup[int(e)] == pytest.approx(float(s), abs=SUPPORT_TOL)


def test_hidden_states_round_trip_to_the_port_tip_map(tmp_path):
    """The generator writes each of the 80 simulated states as its
    observed letter; the reference reads the letters back and folds
    them onto 80 states as the port's tip map does: the same columns
    with the same counts, and the same observed frequencies."""
    seed = 2 ** 33 + 3
    cfg, aln_path, eng, _, _, _, data, _ = problem(tmp_path, 8, 300, seed)
    d = cfg["data"]
    rng = gen.rng_of(d["data_seed"])
    edges, blen = gen.random_tree(8, rng, d["mean_branch_length"])
    states = gen.simulate(edges, blen, 8, cfg, 300, rng)
    states = states[:, gen.rng_of(seed).permutation(300)]
    assert states.max() >= 60            # every hidden class visited
    letters = np.asarray(list(G.ALPHABET))[states]
    assert all(set(G.ALPHABET[20 * h:20 * h + 20]) == set(M.AA_STATES)
               for h in range(4))
    _, rows = L.read_phylip(aln_path)
    assert ["".join(r) for r in letters] == rows

    ref = columns(data.tips.permute(1, 0, 2).numpy(), data.weights.numpy())
    port = columns(eng.tips.permute(2, 0, 1).numpy(), eng.weights.numpy())
    assert ref == port
    assert np.abs(G.observed(torch.as_tensor(data.freqs)).numpy()
                  - eng.aln.obs_state_freqs).max() < 1e-15


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_path_against_the_float64_reference(cuda, tmp_path):
    """The float32 card path (K4/K5's big bodies for the lnL, the NNI
    scorer with K6) at 16 taxa x 2,000 sites against the float64
    reference at the same point."""
    cfg, _, eng, model, params, topo, data, values = problem(
        tmp_path, 16, 2000, 2 ** 32 + 21, device=cuda, dtype=torch.float32)
    ta = tree_arrays(topo.rooted(), dtype=torch.float32, device=cuda)
    got = float(eng.loglik(params, ta))
    rt = L.root(topo.edges, len(data.names))
    want = L.loglik(rt, *L.system(cfg, data, values), data, topo.blen)
    sup, cand, lnl = port_nni(eng, model, params, topo)
    r_cand, eid, ref = N.nni_lnl(cfg, data, np.asarray(topo.edges),
                                 np.asarray(topo.blen), values)
    _, diff, log_sup = checks.nni_reading(r_cand, eid, ref, cand, lnl, sup)
    print(f"lnL {got!r} vs {want!r}; NNI differences {diff!r}, "
          f"log supports {log_sup!r}")
    assert abs(got - want) < CARD_LNL_TOL * abs(want)
    assert diff < CARD_NNI_TOL
    assert log_sup < CARD_NNI_TOL
