"""Matrix mixtures, custom AA matrices and the IL model, against
phyml_tpu on the CPU.

Three class systems whose classes really differ or whose table comes
from a file, built the same way in both packages:

* LG4X (`lg4x_model`): four Q matrices, four `pi` tables, FreeRate
  rates and weights;
* a two-matrix DNA mixture as an XML <mixtureelem> list assembles one
  (`components`): an HKY85 class (kappa 4) and a GTR class, each with
  its own `pi` (`freqs_mode="model"`), FreeRate rates and weights;
* CUSTOMAA (`custom_aa`, the `--aa_rate_file` model): a PAML file
  written from `lg4x_2`, read by each package's `read_paml_matrix`,
  under +G4.

Checks, float64 against phyml_tpu under x64 (inputs from a numpy seed,
carried across with `interop.params_from_numpy`):

* `class_system`: P(t), `pi` and the weights within 1e-10, unbatched
  and with a leading batch axis (the line search's), row for row
  against phyml_tpu's unbatched system (P(t), never eigenvectors);
* the engine's lnL at random starting parameters, and after
  `round_optimize`, within 1e-6; the IL model's fit too;
* the kernels' plain versions at the LG4X system (K4, K5, K3 over a
  batch) and the DNA mixture (K1, K2) against phyml_tpu's Pallas
  kernels in interpret mode (as tests/test_pallas.py runs them),
  float32, 2e-3 / 5e-4 per site: a read of class 0's V, V^-1 or `pi`
  in place of class c's shows there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu.evolve import simulate_alignment, write_phylip
from phyml_tpu.io.alignment import read_alignment as jread
from phyml_tpu.models import matrices as jmat
from phyml_tpu.models.eigen import pmat as jpmat
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.models.substitution import lg4x_model as jlg4x
from phyml_tpu.ops import pallas_clv, pallas_clv_slots, pallas_edotp
from phyml_tpu.ops.likelihood import LikelihoodEngine as JEngine
from phyml_tpu.ops.likelihood import tree_arrays as jtree_arrays
from phyml_tpu.optim.round import round_optimize as jround
from phyml_tpu.topology import Topology
from phyml_tpu_torch.interop import params_from_numpy, tree_arrays_from_numpy
from phyml_tpu_torch.io.alignment import read_alignment as tread
from phyml_tpu_torch.models import matrices as tmat
from phyml_tpu_torch.models.eigen import pmat as tpmat
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.models.substitution import lg4x_model as tlg4x
from phyml_tpu_torch.ops import clv, clv_slots, edotp
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine
from phyml_tpu_torch.optim.round import round_optimize as tround

PMAT_TOL = 1e-10
LNL_TOL = 1e-6
SITE_TOL = {"nt": 5e-4, "aa": 2e-3}   # float32 kernels (test_pallas.py)
STREAM_T = 128                        # the streamed Pallas kernels' tile
MODELS = ["lg4x", "dna_mix", "custom_aa"]
# DNA mixture classes: HKY85 (kappa 4) and GTR, each its own pi
GTR_RR = [1.2, 3.0, 0.8, 1.1, 4.0, 1.0]     # AC AG AT CG CT GT
DNA_PI = [[0.3, 0.2, 0.3, 0.2], [0.2, 0.3, 0.25, 0.25]]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """As in tests/test_torch_bionj.py: one torch thread for the many
    small ops of the fits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_paml(path, S, pi):
    """A PAML rate file: 19 lower-triangular rows, then 20 freqs."""
    rows = [" ".join(f"{S[i, j]:.10f}" for j in range(i))
            for i in range(1, 20)]
    with open(path, "w") as fh:
        fh.write("\n".join(rows) + "\n\n"
                 + " ".join(f"{p:.10f}" for p in pi) + "\n")


def _dna_components():
    hky = np.ones((4, 4)) - np.eye(4)
    hky[0, 2] = hky[2, 0] = hky[1, 3] = hky[3, 1] = 4.0
    gtr = np.zeros((4, 4))
    iu = np.triu_indices(4, k=1)
    gtr[iu] = GTR_RR
    gtr = gtr + gtr.T
    return [(hky, np.asarray(DNA_PI[0])), (gtr, np.asarray(DNA_PI[1]))]


def models(kind, tmp_path):
    """(phyml_tpu model, port model) of one kind."""
    if kind == "lg4x":
        return jlg4x(), tlg4x()
    if kind == "dna_mix":
        kw = dict(datatype="nt", name="XMLMIX", n_classes=2,
                  freerate=True, freqs_mode="model")
        return (JModel(components=_dna_components(), **kw),
                TModel(components=_dna_components(), **kw))
    path = str(tmp_path / "lg4x_2.dat")
    write_paml(path, *jmat.empirical_aa("lg4x_2"))
    kw = dict(datatype="aa", name="CUSTOMAA", n_classes=4)
    return (JModel(custom_aa=jmat.read_paml_matrix(path), **kw),
            TModel(custom_aa=tmat.read_paml_matrix(path), **kw))


def random_params(jm, seed, B=None):
    """phyml_tpu's starting parameters with random free values (a
    leading batch axis B on the searched ones when given), as numpy."""
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in jm.init_params(
        np.full(jm.obs_ns, 1.0 / jm.obs_ns)).items()}
    lead = () if B is None else (B,)
    if "class_rates_raw" in p:
        n = p["class_rates_raw"].shape[0]
        p["class_rates_raw"] = rng.normal(0.0, 1.0, lead + (n,))
        p["class_weights_raw"] = rng.normal(0.0, 0.7, (n,))
    if "alpha" in p:
        p["alpha"] = rng.uniform(0.4, 1.5, lead)
    return p


def _row(p, b):
    return {k: (v[b] if k in ("class_rates_raw", "alpha") and v.ndim >
                (1 if k == "class_rates_raw" else 0) else v)
            for k, v in p.items()}


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("kind", MODELS)
def test_class_system_matches_phyml_tpu(kind, batched, tmp_path):
    """P(t), pi and the class weights; a batch [B] of parameter sets
    against phyml_tpu's unbatched system row by row."""
    jm, tm = models(kind, tmp_path)
    B = 3 if batched else None
    p = random_params(jm, 11, B)
    ts = tm.class_system(params_from_numpy(p))
    C = tm.n_classes
    t = np.array([[0.01] * C, [0.2] * C, [1.5] * C])
    for b in range(B or 1):
        pb = _row(p, b) if batched else p
        js = jm.class_system({k: jnp.asarray(v) for k, v in pb.items()})
        tsb = [x[b] for x in ts] if batched else ts
        want = np.asarray(jpmat(js[0], js[1], js[2], jnp.asarray(t)))
        got = tpmat(tsb[0], tsb[1], tsb[2], torch.as_tensor(t)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=PMAT_TOL)
        for i in (3, 4):     # pi, w
            np.testing.assert_allclose(tsb[i].numpy(), np.asarray(js[i]),
                                       rtol=0, atol=PMAT_TOL)
    if kind != "custom_aa":
        pi = ts[3][0] if batched else ts[3]
        # the classes' frequency tables really differ
        assert float((pi[1] - pi[0]).abs().max()) > 1e-2


def _problem(kind, tmp_path, seed=3):
    """Both packages' float64 engines on one alignment simulated by
    phyml_tpu under the model, a random tree and random parameters."""
    jm, tm = models(kind, tmp_path)
    rng = np.random.default_rng(seed)
    n_taxa, n_sites = (12, 200) if jm.datatype == "nt" else (8, 150)
    topo = Topology.random(n_taxa, rng, mean_blen=0.1)
    p = random_params(jm, seed)
    names, seqs = simulate_alignment(
        topo, jm, {k: jnp.asarray(v) for k, v in p.items()}, n_sites, rng)
    path = str(tmp_path / f"{kind}.phy")
    write_phylip(path, names, seqs)
    dt = jm.datatype
    jaln, taln = jread(path, datatype=dt), tread(path, datatype=dt)
    start = Topology.random(n_taxa, rng, mean_blen=0.1).rooted()
    p.update({k: np.asarray(v) for k, v in
              jm.init_params(jaln.obs_state_freqs).items()
              if k in ("freqs_const",)})
    jeng = JEngine(jaln, jm, dtype=jnp.float64, use_pallas=False)
    teng = TEngine(taln, tm, dtype=torch.float64, device="cpu")
    jta = jtree_arrays(start, dtype=jnp.float64)
    tta = tree_arrays_from_numpy(start.child, start.node_blen,
                                 device="cpu", dtype=torch.float64)
    return dict(jm=jm, tm=tm, jeng=jeng, teng=teng, jta=jta, tta=tta,
                jp={k: jnp.asarray(v) for k, v in p.items()},
                tp=params_from_numpy(p))


@pytest.mark.parametrize("kind", MODELS)
def test_loglik_matches_phyml_tpu(kind, tmp_path):
    pb = _problem(kind, tmp_path)
    want = float(pb["jeng"].loglik(pb["jp"], pb["jta"]))
    got = float(pb["teng"].loglik(pb["tp"], pb["tta"]))
    assert abs(got - want) < LNL_TOL, (got, want)


@pytest.mark.parametrize("kind", ["lg4x", "dna_mix", "il"])
def test_round_optimize_matches_phyml_tpu(kind, tmp_path):
    """The fit: branch lengths and every free scalar (LG4X: 4 rates and
    3 weights; the DNA mixture: 2 + 1; IL: alpha, kappa and sigma on
    HKY85+G4), the final lnL within 1e-6."""
    pb = _problem("dna_mix" if kind == "il" else kind, tmp_path)
    if kind == "il":
        kw = dict(datatype="nt", name="HKY85", n_classes=4)
        jm, tm = JModel(**kw), TModel(**kw)
        p = {k: np.asarray(v) for k, v in jm.init_params(
            pb["jeng"].aln.obs_state_freqs).items()}
        p["il_sigma"] = np.asarray(np.log(0.1))
        pb.update(jm=jm, tm=tm, jp={k: jnp.asarray(v) for k, v in p.items()},
                  tp=params_from_numpy(p),
                  jeng=JEngine(pb["jeng"].aln, jm, dtype=jnp.float64,
                               use_pallas=False),
                  teng=TEngine(pb["teng"].aln, tm, dtype=torch.float64,
                               device="cpu"))
    jp, _, jl = jround(pb["jeng"], pb["jm"], pb["jp"], pb["jta"])
    tp, _, tl = tround(pb["teng"], pb["tm"], pb["tp"], pb["tta"])
    assert abs(tl - jl) < LNL_TOL, (tl, jl)
    for k, v in tp.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jp[k]), atol=1e-4,
                                   err_msg=k)


def _kernel_problem(kind, tmp_path, seed=5):
    """float32 engines at the model's system, phyml_tpu's with its
    Pallas kernels; the P-matrices, pi and log-weights phyml_tpu
    builds, given to both sides."""
    jm, tm = models(kind, tmp_path)
    rng = np.random.default_rng(seed)
    n_taxa = 8
    ns = jm.obs_ns
    enc = np.zeros((n_taxa, 150, ns), dtype=np.float32)
    enc[np.arange(n_taxa)[:, None], np.arange(150)[None],
        rng.integers(0, ns, size=(n_taxa, 150))] = 1.0
    from phyml_tpu.io.alignment import compact as jcompact
    from phyml_tpu_torch.io.alignment import compact as tcompact
    names = [f"t{i}" for i in range(n_taxa)]
    jaln = jcompact(enc, names, jm.datatype)
    taln = tcompact(enc, names, jm.datatype)
    p = random_params(jm, seed)
    p.update({k: np.asarray(v) for k, v in
              jm.init_params(jaln.obs_state_freqs).items()
              if k == "freqs_const"})
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jeng = JEngine(jaln, jm, dtype=jnp.float32, use_pallas=True)
    teng = TEngine(taln, tm, dtype=torch.float32, device="cpu")
    rv = Topology.random(n_taxa, rng, mean_blen=0.15).rooted()
    jta = jtree_arrays(rv, dtype=jnp.float32)
    sysv = jeng.system_of(jp)
    lam, V, Vinv, pi, w, pinv = sysv
    return dict(jm=jm, jp=jp, jeng=jeng, teng=teng, rv=rv, jta=jta,
                sys=sysv, pmats=jeng._pmats(lam, V, Vinv, jta.blen),
                logw=jnp.log(w), k=jaln.n_patterns, n=n_taxa, ns=ns,
                C=jm.n_classes, dt=jm.datatype)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("kind, name", [("lg4x", "K4"), ("dna_mix", "K1")])
def test_slot_kernels_plain_match_pallas_per_class(kind, name, tmp_path):
    """K4's plain version at LG4X and K1's at the DNA mixture against
    the Pallas slot kernels (streamed / resident)."""
    pb = _kernel_problem(kind, tmp_path)
    sched, _ = pallas_clv_slots.build_slot_schedule(pb["n"], pb["rv"].child)
    pi = pb["sys"][3]
    jargs = (jnp.asarray(sched), pb["jeng"].tips, pb["pmats"], pi,
             pb["logw"])
    kw = dict(n_otu=pb["n"], n_int=pb["n"] - 1, C=pb["C"], ns=pb["ns"],
              n_slots=pb["jeng"].slot_count, interpret=True)
    if name == "K4":
        want = pallas_clv_slots.uppass_site_lse_slots_stream(
            *jargs, T=STREAM_T, **kw)
        fn = clv_slots.uppass_site_lse_slots_stream
    else:
        want = pallas_clv_slots.uppass_site_lse_slots(
            *jargs, T=pb["jeng"].slot_tile, **kw)
        fn = clv_slots.uppass_site_lse_slots
    got = fn(torch.as_tensor(sched), pb["teng"].tips, _t(pb["pmats"]),
             _t(pi), _t(pb["logw"]), n_slots=pb["teng"].slot_count)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:pb["k"]],
                               atol=SITE_TOL[pb["dt"]])


def test_k3_plain_matches_pallas_over_a_lg4x_batch(tmp_path):
    """K3's plain version on a batch of three LG4X systems (the rates
    differ per row, as in the line search) against the dense Pallas
    kernel, one system at a time."""
    pb = _kernel_problem("lg4x", tmp_path)
    jeng, k, n = pb["jeng"], pb["k"], pb["n"]
    rng = np.random.default_rng(9)
    rows = []
    for b in range(3):
        jp = dict(pb["jp"])
        jp["class_rates_raw"] = jnp.asarray(rng.normal(0.0, 1.5, 4))
        lam, V, Vinv, pi, w, _ = jeng.system_of(jp)
        rows.append((jeng._pmats(lam, V, Vinv, pb["jta"].blen), pi,
                     jnp.log(w)))
    sched, n_slots = clv_slots.build_slot_schedule(n, pb["rv"].child)
    got = clv.uppass_site_lse(
        torch.as_tensor(pb["rv"].child), pb["teng"].tips,
        torch.stack([_t(r[0]) for r in rows]),
        torch.stack([_t(r[1]) for r in rows]),
        torch.stack([_t(r[2]) for r in rows]),
        sched=torch.as_tensor(sched), n_slots=n_slots)
    for b, (pm, pi, logw) in enumerate(rows):
        want = pallas_clv.uppass_site_lse(
            pb["jta"].child, jeng.tips, pm, pi, logw, n_otu=n,
            n_int=n - 1, C=4, ns=20, T=jeng.pallas_tile, interpret=True)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want)[:k],
                                   atol=SITE_TOL["aa"])


@pytest.mark.parametrize("kind, name", [("lg4x", "K5"), ("dna_mix", "K2")])
def test_edge_kernels_plain_match_pallas_per_class(kind, name, tmp_path):
    """K5's plain version at LG4X and K2's at the DNA mixture against
    the Pallas edge-dot-product kernels, through the per-edge site terms
    on the free edges."""
    pb = _kernel_problem(kind, tmp_path)
    jeng, teng, k, n = pb["jeng"], pb["teng"], pb["k"], pb["n"]
    lam, V, Vinv, pi, w, pinv = pb["sys"]
    kw = dict(n_otu=n, n_int=n - 1, C=pb["C"], ns=pb["ns"], interpret=True)
    if name == "K5":
        d_j, sc_j = pallas_edotp.edge_dotprods_pallas_stream(
            pb["jta"].child, jeng.tips, pb["pmats"], V, Vinv, pi,
            T=STREAM_T, **kw)
        fn = edotp.edge_dotprods_stream
    else:
        d_j, sc_j = pallas_edotp.edge_dotprods_pallas(
            pb["jta"].child, jeng.tips, pb["pmats"], V, Vinv, pi,
            T=jeng.pallas_tile, **kw)
        fn = edotp.edge_dotprods
    d_t, sc_t = fn(torch.as_tensor(pb["rv"].child), teng.tips,
                   _t(pb["pmats"]), _t(V), _t(Vinv), _t(pi))
    aux = dict(lam=_t(lam), w=_t(w), pinv=_t(pinv),
               weights=teng.weights, inv_lk=torch.zeros(k))
    blen = _t(pb["rv"].node_blen).float()
    site_j = teng.edge_site_terms(_t(d_j)[..., :k], _t(sc_j)[..., :k],
                                  aux, blen)[0]
    site_t = teng.edge_site_terms(d_t, sc_t, aux, blen)[0]
    free = np.ones(2 * n - 1, bool)
    free[-1] = False
    free[int(pb["rv"].child[-1, 1])] = False
    err = float((site_t[free] - site_j[free]).abs().max())
    assert err < SITE_TOL[pb["dt"]], err
