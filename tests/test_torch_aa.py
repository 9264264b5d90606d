"""The protein (20-state) slice of the port against phyml_tpu.

Kernels: the plain PyTorch versions of K1, K3, K4 and K5 at ns=20
against phyml_tpu's Pallas kernels in interpret mode (as
tests/test_pallas.py runs them), float32 on the CPU at 8 taxa and
<= 256 patterns, because the interpret mode unrolls the kernels'
loops.  K4 computes K1's function and K5 K2's, so their plain versions
are K1's and K2's; on CPU tensors the K4/K5 wrappers run them.  Both
sides get the same tips, P-matrices and eigensystem, built once by
phyml_tpu.  Tolerance 2e-3 per site, tests/test_pallas.py's AA
tolerance, for the site lnL and for the per-edge site terms (compared
through edge_site_terms on the free edges, because the two sides split
d and sc_d differently).

Engine and CLI: LG+G4 (and +I) in float64 against phyml_tpu under
x64: lnL, site lnL and per-edge Newton terms within 1e-6; P(t) within
1e-10 (never eigenvectors, whose signs and order differ); the CLI fit
within the tolerances of tests/test_torch_slice.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu import cli as jcli
from phyml_tpu.evolve import simulate_alignment, write_phylip
from phyml_tpu.io.alignment import compact as jcompact
from phyml_tpu.models.eigen import pmat as jpmat
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.ops import pallas_clv, pallas_clv_slots, pallas_edotp
from phyml_tpu.ops.likelihood import LikelihoodEngine as JEngine
from phyml_tpu.ops.likelihood import tree_arrays as jtree_arrays
from phyml_tpu.topology import Topology
from phyml_tpu_torch import cli as tcli
from phyml_tpu_torch import datatypes
from phyml_tpu_torch.interop import params_from_numpy, tree_arrays_from_numpy
from phyml_tpu_torch.io.alignment import compact as tcompact
from phyml_tpu_torch.models.eigen import pmat as tpmat
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.ops import clv, clv_slots, edotp
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine
from phyml_tpu_torch.ops.likelihood import kernel_route

AA_TOL = 2e-3       # per-site, float32 kernels (tests/test_pallas.py)
LNL_TOL = 1e-6      # float64 engines
PMAT_TOL = 1e-10
CLI_LNL_TOL = 1e-3  # tests/test_torch_slice.py
CLI_REL_TOL = 1e-2
STREAM_T = 128      # the streamed Pallas kernels' pattern tile


def _kernel_problem(datatype="aa", n_taxa=8, n_sites=150, seed=0):
    """Random alignment (some gaps), a random tree and LG+G4 (GTR+G4
    for DNA) on both sides; float32 engines, phyml_tpu's with its
    Pallas kernels."""
    rng = np.random.default_rng(seed)
    ns = 20 if datatype == "aa" else 4
    enc = np.zeros((n_taxa, n_sites, ns), dtype=np.float32)
    enc[np.arange(n_taxa)[:, None], np.arange(n_sites)[None],
        rng.integers(0, ns, size=(n_taxa, n_sites))] = 1.0
    enc[rng.random((n_taxa, n_sites)) < 0.03] = 1.0   # gaps
    names = [f"t{i}" for i in range(n_taxa)]
    jaln = jcompact(enc, names, datatype)
    taln = tcompact(enc, names, datatype)
    name = "LG" if datatype == "aa" else "GTR"
    jm = JModel(datatype=datatype, name=name, n_classes=4)
    tm = TModel(datatype=datatype, name=name, n_classes=4)
    jp = jm.init_params(jaln.obs_state_freqs)
    jp["alpha"] = jnp.asarray(0.6)
    jeng = JEngine(jaln, jm, dtype=jnp.float32, use_pallas=True)
    teng = TEngine(taln, tm, dtype=torch.float32, device="cpu")
    rv = Topology.random(n_taxa, rng, mean_blen=0.15).rooted()
    jta = jtree_arrays(rv, dtype=jnp.float32)
    sysv = jeng.system_of(jp)
    lam, V, Vinv, pi, w, pinv = sysv
    return dict(jeng=jeng, teng=teng, rv=rv, jta=jta, sys=sysv,
                pmats=jeng._pmats(lam, V, Vinv, jta.blen),
                logw=jnp.log(w), k=jaln.n_patterns, n=n_taxa, ns=ns)


def _t(x):
    return torch.as_tensor(np.array(x))


def _slot_args(pb):
    sched, _ = pallas_clv_slots.build_slot_schedule(pb["n"],
                                                    pb["rv"].child)
    pi = pb["sys"][3]
    jargs = (jnp.asarray(sched), pb["jeng"].tips, pb["pmats"], pi,
             pb["logw"])
    targs = (torch.as_tensor(sched), pb["teng"].tips, _t(pb["pmats"]),
             _t(pi), _t(pb["logw"]))
    kw = dict(n_otu=pb["n"], n_int=pb["n"] - 1, C=4, ns=pb["ns"],
              n_slots=pb["jeng"].slot_count, interpret=True)
    return jargs, targs, kw


@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_k4_plain_matches_pallas_stream(datatype):
    """K4's plain version (K1's) against the streamed Pallas slot
    kernel, at 4 and 20 states."""
    pb = _kernel_problem(datatype, seed=1)
    jargs, targs, kw = _slot_args(pb)
    want = pallas_clv_slots.uppass_site_lse_slots_stream(
        *jargs, T=STREAM_T, **kw)
    got = clv_slots.uppass_site_lse_slots_stream(
        *targs, n_slots=pb["teng"].slot_count)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:pb["k"]],
                               atol=AA_TOL)


def test_k1_plain_matches_pallas_at_20_states():
    pb = _kernel_problem(seed=2)
    assert pb["jeng"].slot_tile >= 128
    jargs, targs, kw = _slot_args(pb)
    want = pallas_clv_slots.uppass_site_lse_slots(
        *jargs, T=pb["jeng"].slot_tile, **kw)
    got = clv_slots.uppass_site_lse_slots(*targs,
                                          n_slots=pb["teng"].slot_count)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:pb["k"]],
                               atol=AA_TOL)


def test_k3_plain_matches_pallas_at_20_states():
    pb = _kernel_problem(seed=3)
    jeng, k = pb["jeng"], pb["k"]
    assert jeng.pallas_tile >= 128
    _, _, _, pi, _, _ = pb["sys"]
    want = pallas_clv.uppass_site_lse(
        pb["jta"].child, jeng.tips, pb["pmats"], pi, pb["logw"],
        n_otu=pb["n"], n_int=pb["n"] - 1, C=4, ns=20,
        T=jeng.pallas_tile, interpret=True)
    sched, n_slots = clv_slots.build_slot_schedule(pb["n"], pb["rv"].child)
    got = clv.uppass_site_lse(
        torch.as_tensor(pb["rv"].child), pb["teng"].tips,
        _t(pb["pmats"]), _t(pi), _t(pb["logw"]),
        sched=torch.as_tensor(sched), n_slots=n_slots)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:k],
                               atol=AA_TOL)


@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_k5_plain_matches_pallas_stream(datatype):
    """K5's plain version (K2's) against the streamed Pallas
    edge-dot-product kernel, compared through the per-edge site
    terms on the free edges."""
    pb = _kernel_problem(datatype, seed=4)
    jeng, teng, k = pb["jeng"], pb["teng"], pb["k"]
    lam, V, Vinv, pi, w, pinv = pb["sys"]
    d_j, sc_j = pallas_edotp.edge_dotprods_pallas_stream(
        pb["jta"].child, jeng.tips, pb["pmats"], V, Vinv, pi,
        n_otu=pb["n"], n_int=pb["n"] - 1, C=4, ns=pb["ns"], T=STREAM_T,
        interpret=True)
    d_t, sc_t = edotp.edge_dotprods_stream(
        torch.as_tensor(pb["rv"].child), teng.tips, _t(pb["pmats"]),
        _t(V), _t(Vinv), _t(pi))
    # one eigensystem (phyml_tpu's) for both sides' site terms
    aux = dict(lam=_t(lam), w=_t(w), pinv=_t(pinv),
               weights=teng.weights, inv_lk=torch.zeros(k))
    blen = _t(pb["rv"].node_blen).float()
    site_j = teng.edge_site_terms(_t(d_j)[..., :k], _t(sc_j)[..., :k],
                                  aux, blen)[0]
    site_t = teng.edge_site_terms(d_t, sc_t, aux, blen)[0]
    free = np.ones(2 * pb["n"] - 1, bool)
    free[-1] = False
    free[int(pb["rv"].child[-1, 1])] = False
    err = (site_t[free] - site_j[free]).abs().max()
    assert float(err) < AA_TOL, float(err)


@pytest.mark.parametrize("n_otu,C,ns,route", [
    (128, 4, 4, ("K1", "K2")),     # the DNA bench problem: 23.9 KiB a warp
    (200, 4, 4, ("K1", "K2")),     # 33.5 KiB
    (15, 4, 20, ("K4", "K5")),     # 71.9 KiB, over 48 KiB
    (16, 4, 20, ("K4", "K5")),     # 75 KiB
    (128, 4, 20, ("K4", "K5")),    # the AA bench problem: 433 KiB
    (128, 1, 20, ("K4", "K5")),
    (8, 4, 20, ("K1", "K2")),      # 47.4 KiB, under 48 KiB
    (256, 4, 4, ("K1", "K2")),     # 40.5 KiB
    (312, 4, 4, ("K4", "K5")),     # 48.1 KiB
    (192, 8, 4, ("K4", "K5")),     # 32.5 KiB a warp, 261 KiB a block of 8
    (300, 4, 4, ("K1", "K2")),     # 46.6 KiB
])
def test_kernel_route(n_otu, C, ns, route):
    """One rule in the card's terms: the streamed pair once K1's shared
    memory per warp (its class's P-matrices of the whole tree, the tip
    ring and the slots, at the worst-case slot count) passes 48 KiB, or
    its block of C warps passes a block's 227 KB."""
    assert kernel_route(n_otu, C, ns) == route


@pytest.mark.parametrize("datatype,alphabet", [
    ("aa", datatypes.AA_STATES + "XBZ-"),
    ("nt", "ACGTNRY-"),
])
def test_empirical_freqs_match_phyml_tpu(datatype, alphabet):
    """The EM frequency estimate, grouped by compatibility row, against
    phyml_tpu's per-cell iteration, on sequences with gaps and
    ambiguity codes; 1e-12 absolute (float64, summation order)."""
    from phyml_tpu.io.alignment import empirical_freqs as jfreqs
    from phyml_tpu_torch.io.alignment import empirical_freqs as tfreqs

    rng = np.random.default_rng(17)
    seqs = ["".join(rng.choice(list(alphabet), size=300)) for _ in range(9)]
    enc = datatypes.encode_sequences(seqs, datatype)
    names = [f"t{i}" for i in range(9)]
    want = jfreqs(jcompact(enc, names, datatype))
    got = tfreqs(tcompact(enc, names, datatype))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_every_state_count_has_a_width_and_a_refusal_names_its_shape():
    """Past the kernels' ladder (more than 32 states) no state count is
    unbuilt: `rung` pads it to a multiple of 16, the big bodies' panel
    (80 stays 80, 65 goes to 80, 60 to 64).  The one refusal left, the
    launcher's 'unsupported' code, names the shape it was given."""
    from phyml_tpu_torch.ops import _build

    assert _build.rung(80) == 80 and _build.is_big(80)
    assert _build.rung(65) == 80 and _build.rung(161) == 176
    assert _build.rung(64) == 64 and _build.is_big(64)
    assert _build.rung(60) == 64 and _build.rung(33) == 48
    assert _build.rung(32) == 32 and not _build.is_big(32)
    with pytest.raises(NotImplementedError, match="rate classes"):
        _build.check(-1, "edge_dotprods", 20)
    with pytest.raises(NotImplementedError,
                       match=r"ns=1024, C=4, block_smem_bytes=500000\)"):
        _build.check(-1, "uppass_site_lse", 1024, C=4,
                     block_smem_bytes=500000)
    _build.check(0, "edge_dotprods", 20)


@pytest.mark.parametrize("datatype,route", [("nt", ("K1", "K2")),
                                            ("aa", ("K4", "K5"))])
def test_engine_records_its_route(datatype, route):
    """An engine at the bench width (128 taxa, C=4) records the route
    it takes; on the CPU both routes run the same plain versions."""
    pb = _engine_problem(datatype, n_taxa=128, n_sites=40)
    teng = pb["teng"]
    assert (teng.lnl_route, teng.edotp_route) == route
    assert abs(float(teng.loglik(pb["tp"], pb["tta"]))
               - float(pb["jeng"].loglik(pb["jp"], pb["jta"]))) < LNL_TOL


def _engine_problem(datatype="aa", invar=False, n_taxa=10, n_sites=150,
                    seed=0):
    """Simulated alignment; float64 engines on both sides (phyml_tpu on
    its scan path) with identical parameters and tree."""
    rng = np.random.default_rng(seed)
    topo = Topology.random(n_taxa, rng, mean_blen=0.12)
    name = "LG" if datatype == "aa" else "GTR"
    kw = dict(datatype=datatype, name=name, n_classes=4, invar=invar)
    jm, tm = JModel(**kw), TModel(**kw)
    sim_p = jm.init_params(np.full(jm.ns, 1.0 / jm.ns))
    sim_p["alpha"] = jnp.asarray(0.9)
    names, seqs = simulate_alignment(topo, jm, sim_p, n_sites, rng)
    enc = datatypes.encode_sequences(seqs, datatype)
    jaln = jcompact(enc, names, datatype)
    taln = tcompact(enc, names, datatype)
    jp = jm.init_params(jaln.obs_state_freqs)
    jp["alpha"] = jnp.asarray(0.55)
    if invar:
        jp["pinv"] = jnp.asarray(0.17)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    jeng = JEngine(jaln, jm, dtype=jnp.float64, use_pallas=False)
    teng = TEngine(taln, tm, dtype=torch.float64, device="cpu")
    jta = jtree_arrays(topo.rooted(), dtype=jnp.float64)
    tta = tree_arrays_from_numpy(np.asarray(jta.child),
                                 np.asarray(jta.blen), device="cpu",
                                 dtype=torch.float64)
    return dict(jeng=jeng, jp=jp, jta=jta, teng=teng, tp=tp, tta=tta,
                k=jaln.n_patterns)


@pytest.mark.parametrize("invar", [False, True], ids=["LG+G4", "LG+G4+I"])
def test_aa_engine_matches_phyml_tpu(invar):
    """lnL, site lnL (host K1/K4 route, K3 route, scan path) and the
    per-edge Newton terms (K2/K5 route) in float64."""
    pb = _engine_problem(invar=invar, seed=5 + invar)
    jeng, jp, jta, teng, tp, tta, k = (pb[x] for x in (
        "jeng", "jp", "jta", "teng", "tp", "tta", "k"))
    want_site = np.asarray(jeng.site_logliks(jp, jta))[:k]
    want = float(jeng.loglik(jp, jta))
    np.testing.assert_allclose(teng.site_logliks(tp, tta).numpy(),
                               want_site, rtol=0, atol=LNL_TOL)
    assert abs(float(teng.loglik(tp, tta)) - want) < LNL_TOL
    sysv = teng.system_of(tp)
    assert abs(float(teng._loglik_sys(sysv, tta)) - want) < LNL_TOL
    np.testing.assert_allclose(teng.site_logliks_scan(sysv, tta).numpy(),
                               want_site, rtol=0, atol=LNL_TOL)

    d, sc, aux = jeng.edge_dotprods(jp, jta, jeng.weights)
    want_terms = [np.asarray(x) for x in
                  jeng.edge_lnl_terms(d, sc, aux, jta.blen)]
    free = np.ones(teng.n_nodes, bool)
    free[-1] = False
    free[int(tta.child[-1, 1])] = False
    d_t, sc_t, aux_t = teng.edge_dotprods_sys(sysv, tta)
    got = teng.edge_lnl_terms(d_t, sc_t, aux_t, tta.blen)
    for g, w in zip(got, want_terms):
        np.testing.assert_allclose(g.numpy()[free], w[free], rtol=1e-7,
                                   atol=LNL_TOL)


@pytest.mark.parametrize("kw", [
    dict(name="LG", n_classes=4),
    dict(name="LG", n_classes=4, invar=True),
    dict(name="WAG", n_classes=4, freqs_mode="model"),
    dict(name="JTT", n_classes=1, freqs_mode="model", invar=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_aa_class_system_pmats(kw):
    """P(t), frequencies and class weights of the empirical AA models
    (LG, WAG, JTT; empirical or the model's frequencies; +G4, +I)."""
    jm, tm = JModel(datatype="aa", **kw), TModel(datatype="aa", **kw)
    freqs = np.random.default_rng(7).dirichlet(np.full(20, 5.0))
    jp = jm.init_params(freqs)
    if "alpha" in jp:
        jp["alpha"] = jnp.asarray(0.43)
    if "pinv" in jp:
        jp["pinv"] = jnp.asarray(0.31)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    jlam, jV, jVi, jpi, jw, jpinv = jm.class_system(jp)
    tlam, tV, tVi, tpi, tw, tpinv = tm.class_system(tp)
    t = np.array([1e-6, 0.01, 0.1, 0.5, 2.0, 10.0])[:, None] \
        * np.ones((1, jm.n_classes))
    np.testing.assert_allclose(
        tpmat(tlam, tV, tVi, torch.as_tensor(t)).numpy(),
        np.asarray(jpmat(jlam, jV, jVi, jnp.asarray(t))), rtol=0,
        atol=PMAT_TOL)
    np.testing.assert_allclose(tpi.numpy(), np.asarray(jpi), atol=PMAT_TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=PMAT_TOL)
    assert abs(float(tpinv) - float(jpinv)) <= PMAT_TOL


def _stats(aln_path):
    text = open(f"{aln_path}_phyml_stats.txt").read()
    out = {"lnl": float(re.search(r"Log-likelihood:\s+(\S+)", text)[1]),
           "model": re.search(r"substitution:\s+(\S+)", text)[1],
           "freqs": [float(x) for x in re.findall(r"f\(\w+\)=\s*(\S+)",
                                                   text)]}
    for key, pat in (("alpha", r"Gamma shape parameter:\s+(\S+)"),
                     ("pinv", r"Proportion of invariant:\s+(\S+)")):
        m = re.search(pat, text)
        if m:
            out[key] = float(m[1])
    return out


@pytest.mark.parametrize("flags", [
    ["-m", "LG", "-a", "e"],
    ["-m", "LG", "-a", "e", "-v", "e", "-f", "m"],
], ids=["LG+G4", "LG+G4+I-model-freqs"])
def test_aa_cli_fit_matches_phyml_tpu(tmp_path, flags):
    """`-d aa -c 4 -o lr -b 0 -u tree` through both CLIs on the same
    simulated 12-taxon protein alignment, float64 on the CPU."""
    rng = np.random.default_rng(13)
    topo = Topology.random(12, rng, mean_blen=0.15)
    model = JModel(datatype="aa", name="LG", n_classes=4,
                   freqs_mode="model")
    p = model.init_params()
    p["alpha"] = jnp.asarray(0.9)
    names, seqs = simulate_alignment(topo, model, p, 200, rng)
    newick = topo.to_newick(names)

    runs = {}
    for tag, main in (("jax", jcli.main), ("torch", tcli.main)):
        d = tmp_path / tag
        d.mkdir()
        aln, tree = str(d / "aln.phy"), d / "tree.nwk"
        write_phylip(aln, names, seqs)
        tree.write_text(newick + "\n")
        argv = ["-i", aln, "-u", str(tree), "-d", "aa", "-c", "4",
                *flags, "-o", "lr", "-b", "0", "--platform", "cpu",
                "--r_seed", "1", "--quiet"]
        assert main(argv) == 0
        from phyml_tpu_torch.topology import Topology as TTopology
        blen = TTopology.from_newick(
            open(f"{aln}_phyml_tree.txt").read(), names).blen
        runs[tag] = (_stats(aln), blen)

    (sj, bj), (st, bt) = runs["jax"], runs["torch"]
    assert st["model"] == sj["model"] == "LG"
    assert abs(st["lnl"] - sj["lnl"]) < CLI_LNL_TOL, (st["lnl"], sj["lnl"])
    np.testing.assert_allclose(st["alpha"], sj["alpha"], rtol=CLI_REL_TOL)
    if "pinv" in sj:
        assert abs(st["pinv"] - sj["pinv"]) < CLI_REL_TOL
    assert len(st["freqs"]) == 20
    np.testing.assert_allclose(st["freqs"], sj["freqs"], atol=1e-6)
    np.testing.assert_allclose(bt, bj, rtol=CLI_REL_TOL, atol=1e-4)
