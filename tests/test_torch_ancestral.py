"""Ancestral states and mutation maps of the port against phyml_tpu, on
the CPU.

The simulated alignments of tests/test_torch_bionj.py (12 taxa, 200
sites) and tests/test_torch_mixture.py go through both packages'
float64 engines on the same tree:

* `marginal_posteriors` (the root row included) within 1e-8 (POST_TOL)
  under GTR+G4+I, LG+G4, a two-class DNA mixture (each class its own
  frequencies, so the root row's pi is per class) and DNA covarion with
  two hidden classes;
* `mpee_decode` and `mask_to_char`: the same masks and characters;
* `m4_class_posteriors` within 1e-8, and `write_m4_decode`'s numbers
  within 1e-4 (its four decimals) with the same MAP classes;
* `write_ancestral`: the same tree text, the numbers within 1e-6, the
  same MPEE column;
* `sample_ancestral`'s log-weights at each step (the class, the root
  state, every child's state given its parent's), given the same
  classes and parent states, within 1e-8 of the same quantities from
  phyml_tpu's engine wherever their probability passes 1e-12, and the
  normalized probabilities everywhere within 1e-8; over 2,000 draws the site-state frequencies at
  every internal node within 0.05 of the marginals (as
  tests/test_ancestral.py:77 holds phyml_tpu's draws);
* `map_mutations`: from the same classes, states and numpy seed, the
  same event list (times within 1e-9);
* `--ancestral` and `--mutmap` through both CLIs on the same files
  (`-u tree -o lr`): the same ancestral tree, posteriors within 1e-5
  (the fits stop on tolerance) and the same MPEE calls; the mutation
  map's format, and its events replay to the port's own draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu import cli as jcli
from phyml_tpu.evolve import write_phylip
from phyml_tpu.io.alignment import read_alignment as jread
from phyml_tpu.io.output import write_ancestral as jwrite_ancestral
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.ops import ancestral as janc
from phyml_tpu.ops.likelihood import LikelihoodEngine as JEngine
from phyml_tpu.ops.likelihood import tree_arrays as jtree_arrays
from phyml_tpu_torch import cli as tcli
from phyml_tpu_torch.interop import params_from_numpy, tree_arrays_from_numpy
from phyml_tpu_torch.io.alignment import read_alignment as tread
from phyml_tpu_torch.io.output import write_ancestral as twrite_ancestral
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.ops import ancestral as tanc
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine
from phyml_tpu_torch.topology import Topology as TTopology
from test_torch_bionj import _engines, _simulate
from test_torch_mixture import _problem as mixture_problem

POST_TOL = 1e-8
LOGW_TOL = 1e-8
FILE_TOL = 1e-6
CLI_TOL = 1e-5
FREQ_TOL = 0.05
N_DRAWS = 2000
KINDS = ["gtr_g4_i", "lg_g4", "dna_mix", "covarion"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """As in tests/test_torch_bionj.py: one torch thread for the scan
    path's many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _covarion(tmp_path, n_taxa=12, n_sites=200):
    """DNA covarion (GTR+G4, two hidden classes, cov_delta 0.6) on the
    simulated GTR alignment, its simulating tree."""
    names, seqs, topo = _simulate("nt", n_taxa=n_taxa, n_sites=n_sites)
    path = str(tmp_path / "cov.phy")
    write_phylip(path, names, seqs)
    jaln, taln = jread(path, datatype="nt"), tread(path, datatype="nt")
    kw = dict(datatype="nt", name="GTR", n_classes=4, covarion=True,
              n_hidden=2)
    jm, tm = JModel(**kw), TModel(**kw)
    jp = jm.init_params(jaln.obs_state_freqs)
    jp["cov_delta"] = jnp.asarray(0.6)
    jeng = JEngine(jaln, jm, dtype=jnp.float64, use_pallas=False)
    teng = TEngine(taln, tm, dtype=torch.float64, device="cpu")
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    return jeng, jp, teng, tp, topo


def problem(kind, tmp_path):
    """{jeng, jp, jta, teng, tp, tta, rv}: both packages' float64
    engines, parameters and the same rooted tree."""
    if kind == "dna_mix":
        pb = mixture_problem("dna_mix", tmp_path)
        ch = np.asarray(pb["jta"].child)
        bl = np.asarray(pb["jta"].blen)
        return dict(jeng=pb["jeng"], jp=pb["jp"], jta=pb["jta"],
                    teng=pb["teng"], tp=pb["tp"], tta=pb["tta"],
                    child=ch, blen=bl)
    if kind == "covarion":
        jeng, jp, teng, tp, topo = _covarion(tmp_path)
    else:
        dt = "nt" if kind == "gtr_g4_i" else "aa"
        jeng, jp, teng, tp, topo = _engines(dt, tmp_path,
                                            invar=kind == "gtr_g4_i")
    rv = topo.rooted()
    return dict(jeng=jeng, jp=jp, teng=teng, tp=tp, rv=rv, topo=topo,
                jta=jtree_arrays(rv, dtype=jnp.float64),
                tta=tree_arrays_from_numpy(rv.child, rv.node_blen,
                                           device="cpu",
                                           dtype=torch.float64),
                child=np.asarray(rv.child), blen=np.asarray(rv.node_blen))


@pytest.mark.parametrize("kind", KINDS)
def test_marginal_posteriors_match_phyml_tpu(kind, tmp_path):
    pb = problem(kind, tmp_path)
    P = pb["teng"].P
    want = np.asarray(janc.marginal_posteriors(
        pb["jeng"], pb["jp"], pb["jta"], include_root=True))[:, :P]
    got = tanc.marginal_posteriors(pb["teng"], pb["tp"], pb["tta"],
                                   include_root=True)
    assert got.dtype == torch.float64
    assert got.shape == (pb["teng"].n_internal, P, pb["teng"].ns)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=POST_TOL)
    np.testing.assert_allclose(got.numpy().sum(-1), 1.0, atol=1e-8)
    assert tanc.marginal_posteriors(pb["teng"], pb["tp"],
                                    pb["tta"]).shape[0] == \
        pb["teng"].n_internal - 1


@pytest.mark.parametrize("kind", ["gtr_g4_i", "lg_g4"])
def test_mpee_and_characters_match_phyml_tpu(kind, tmp_path):
    pb = problem(kind, tmp_path)
    probs = tanc.marginal_posteriors(pb["teng"], pb["tp"], pb["tta"])
    rng = np.random.default_rng(3)
    ns = probs.shape[-1]
    flat = rng.dirichlet(np.full(ns, 0.3), size=500)
    for x in (probs, flat, np.full(ns, 1.0 / ns)):
        want = janc.mpee_decode(np.asarray(x))
        np.testing.assert_array_equal(tanc.mpee_decode(x), want)
    dt = "nt" if ns == 4 else "aa"
    masks = range(16) if dt == "nt" else \
        [1 << k for k in range(20)] + [3, 5, 0xFFFFF]
    for m in masks:
        assert tanc.mask_to_char(m, dt) == janc.mask_to_char(m, dt)


def test_m4_class_posteriors_match_phyml_tpu(tmp_path):
    pb = problem("covarion", tmp_path)
    P = pb["teng"].P
    want = janc.m4_class_posteriors(pb["jeng"], pb["jp"], pb["jta"])
    got = tanc.m4_class_posteriors(pb["teng"], pb["tp"], pb["tta"])
    np.testing.assert_allclose(got, np.asarray(want)[:, :P], rtol=0,
                               atol=POST_TOL)
    files = {}
    for tag, mod, e, p, t in (("jax", janc, pb["jeng"], pb["jp"], pb["jta"]),
                              ("torch", tanc, pb["teng"], pb["tp"],
                               pb["tta"])):
        path = tmp_path / f"{tag}_m4.txt"
        mod.write_m4_decode(str(path), e, p, t)
        files[tag] = path.read_text().splitlines()
    assert files["jax"][:2] == files["torch"][:2]
    j = np.array([[float(x) for x in ln.split("\t")] for ln in
                  files["jax"][2:]])
    t = np.array([[float(x) for x in ln.split("\t")] for ln in
                  files["torch"][2:]])
    np.testing.assert_array_equal(t[:, :2], j[:, :2])
    np.testing.assert_allclose(t[:, 2:], j[:, 2:], rtol=0, atol=1.01e-4)


def _read_table(path):
    """(header lines, [(site, node, numbers, MPEE)]) of an ancestral
    sequence file."""
    lines = path.read_text().splitlines()
    k = next(i for i, ln in enumerate(lines) if ln.startswith("Site"))
    rows = []
    for ln in lines[k + 1:]:
        f = ln.split("\t")
        rows.append((int(f[0]), int(f[1]), [float(x) for x in f[2:-1]],
                     f[-1]))
    return lines[:k + 1], rows


@pytest.mark.parametrize("kind", ["gtr_g4_i", "lg_g4"])
def test_write_ancestral_matches_phyml_tpu(kind, tmp_path):
    pb = problem(kind, tmp_path)
    jprobs = janc.marginal_posteriors(pb["jeng"], pb["jp"], pb["jta"])
    tprobs = tanc.marginal_posteriors(pb["teng"], pb["tp"], pb["tta"])
    dt = "nt" if kind == "gtr_g4_i" else "aa"
    topo, rv = pb["topo"], pb["rv"]
    ttopo = TTopology(topo.n_otu, topo.edges, topo.blen)
    out = {}
    for tag, write, tp_, rv_, probs, aln in (
            ("jax", jwrite_ancestral, topo, rv, jprobs, pb["jeng"].aln),
            ("torch", twrite_ancestral, ttopo, ttopo.rooted(), tprobs,
             pb["teng"].aln)):
        seq, tree = write(str(tmp_path / tag), aln, tp_, rv_, probs, dt)
        out[tag] = (open(tree).read(), _read_table(tmp_path / seq))
    assert out["torch"][0] == out["jax"][0]
    (jh, jrows), (th, trows) = out["jax"][1], out["torch"][1]
    assert [ln.replace("jax", "torch") for ln in jh] == th
    assert len(jrows) == len(trows) == (topo.n_otu - 2) * \
        pb["teng"].aln.n_sites
    for a, b in zip(jrows, trows):
        assert a[:2] == b[:2] and a[3] == b[3]
        np.testing.assert_allclose(b[2], a[2], rtol=0, atol=FILE_TOL)


def _jax_logits(pb, cls, states):
    """phyml_tpu's sampling log-weights (the expressions of
    phyml_tpu/ops/ancestral.py:_sample) on its own engine's passes:
    the class logits [C, P], the root's [P, ns] given cls, and every
    child's [P, ns] given cls and its parent's state in `states`
    (phyml_tpu's pattern axis is padded: the pad carries class and
    state 0, and is cut from the results)."""
    eng, params, tree = pb["jeng"], pb["jp"], pb["jta"]
    P = cls.shape[0]
    cls = np.pad(cls, (0, eng.P - P))
    states = np.pad(states, ((0, 0), (0, eng.P - P)))
    lam, V, Vinv, pi, w, pinv = eng._system(params)
    pmats = eng._pmats(lam, V, Vinv, tree.blen)
    pup, clv, sc = eng._up_pass(pmats, tree.child)
    root = eng.n_nodes - 1
    prec = jax.lax.Precision.HIGHEST
    lroot = jnp.einsum("cx,cxp->cp", pi, pup[root], precision=prec)
    cls_logits = jnp.log(w)[:, None] + sc[root] + \
        jnp.log(jnp.maximum(lroot, eng._tiny))
    cls = jnp.asarray(cls)
    sel = lambda x: jnp.take_along_axis(x, cls[None, None, :], axis=0)[0]
    root_w = pi.T[:, cls] * sel(clv[root])
    out = {"class": np.asarray(cls_logits)[:, :P],
           root: np.asarray(jnp.log(jnp.maximum(root_w, eng._tiny)).T)[:P]}
    for i in range(eng.n_internal):
        sw = jnp.asarray(states[eng.n_otu + i])
        for c in np.asarray(tree.child)[i]:
            pm_cls = pmats[int(c)][cls]
            row = jnp.take_along_axis(pm_cls, sw[:, None, None],
                                      axis=1)[:, 0, :]
            cl = jnp.take_along_axis(clv[int(c)], cls[None, None, :],
                                     axis=0)[0]
            out[int(c)] = np.asarray(
                jnp.log(jnp.maximum(row * cl.T, eng._tiny)))[:P]
    return out


@pytest.mark.parametrize("kind", ["gtr_g4_i", "dna_mix"])
def test_sampling_log_weights_match_phyml_tpu(kind, tmp_path):
    pb = problem(kind, tmp_path)
    eng = pb["teng"]
    gen = torch.Generator().manual_seed(11)
    cls, states = tanc.sample_ancestral(eng, pb["tp"], pb["tta"], gen)
    assert cls.shape == (eng.P,) and states.shape == (eng.n_nodes, eng.P)
    want = _jax_logits(pb, cls.numpy().astype(np.int32),
                       states.numpy().astype(np.int32))
    sys_, pmats, pup, clv, sc = tanc._inside(eng, pb["tp"], pb["tta"])
    pi, w = sys_[3], sys_[4]
    root = eng.n_nodes - 1
    cl = cls.long()
    got = {"class": tanc.class_logits(eng, pi, w, pup[root], sc[root]),
           root: tanc.root_logits(eng, pi, clv[root], cl)}
    st = states.long()
    for i, row in enumerate(pb["child"]):
        for c in row:
            got[int(c)] = tanc.child_logits(eng, pmats[int(c)], clv[int(c)],
                                            cl, st[eng.n_otu + i])
    assert set(got) == set(want)
    for k in want:
        g, j = got[k].numpy(), want[k]
        axis = 0 if k == "class" else -1
        # the normalized draw probabilities everywhere; the log-weights
        # where their probability passes 1e-12 (below it they are the
        # roundoff of a zero-length edge's P(0) off its diagonal, 1e-20
        # in one package and the 1e-100 floor in the other)
        pg = np.exp(g - g.max(axis, keepdims=True))
        pj = np.exp(j - j.max(axis, keepdims=True))
        pg, pj = (x / x.sum(axis, keepdims=True) for x in (pg, pj))
        np.testing.assert_allclose(pg, pj, rtol=0, atol=LOGW_TOL,
                                   err_msg=str(k))
        live = pj > 1e-12
        np.testing.assert_allclose(g[live], j[live], rtol=0, atol=LOGW_TOL,
                                   err_msg=str(k))


def test_sample_frequencies_follow_the_marginals(tmp_path):
    """2,000 joint draws on an 8-taxon, 60-site GTR+G4 problem: at every
    internal node and pattern, the frequency of each state within
    FREQ_TOL of its marginal posterior; the tips keep their data."""
    names, seqs, topo = _simulate("nt", n_taxa=8, n_sites=60)
    path = str(tmp_path / "small.phy")
    write_phylip(path, names, seqs)
    aln = tread(path, datatype="nt")
    model = TModel(datatype="nt", name="GTR", n_classes=4)
    params = model.init_params(aln.obs_state_freqs)
    params["alpha"] = torch.tensor(0.7, dtype=torch.float64)
    eng = TEngine(aln, model, dtype=torch.float64, device="cpu")
    rv = topo.rooted()
    ta = tree_arrays_from_numpy(rv.child, rv.node_blen, device="cpu",
                                dtype=torch.float64)
    probs = tanc.marginal_posteriors(eng, params, ta,
                                     include_root=True).numpy()
    gen = torch.Generator().manual_seed(5)
    counts = np.zeros((eng.n_internal, eng.P, 4))
    tips = aln.partials.argmax(-1)
    for _ in range(N_DRAWS):
        _, states = tanc.sample_ancestral(eng, params, ta, gen)
        s = states.numpy()
        idx = s[eng.n_otu:]
        for k in range(4):
            counts[..., k] += idx == k
        unamb = aln.partials.sum(-1) == 1
        assert (s[:eng.n_otu][unamb] == tips[unamb]).all()
    gap = np.abs(counts / N_DRAWS - probs).max()
    assert gap <= FREQ_TOL, gap


@pytest.mark.parametrize("kind", ["gtr_g4_i", "dna_mix"])
def test_map_mutations_matches_phyml_tpu(kind, tmp_path):
    pb = problem(kind, tmp_path)
    gen = torch.Generator().manual_seed(3)
    cls, states = tanc.sample_ancestral(pb["teng"], pb["tp"], pb["tta"], gen)
    sites = np.arange(min(40, pb["teng"].P))
    ev_t = tanc.map_mutations(pb["teng"], pb["tp"], pb["tta"], cls, states,
                              np.random.default_rng(9), sites=sites)
    ev_j = janc.map_mutations(pb["jeng"], pb["jp"], pb["jta"],
                              cls.numpy(), states.numpy(),
                              np.random.default_rng(9), sites=sites)
    assert len(ev_t) == len(ev_j) > 0
    for a, b in zip(ev_t, ev_j):
        assert (a[0], a[1], a[3], a[4]) == (b[0], b[1], b[3], b[4])
        assert abs(a[2] - b[2]) <= 1e-9
    _replay(ev_t, states.numpy(), pb["child"], pb["blen"],
            pb["teng"].n_otu, sites)


def _replay(events, states, child, blen, n_otu, sites, t_tol=1e-12):
    """Each (node, site)'s events, in time order, lead from its parent's
    state to its own (tests/test_ancestral.py:90); edges of length 0
    carry none."""
    parent = {}
    for i, (c0, c1) in enumerate(child):
        parent[int(c0)] = parent[int(c1)] = n_otu + i
    by = {}
    for (u, p, t, s_from, s_to) in events:
        assert 0.0 < t <= blen[u] * (1 + t_tol) + 1e-12
        by.setdefault((u, p), []).append((t, s_from, s_to))
    for u in parent:
        if blen[u] <= 0:
            continue
        for p in sites:
            s = int(states[parent[u], p])
            for (t, s_from, s_to) in sorted(by.get((u, p), [])):
                assert s_from == s
                s = s_to
            assert s == int(states[u, p])


def test_cli_ancestral_and_mutmap_match_phyml_tpu(tmp_path, monkeypatch):
    """`-u tree -o lr --ancestral --mutmap` through both CLIs on the same
    files: the same ancestral tree, the posteriors within CLI_TOL, the
    same MPEE calls; both write a mutation map in one format, and the
    port's events replay to its own draw from the run's seed."""
    names, seqs, topo = _simulate("nt", n_taxa=10, n_sites=120)
    draws = []
    real = tanc.sample_ancestral
    monkeypatch.setattr(tanc, "sample_ancestral",
                        lambda *a, **k: draws.append(real(*a, **k))
                        or draws[-1])
    out = {}
    for tag, main in (("jax", jcli.main), ("torch", tcli.main)):
        d = tmp_path / tag
        d.mkdir()
        aln = str(d / "aln.phy")
        write_phylip(aln, names, seqs)
        (d / "tree.nwk").write_text(topo.to_newick(names) + "\n")
        argv = ["-i", aln, "-u", str(d / "tree.nwk"), "-m", "GTR", "-c",
                "4", "-o", "lr", "-b", "0", "--platform", "cpu",
                "--r_seed", "1", "--quiet", "--ancestral", "--mutmap"]
        assert main(argv) == 0
        out[tag] = dict(
            tree=open(f"{aln}_phyml_ancestral_tree.txt").read(),
            table=_read_table(d / "aln.phy_phyml_ancestral_seq.txt"),
            mutmap=open(f"{aln}_phyml_mutmap.txt").read().splitlines(),
            fitted=open(f"{aln}_phyml_tree.txt").read())
    j, t = out["jax"], out["torch"]
    strip = lambda s: __import__("re").sub(r":[0-9.eE+-]+", "", s)
    assert strip(t["tree"]) == strip(j["tree"])
    assert [ln.replace("jax", "torch") for ln in j["table"][0]] == \
        t["table"][0]
    for a, b in zip(j["table"][1], t["table"][1]):
        assert a[:2] == b[:2] and a[3] == b[3]
        np.testing.assert_allclose(b[2], a[2], rtol=0, atol=CLI_TOL)
    for mm in (j["mutmap"], t["mutmap"]):
        assert mm[0] == ("# sampled substitution history "
                         "(node, site, time_from_parent, from, to)")
        assert len(mm) > 1
    events = []
    for ln in t["mutmap"][1:]:
        f = ln.split("\t")
        events.append((int(f[0]), int(f[1]), float(f[2]), int(f[3]),
                       int(f[4])))
    # the port's draw on the fitted tree
    ttopo = TTopology.from_newick(t["fitted"], names)
    rv = ttopo.rooted()
    _, states = draws[-1]
    taln = tread(str(tmp_path / "torch" / "aln.phy"), datatype="nt")
    # the printed times carry 6 significant digits, the tree 8 decimals
    _replay(events, states.numpy(), np.asarray(rv.child),
            np.asarray(rv.node_blen), taln.n_otu, range(taln.n_patterns),
            t_tol=1e-5)
