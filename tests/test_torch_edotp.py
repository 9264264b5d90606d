"""The edge dot products (K2, K5) against phyml_tpu, and their wrappers.

Engine: `LikelihoodEngine.edge_dotprods_sys` (on the CPU the K2/K5
wrappers run their plain version) against phyml_tpu's
`edge_dotprods_sys` (its scan path), both in float64 on the same
alignment, tree and parameters, at 4 and 20 states, one and four rate
classes, on a caterpillar, a balanced and a random tree.  The two sides
split d and sc_d differently, so they are compared through each side's
`edge_site_terms` on the free edges: per-site lnL within 1e-6 (float64
roundoff over ~100 patterns), its first and second derivatives within
1e-6 relative to their scale.

Kernels: the plain version in float32 against phyml_tpu's Pallas
kernels in interpret mode (`edge_dotprods_pallas`,
`edge_dotprods_pallas_stream`), as tests/test_torch_kernels.py and
tests/test_torch_aa.py run them, on the tree shapes those leave out;
per-edge site terms within 2e-3 (tests/test_pallas.py's tolerance).

Host side: the launch geometry the CUDA kernels share (csrc/edotp.cuh)
and the wrappers' contract on CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu.io.alignment import compact as jcompact
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.ops import pallas_edotp
from phyml_tpu.ops.likelihood import LikelihoodEngine as JEngine
from phyml_tpu.ops.likelihood import tree_arrays as jtree_arrays
from phyml_tpu.topology import Topology
from phyml_tpu_torch.interop import params_from_numpy, tree_arrays_from_numpy
from phyml_tpu_torch.io.alignment import compact as tcompact
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.ops import _build, edotp
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine

LNL_TOL = 1e-6     # float64 engines
EDGE_TOL = 2e-3    # float32 plain version against Pallas (test_pallas.py)
N_TAXA, N_SITES = 12, 100


def _balanced_newick(lo, hi):
    if hi - lo == 1:
        return f"t{lo}:0.11"
    mid = (lo + hi) // 2
    return (f"({_balanced_newick(lo, mid)},{_balanced_newick(mid, hi)})"
            ":0.07")


def _topology(shape, n, rng):
    names = [f"t{i}" for i in range(n)]
    if shape == "caterpillar":
        return Topology.caterpillar(n, blen=0.09)
    if shape == "balanced":
        return Topology.from_newick(_balanced_newick(0, n) + ";", names)
    return Topology.random(n, rng, mean_blen=0.12)


def _alignment(ns, n, sites, rng):
    enc = np.zeros((n, sites, ns), dtype=np.float32)
    enc[np.arange(n)[:, None], np.arange(sites)[None],
        rng.integers(0, ns, size=(n, sites))] = 1.0
    enc[rng.random((n, sites)) < 0.03] = 1.0   # gaps
    return enc, [f"t{i}" for i in range(n)]


def _free(rv):
    free = np.ones(rv.n_nodes, bool)
    free[-1] = False                     # the root row
    free[int(rv.child[-1, 1])] = False   # the zero-length root child
    return free


@pytest.mark.parametrize("shape", ["caterpillar", "balanced", "random"])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("ns", [4, 20])
def test_engine_edge_terms_match_phyml_tpu(ns, C, shape):
    rng = np.random.default_rng(ns * 10 + C)
    datatype = "nt" if ns == 4 else "aa"
    enc, names = _alignment(ns, N_TAXA, N_SITES, rng)
    jaln, taln = jcompact(enc, names, datatype), tcompact(enc, names,
                                                          datatype)
    kw = dict(datatype=datatype, name="GTR" if ns == 4 else "LG",
              n_classes=C)
    jm, tm = JModel(**kw), TModel(**kw)
    jeng = JEngine(jaln, jm, dtype=jnp.float64, use_pallas=False)
    teng = TEngine(taln, tm, dtype=torch.float64, device="cpu")
    jp = jm.init_params(rng.dirichlet(np.full(ns, 8.0)))
    if "rr_val" in jp:
        jp["rr_val"] = jnp.log(jnp.asarray(rng.uniform(0.5, 4.0, 6)))
    if "alpha" in jp:
        jp["alpha"] = jnp.asarray(rng.uniform(0.3, 2.0))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    rv = _topology(shape, N_TAXA, rng).rooted()
    jta = jtree_arrays(rv, dtype=jnp.float64)
    tta = tree_arrays_from_numpy(np.asarray(jta.child), np.asarray(jta.blen),
                                 device="cpu", dtype=torch.float64)
    k = jaln.n_patterns

    d_j, sc_j, aux_j = jeng.edge_dotprods_sys(jeng.system_of(jp), jta,
                                              jeng.weights)
    want = jeng.edge_site_terms(d_j, sc_j, aux_j, jta.blen)
    d_t, sc_t, aux_t = teng.edge_dotprods_sys(teng.system_of(tp), tta)
    got = teng.edge_site_terms(d_t, sc_t, aux_t, tta.blen)
    free = _free(rv)
    for g, w in zip(got, want):
        g, w = g.numpy()[free], np.asarray(w)[free][..., :k]
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=LNL_TOL * scale)


def _pallas_problem(ns, shape, seed):
    """float32 engines on both sides (phyml_tpu's builds the tips,
    P-matrices and eigensystem, handed over as numpy arrays)."""
    rng = np.random.default_rng(seed)
    n = 8
    datatype = "nt" if ns == 4 else "aa"
    enc, names = _alignment(ns, n, 150, rng)
    jaln, taln = jcompact(enc, names, datatype), tcompact(enc, names,
                                                          datatype)
    kw = dict(datatype=datatype, name="GTR" if ns == 4 else "LG",
              n_classes=4)
    jm = JModel(**kw)
    jp = jm.init_params(jaln.obs_state_freqs)
    jp["alpha"] = jnp.asarray(0.6)
    jeng = JEngine(jaln, jm, dtype=jnp.float32, use_pallas=True)
    teng = TEngine(taln, TModel(**kw), dtype=torch.float32, device="cpu")
    rv = _topology(shape, n, rng).rooted()
    jta = jtree_arrays(rv, dtype=jnp.float32)
    sysv = jeng.system_of(jp)
    return jeng, teng, rv, jta, sysv, jaln.n_patterns, n


@pytest.mark.parametrize("ns,shape,stream", [
    (4, "caterpillar", False),
    (20, "balanced", True),
])
def test_plain_matches_pallas(ns, shape, stream):
    jeng, teng, rv, jta, sysv, k, n = _pallas_problem(ns, shape, 11)
    lam, V, Vinv, pi, w, pinv = sysv
    pm = jeng._pmats(lam, V, Vinv, jta.blen)
    kw = dict(n_otu=n, n_int=n - 1, C=4, ns=ns, interpret=True)
    if stream:
        d_j, sc_j = pallas_edotp.edge_dotprods_pallas_stream(
            jta.child, jeng.tips, pm, V, Vinv, pi, T=128, **kw)
        wrapper = edotp.edge_dotprods_stream
    else:
        d_j, sc_j = pallas_edotp.edge_dotprods_pallas(
            jta.child, jeng.tips, pm, V, Vinv, pi, T=jeng.edotp_tile, **kw)
        wrapper = edotp.edge_dotprods
    t = lambda x: torch.as_tensor(np.array(x))
    d_t, sc_t = wrapper(torch.as_tensor(rv.child), teng.tips, t(pm), t(V),
                        t(Vinv), t(pi))
    aux = dict(lam=t(lam), w=t(w), pinv=t(pinv), weights=teng.weights,
               inv_lk=torch.zeros(k))
    blen = t(rv.node_blen).float()
    site_j = teng.edge_site_terms(t(d_j)[..., :k], t(sc_j)[..., :k], aux,
                                  blen)[0]
    site_t = teng.edge_site_terms(d_t, sc_t, aux, blen)[0]
    free = _free(rv)
    err = float((site_t[free] - site_j[free]).abs().max())
    assert err < EDGE_TOL, err


@pytest.mark.parametrize("ns,C,P", [(4, 4, 3767), (20, 4, 3945),
                                    (4, 1, 5), (20, 1, 16), (4, 4, 33),
                                    (20, 4, 17)])
def test_geometry(ns, C, P):
    """One block of one warp per pattern tile and class (tile 32 at 4
    states, 16 at 20): the bench shapes give 472 and 988 blocks, several
    per SM on an H100's 132.  The workspace pads the pattern axis to
    whole tiles and no further, so every tile row starts 16-byte
    aligned; a block's static shared memory stays within the 48 KB a
    block may hold without opting in."""
    g = edotp.geometry(ns, C, P)
    T = g["tile"]
    assert T == edotp.TILE[ns] == {4: 32, 20: 16}[ns]
    assert g["Pw"] % T == 0 and 0 <= g["Pw"] - P < T and g["Pw"] % 4 == 0
    assert g["blocks"] == g["Pw"] // T * C and g["threads"] == 32
    assert g["smem_bytes"] <= 48 * 1024
    # two workspace tensors of ns + 1 rows per node and class: the
    # partial's states and its log2 scale
    assert g["workspace_floats_per_node"] == C * (ns + 1) * g["Pw"]
    if P > 3000:
        assert g["blocks"] >= 3 * 132


def _operands():
    """K2/K5 operands for a random 8-taxon tree on the CPU (float32)."""
    rng = np.random.default_rng(5)
    n, ns, P, C = 8, 4, 33, 4
    child = np.asarray(Topology.random(n, rng).rooted().child,
                       dtype=np.int32)
    f = lambda *s: torch.as_tensor(rng.random(s), dtype=torch.float32)
    return dict(child=torch.as_tensor(child), tips=f(n, ns, P),
                pmats=f(2 * n - 1, C, ns, ns), V=f(C, ns, ns),
                Vinv=f(C, ns, ns), pi=f(C, ns))


@pytest.mark.parametrize("wrapper", ["edge_dotprods", "edge_dotprods_stream"])
def test_wrapper_runs_the_plain_version_on_cpu_tensors(wrapper):
    ops = _operands()
    n0 = getattr(edotp, wrapper).launches
    d, sc = getattr(edotp, wrapper)(**ops)
    want_d, want_sc = edotp.edge_dotprods_plain(**ops)
    torch.testing.assert_close(d, want_d, rtol=0, atol=0)
    torch.testing.assert_close(sc, want_sc, rtol=0, atol=0)
    assert getattr(edotp, wrapper).launches == n0   # no kernel launched
    assert bool((d[-1] == 0).all()) and bool((sc[-1] == 0).all())


def _swap_rows(child):
    c = child.clone()
    c[[0, -1]] = c[[-1, 0]]
    return c


@pytest.mark.parametrize("change,match", [
    (lambda o: dict(o, child=o["child"][:-1]), "inconsistent"),
    (lambda o: dict(o, pmats=o["pmats"][:-1]), "inconsistent"),
    (lambda o: dict(o, V=o["V"][:, :3]), "inconsistent"),
    (lambda o: dict(o, pi=o["pi"][:2]), "inconsistent"),
    (lambda o: dict(o, child=_swap_rows(o["child"])), "not a postorder"),
    (lambda o: dict(o, child=o["child"].index_fill(1, torch.tensor([0]),
                                                   -1)), "not a postorder"),
], ids=["child", "pmats", "V", "pi", "order", "negative"])
@pytest.mark.parametrize("wrapper", ["edge_dotprods", "edge_dotprods_stream"])
def test_wrapper_rejects_bad_operands(wrapper, change, match):
    with pytest.raises(ValueError, match=match):
        getattr(edotp, wrapper)(**change(_operands()))


@pytest.mark.parametrize("bad,match", [
    (lambda o: dict(o, tips=o["tips"].double()), "got torch.float64"),
    (lambda o: dict(o, pmats=o["pmats"].transpose(2, 3)), "contiguous=False"),
    (lambda o: dict(o, child=o["child"].long()), "got torch.int64"),
], ids=["float64", "non-contiguous", "int64-child"])
def test_card_operand_checks(bad, match):
    """The check the card path runs before a launch (_build.check_operands,
    called by both wrappers for CUDA tensors), on CPU tensors."""
    o = bad(_operands())
    with pytest.raises(ValueError, match=match):
        _build.check_operands("edge_dotprods", ints=(o["child"],),
                              floats=(o["tips"], o["pmats"], o["V"],
                                      o["Vinv"], o["pi"]))
