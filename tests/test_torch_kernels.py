"""The kernels' plain PyTorch versions against phyml_tpu's Pallas
kernels run in interpret mode (as tests/test_pallas.py runs them).

float32 on the CPU, at small size (16 taxa, <= 256 patterns): the
Pallas interpret mode unrolls the kernels' loops.  Both sides get the
same inputs: the tips, P-matrices and eigensystem are built once by
phyml_tpu and handed over as numpy arrays.  Tolerances are
tests/test_pallas.py's: 5e-4 per site for K1/K3 (:44, DNA) and 2e-3
for K2's per-edge site terms (:218), compared through
edge_site_terms on the free edges because the two sides split d and
sc_d differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu.io.alignment import compact as jcompact
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.ops import pallas_clv, pallas_clv_slots, pallas_edotp
from phyml_tpu.ops.likelihood import LikelihoodEngine as JEngine
from phyml_tpu.ops.likelihood import tree_arrays as jtree_arrays
from phyml_tpu.topology import Topology
from phyml_tpu_torch.io.alignment import compact as tcompact
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.ops import clv, clv_slots, edotp
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine

K13_TOL = 5e-4
K2_TOL = 2e-3
N_TAXA, N_SITES = 16, 220


def _problem(C, seed=0):
    """Random DNA alignment (some gaps), a random tree and GTR+G(C)
    on both sides; returns a dict of shared inputs."""
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 4, size=(N_TAXA, N_SITES))
    enc = np.zeros((N_TAXA, N_SITES, 4), dtype=np.float32)
    enc[np.arange(N_TAXA)[:, None], np.arange(N_SITES)[None], states] = 1
    enc[rng.random((N_TAXA, N_SITES)) < 0.03] = 1.0   # gaps
    names = [f"t{i}" for i in range(N_TAXA)]
    jaln = jcompact(enc, names, "nt")
    taln = tcompact(enc, names, "nt")
    jm = JModel(datatype="nt", name="GTR", n_classes=C)
    tm = TModel(datatype="nt", name="GTR", n_classes=C)
    jp = jm.init_params(jaln.obs_state_freqs)
    jp["rr_val"] = jnp.log(jnp.asarray([1.2, 3.0, 0.8, 1.1, 4.0, 1.0]))
    if C > 1:
        jp["alpha"] = jnp.asarray(0.6)
    jeng = JEngine(jaln, jm, dtype=jnp.float32, use_pallas=True)
    teng = TEngine(taln, tm, dtype=torch.float32, device="cpu")
    rv = Topology.random(N_TAXA, rng, mean_blen=0.15).rooted()
    jta = jtree_arrays(rv, dtype=jnp.float32)
    sysv = jeng.system_of(jp)
    lam, V, Vinv, pi, w, pinv = sysv
    pmats = jeng._pmats(lam, V, Vinv, jta.blen)
    return dict(jeng=jeng, teng=teng, jm=jm, jp=jp, rv=rv, jta=jta,
                sys=sysv, pmats=pmats, k=jaln.n_patterns,
                logw=jnp.log(w))


def _t(x):
    return torch.as_tensor(np.array(x))


def _schedule(child):
    """K3's schedule arguments for a child table."""
    sched, n_slots = clv_slots.build_slot_schedule(N_TAXA, child)
    return dict(sched=torch.as_tensor(sched), n_slots=n_slots)


@pytest.mark.parametrize("C", [1, 4])
def test_k1_plain_matches_pallas(C):
    pb = _problem(C)
    jeng, teng, k = pb["jeng"], pb["teng"], pb["k"]
    _, _, _, pi, w, _ = pb["sys"]
    sched, _ = pallas_clv_slots.build_slot_schedule(N_TAXA, pb["rv"].child)
    want = pallas_clv_slots.uppass_site_lse_slots(
        jnp.asarray(sched), jeng.tips, pb["pmats"], pi, pb["logw"],
        n_otu=N_TAXA, n_int=N_TAXA - 1, C=C, ns=4,
        n_slots=jeng.slot_count, T=jeng.slot_tile, interpret=True)
    got = clv_slots.uppass_site_lse_slots(
        torch.as_tensor(sched), teng.tips, _t(pb["pmats"]), _t(pi),
        _t(pb["logw"]), n_slots=teng.slot_count)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:k],
                               atol=K13_TOL)


@pytest.mark.parametrize("C", [1, 4])
def test_k3_plain_matches_pallas(C):
    pb = _problem(C, seed=1)
    jeng, teng, k = pb["jeng"], pb["teng"], pb["k"]
    _, _, _, pi, w, _ = pb["sys"]
    want = pallas_clv.uppass_site_lse(
        pb["jta"].child, jeng.tips, pb["pmats"], pi, pb["logw"],
        n_otu=N_TAXA, n_int=N_TAXA - 1, C=C, ns=4, T=jeng.pallas_tile,
        interpret=True)
    got = clv.uppass_site_lse(
        torch.as_tensor(pb["rv"].child), teng.tips, _t(pb["pmats"]),
        _t(pi), _t(pb["logw"]), **_schedule(pb["rv"].child))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:k],
                               atol=K13_TOL)


def test_k3_batched_matches_vmap():
    """Three parameter sets in one batched call against jax.vmap of
    the Pallas kernel (the line search's use of K3)."""
    pb = _problem(4, seed=2)
    jeng, teng, k = pb["jeng"], pb["teng"], pb["k"]
    systems = [jeng.system_of(dict(pb["jp"], alpha=jnp.asarray(a)))
               for a in (0.3, 1.0, 2.5)]
    pm = jnp.stack([jeng._pmats(s[0], s[1], s[2], pb["jta"].blen)
                    for s in systems])
    pi = jnp.stack([s[3] for s in systems])
    logw = jnp.stack([jnp.log(s[4]) for s in systems])
    kern = lambda pm_, pi_, lw_: pallas_clv.uppass_site_lse(
        pb["jta"].child, jeng.tips, pm_, pi_, lw_, n_otu=N_TAXA,
        n_int=N_TAXA - 1, C=4, ns=4, T=jeng.pallas_tile, interpret=True)
    want = jax.vmap(kern)(pm, pi, logw)
    got = clv.uppass_site_lse(torch.as_tensor(pb["rv"].child), teng.tips,
                              _t(pm), _t(pi), _t(logw),
                              **_schedule(pb["rv"].child))
    assert got.shape == (3, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :k],
                               atol=K13_TOL)


def test_k2_plain_matches_pallas():
    pb = _problem(4, seed=3)
    jeng, teng, k = pb["jeng"], pb["teng"], pb["k"]
    lam, V, Vinv, pi, w, pinv = pb["sys"]
    d_j, sc_j = pallas_edotp.edge_dotprods_pallas(
        pb["jta"].child, jeng.tips, pb["pmats"], V, Vinv, pi,
        n_otu=N_TAXA, n_int=N_TAXA - 1, C=4, ns=4, T=jeng.edotp_tile,
        interpret=True)
    d_t, sc_t = edotp.edge_dotprods(
        torch.as_tensor(pb["rv"].child), teng.tips, _t(pb["pmats"]),
        _t(V), _t(Vinv), _t(pi))
    # one eigensystem (phyml_tpu's) for both sides' site terms
    aux = dict(lam=_t(lam), w=_t(w), pinv=_t(pinv),
               weights=teng.weights, inv_lk=torch.zeros(k))
    blen = _t(pb["rv"].node_blen).float()
    site_j = teng.edge_site_terms(_t(d_j)[..., :k], _t(sc_j)[..., :k],
                                  aux, blen)[0]
    site_t = teng.edge_site_terms(d_t, sc_t, aux, blen)[0]
    free = np.ones(2 * N_TAXA - 1, bool)
    free[-1] = False
    free[int(pb["rv"].child[-1, 1])] = False
    err = (site_t[free] - site_j[free]).abs().max()
    assert float(err) < K2_TOL, float(err)


def test_slot_schedule_matches_phyml_tpu():
    """The copied schedule function is exact: same steps, same slots."""
    rng = np.random.default_rng(4)
    for n in (4, 8, 33, 128, 300):
        for _ in range(3):
            child = Topology.random(n, rng).rooted().child
            s_j, k_j = pallas_clv_slots.build_slot_schedule(n, child)
            s_t, k_t = clv_slots.build_slot_schedule(n, child)
            assert k_t == k_j <= int(np.ceil(np.log2(n))) + 1
            np.testing.assert_array_equal(s_t, s_j)
