"""The port's likelihood engine against phyml_tpu's, in float64.

phyml_tpu runs its scan path (use_pallas=False); the port runs its
kernels' plain versions (CPU tensors) and its own scan path.  Both
sides get identical parameters through interop.params_from_numpy and
identical trees through interop.tree_arrays_from_numpy.  Tolerances:
lnL 1e-6 absolute, per-site 1e-8 — float64 roundoff over a few
hundred patterns; the two sides rescale differently (exact powers of
two against divide-by-max), which changes only the last bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu.evolve import simulate_alignment
from phyml_tpu.io.alignment import compact as jcompact
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.ops.likelihood import LikelihoodEngine as JEngine
from phyml_tpu.ops.likelihood import tree_arrays as jtree_arrays
from phyml_tpu.topology import Topology
from phyml_tpu_torch import datatypes
from phyml_tpu_torch.interop import params_from_numpy, tree_arrays_from_numpy
from phyml_tpu_torch.io.alignment import compact as tcompact
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine
from phyml_tpu_torch.ops.likelihood import default_device, tree_arrays

LNL_TOL = 1e-6
SITE_TOL = 1e-8
N_TAXA = 12


def _setup(invar: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    topo = Topology.random(N_TAXA, rng, mean_blen=0.12)
    kw = dict(datatype="nt", name="GTR", n_classes=4, invar=invar)
    jm, tm = JModel(**kw), TModel(**kw)
    sim_p = jm.init_params(np.array([0.3, 0.2, 0.3, 0.2]))
    sim_p["rr_val"] = jnp.log(jnp.asarray([1.2, 3.0, 0.8, 1.1, 4.0, 1.0]))
    sim_p["alpha"] = jnp.asarray(0.7)
    names, seqs = simulate_alignment(topo, jm, sim_p, 300, rng)
    enc = datatypes.encode_sequences(seqs, "nt")
    jaln = jcompact(enc, names, "nt")
    taln = tcompact(enc, names, "nt")
    jp = jm.init_params(jaln.obs_state_freqs)
    jp["rr_val"] = jnp.log(jnp.asarray([1.5, 2.5, 0.9, 1.3, 3.0, 1.0]))
    jp["alpha"] = jnp.asarray(0.55)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    jeng = JEngine(jaln, jm, dtype=jnp.float64, use_pallas=False)
    teng = TEngine(taln, tm, dtype=torch.float64, device="cpu")
    rv = topo.rooted()
    jta = jtree_arrays(rv, dtype=jnp.float64)
    tta = tree_arrays_from_numpy(np.asarray(jta.child),
                                 np.asarray(jta.blen), device="cpu",
                                 dtype=torch.float64)
    return jeng, jp, jta, teng, tp, tta, jaln.n_patterns


@pytest.mark.parametrize("invar", [False, True])
def test_loglik_and_site_logliks(invar):
    jeng, jp, jta, teng, tp, tta, k = _setup(invar)
    want_site = np.asarray(jeng.site_logliks(jp, jta))[:k]
    want = float(jeng.loglik(jp, jta))
    # host entry points: K1's plain version
    np.testing.assert_allclose(teng.site_logliks(tp, tta).numpy(),
                               want_site, rtol=0, atol=SITE_TOL)
    assert abs(float(teng.loglik(tp, tta)) - want) < LNL_TOL
    # K3's plain version and the scan path give the same numbers
    sysv = teng.system_of(tp)
    assert abs(float(teng._loglik_sys(sysv, tta)) - want) < LNL_TOL
    np.testing.assert_allclose(teng.site_logliks_scan(sysv, tta).numpy(),
                               want_site, rtol=0, atol=SITE_TOL)


@pytest.mark.parametrize("invar", [False, True])
def test_edge_lnl_terms(invar):
    """Per-edge (lnL, dlnL, d2lnL) through K2's plain version and
    through the scan path, against phyml_tpu's scan path."""
    jeng, jp, jta, teng, tp, tta, k = _setup(invar, seed=1)
    d, sc, aux = jeng.edge_dotprods(jp, jta, jeng.weights)
    want = [np.asarray(x) for x in jeng.edge_lnl_terms(d, sc, aux,
                                                       jta.blen)]
    free = np.ones(teng.n_nodes, bool)
    free[-1] = False
    free[int(tta.child[-1, 1])] = False
    sysv = teng.system_of(tp)
    for d_t, sc_t, aux_t in (teng.edge_dotprods_sys(sysv, tta),
                             teng.edge_dotprods_scan(sysv, tta)):
        got = teng.edge_lnl_terms(d_t, sc_t, aux_t, tta.blen)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy()[free], w[free],
                                       rtol=1e-7, atol=LNL_TOL)


def test_batched_loglik_matches_single():
    """loglik_batch (one batched K3 call) equals per-row lnL."""
    _, _, _, teng, tp, tta, _ = _setup(False, seed=2)
    alphas = torch.tensor([0.25, 0.8, 2.0], dtype=torch.float64)
    batch = teng.loglik_batch(teng._system(dict(tp, alpha=alphas)), tta)
    for b in range(3):
        single = teng.loglik(dict(tp, alpha=alphas[b]), tta)
        assert abs(float(batch[b]) - float(single)) < LNL_TOL


def test_params_and_tree_carried_across():
    """params_from_numpy plus the port's own tree_arrays reproduce the
    JAX engine's lnL on the same tree: the state every parity test
    relies on crosses over intact."""
    jeng, jp, jta, teng, _, _, _ = _setup(True, seed=3)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    assert set(tp) == set(jp)
    for name, v in tp.items():
        assert v.dtype == torch.float64
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp[name]))
    rv = Topology.random(N_TAXA, np.random.default_rng(9),
                         mean_blen=0.2).rooted()
    want = float(jeng.loglik(jp, jtree_arrays(rv, dtype=jnp.float64)))
    got = float(teng.loglik(tp, tree_arrays(rv, dtype=torch.float64,
                                            device="cpu")))
    assert abs(got - want) < LNL_TOL


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a device argument the engine and the tree arrays go to
    the CUDA device; with none they raise and name device="cpu"
    rather than falling back to the CPU."""
    _, _, _, teng, _, _, _ = _setup(False)
    rv = Topology.random(N_TAXA, np.random.default_rng(0)).rooted()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: TEngine(teng.aln, teng.model),
                  lambda: tree_arrays(rv),
                  lambda: tree_arrays_from_numpy(rv.child, rv.node_blen)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
    assert tree_arrays(rv, device="cpu").blen.device.type == "cpu"
