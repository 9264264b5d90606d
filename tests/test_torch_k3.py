"""K3's route through the engine against phyml_tpu, and the wrapper's
checks.

`LikelihoodEngine._site_logliks_sys` passes the slot schedule to K3
(ops/clv.py:uppass_site_lse); on the CPU the wrapper runs K3's plain
version.  Both engines run in float64 (phyml_tpu on its scan path) on
the same alignment, tree and parameters, one system or a batch of five
(against jax.vmap of phyml_tpu's site log-likelihood), at 4 and 20
states, one and four rate classes, on a balanced tree (the most slots
of any shape: 3 at 16 taxa) and a caterpillar (one slot, rewritten in
place every step).  Tolerance 1e-6 on per-site and total lnL: float64
roundoff over ~100 patterns, the two sides rescaling differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu.io.alignment import compact as jcompact
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.ops.likelihood import LikelihoodEngine as JEngine
from phyml_tpu.ops.likelihood import tree_arrays as jtree_arrays
from phyml_tpu.topology import Topology
from phyml_tpu_torch.interop import params_from_numpy, tree_arrays_from_numpy
from phyml_tpu_torch.io.alignment import compact as tcompact
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.ops import clv
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine

LNL_TOL = 1e-6
N_TAXA, N_SITES = 16, 110


def _balanced_newick(lo, hi):
    if hi - lo == 1:
        return f"t{lo}:0.11"
    mid = (lo + hi) // 2
    return (f"({_balanced_newick(lo, mid)},{_balanced_newick(mid, hi)})"
            ":0.07")


def _problem(datatype, C, shape, B, seed=0):
    """float64 engines on both sides and B parameter sets (different
    frequencies, and rates or shape where the model has them)."""
    rng = np.random.default_rng(seed)
    ns = 4 if datatype == "nt" else 20
    names = [f"t{i}" for i in range(N_TAXA)]
    enc = np.zeros((N_TAXA, N_SITES, ns), dtype=np.float32)
    enc[np.arange(N_TAXA)[:, None], np.arange(N_SITES)[None],
        rng.integers(0, ns, size=(N_TAXA, N_SITES))] = 1.0
    enc[rng.random((N_TAXA, N_SITES)) < 0.03] = 1.0   # gaps
    jaln, taln = jcompact(enc, names, datatype), tcompact(enc, names,
                                                          datatype)
    kw = dict(datatype=datatype, name="GTR" if ns == 4 else "LG",
              n_classes=C)
    jm, tm = JModel(**kw), TModel(**kw)
    jeng = JEngine(jaln, jm, dtype=jnp.float64, use_pallas=False)
    teng = TEngine(taln, tm, dtype=torch.float64, device="cpu")
    topo = (Topology.caterpillar(N_TAXA, blen=0.09) if shape == "caterpillar"
            else Topology.from_newick(_balanced_newick(0, N_TAXA) + ";",
                                      names))
    jta = jtree_arrays(topo.rooted(), dtype=jnp.float64)
    tta = tree_arrays_from_numpy(np.asarray(jta.child), np.asarray(jta.blen),
                                 device="cpu", dtype=torch.float64)
    jps = []
    for _ in range(B):
        jp = jm.init_params(rng.dirichlet(np.full(ns, 8.0)))
        if "rr_val" in jp:
            jp["rr_val"] = jnp.log(jnp.asarray(rng.uniform(0.5, 4.0, 6)))
        if "alpha" in jp:
            jp["alpha"] = jnp.asarray(rng.uniform(0.3, 2.0))
        jps.append(jp)
    tps = [params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
           for jp in jps]
    return jeng, jta, jps, teng, tta, tps, jaln.n_patterns


@pytest.mark.parametrize("shape", ["balanced", "caterpillar"])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_engine_k3_route_matches_phyml_tpu(datatype, C, shape):
    """One system through K3's route: site lnL against phyml_tpu's
    site_logliks, lnL against its loglik."""
    jeng, jta, jps, teng, tta, tps, k = _problem(datatype, C, shape, 1)
    _, _, n_slots = teng._topology(tta.child)
    assert n_slots == (1 if shape == "caterpillar" else 3)
    want_site = np.asarray(jeng.site_logliks(jps[0], jta))[:k]
    sysv = teng.system_of(tps[0])
    np.testing.assert_allclose(teng._site_logliks_sys(sysv, tta).numpy(),
                               want_site, rtol=0, atol=LNL_TOL)
    assert abs(float(teng._loglik_sys(sysv, tta))
               - float(jeng.loglik(jps[0], jta))) < LNL_TOL


@pytest.mark.parametrize("shape", ["balanced", "caterpillar"])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_engine_k3_batch_matches_vmap(datatype, C, shape):
    """Five systems in one K3 call against jax.vmap of phyml_tpu's
    site log-likelihood over the same five systems."""
    jeng, jta, jps, teng, tta, tps, k = _problem(datatype, C, shape, 5,
                                                 seed=1)
    jsys = [jeng.system_of(jp) for jp in jps]
    jstack = tuple(jnp.stack(parts) for parts in zip(*jsys))
    want = jax.vmap(lambda s: jeng._site_logliks_sys(s, jta))(jstack)
    tsys = [teng.system_of(tp) for tp in tps]
    tstack = tuple(torch.stack(parts) for parts in zip(*tsys))
    got = teng._site_logliks_sys(tstack, tta)
    assert got.shape == (5, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :k],
                               rtol=0, atol=LNL_TOL)
    lnl = teng.loglik_batch(tstack, tta)
    for b in range(5):
        assert abs(float(lnl[b]) - float(jeng.loglik(jps[b], jta))) \
            < LNL_TOL


def _operands(B=2):
    """K3 operands for a random 8-taxon tree on the CPU."""
    from phyml_tpu_torch.ops.clv_slots import build_slot_schedule

    rng = np.random.default_rng(3)
    n, ns, P, C = 8, 4, 33, 4
    child = np.asarray(Topology.random(n, rng).rooted().child,
                       dtype=np.int32)
    sched, n_slots = build_slot_schedule(n, child)
    pm = torch.as_tensor(rng.dirichlet(np.ones(ns), (B, 2 * n - 1, C, ns)))
    return dict(child=torch.as_tensor(child),
                tips=torch.as_tensor(rng.random((n, ns, P))),
                pmats=pm, pi=torch.full((B, C, ns), 0.25, dtype=pm.dtype),
                logw=torch.full((B, C), np.log(0.25), dtype=pm.dtype),
                sched=torch.as_tensor(sched), n_slots=n_slots)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    ops = _operands()
    got = clv.uppass_site_lse(**ops)
    want = clv.uppass_site_lse_plain(ops["child"], ops["tips"],
                                     ops["pmats"], ops["pi"], ops["logw"])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    one = clv.uppass_site_lse(**dict(ops, pmats=ops["pmats"][0],
                                     pi=ops["pi"][0], logw=ops["logw"][0]))
    torch.testing.assert_close(one, want[0], rtol=0, atol=0)


@pytest.mark.parametrize("change,match", [
    (lambda o: dict(o, sched=o["sched"][:-1]), "schedule has shape"),
    (lambda o: dict(o, sched=o["sched"][:, :6]), "schedule has shape"),
    (lambda o: dict(o, n_slots=0), "n_slots=0"),
    (lambda o: dict(o, n_slots=99), "n_slots=99"),
    (lambda o: dict(o, n_slots=o["n_slots"] - 1), "does not fit"),
    (lambda o: dict(o, sched=o["sched"].index_fill(1, torch.tensor([0]),
                                                   40)), "does not fit"),
    (lambda o: dict(o, child=o["child"][:-1]), "inconsistent"),
    (lambda o: dict(o, pmats=o["pmats"][:, :-1]), "inconsistent"),
    (lambda o: dict(o, pi=o["pi"][:1]), "inconsistent"),
    (lambda o: dict(o, logw=o["logw"][:, :2]), "inconsistent"),
], ids=["steps", "columns", "no-slots", "too-many-slots", "slot-index",
        "node-index", "child", "pmats", "pi", "logw"])
def test_wrapper_rejects_bad_operands(change, match):
    with pytest.raises(ValueError, match=match):
        clv.uppass_site_lse(**change(_operands()))
