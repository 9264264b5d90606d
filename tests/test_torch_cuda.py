"""The CUDA kernels against their plain versions, on the card.

Marked `gpu`; each test skips without a CUDA device.  The machine with
the card has no JAX, so run this file without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -m gpu

float32 on both sides, on the same card tensors.  Tolerances as in
tests/test_torch_kernels.py: 5e-4 per site for K1/K3 on DNA, 2e-3 on
amino acids (tests/test_pallas.py's AA tolerance), 2e-3 for the
per-edge site terms of K2/K5 (at 20 states beyond the float32 plain
version's own gap to float64; see _site_terms_gaps).  The streamed
kernels K4 and K5 compute K1's and K2's functions, so their plain
versions are K1's and K2's.
The pattern count (301) is not a multiple of any block width, so the
ragged edge is exercised.
"""

import numpy as np
import pytest
import torch

from phyml_tpu_torch.io.alignment import compact
from phyml_tpu_torch.models.substitution import SubstModel
from phyml_tpu_torch.ops import _build, clv, clv_slots, edotp
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
from phyml_tpu_torch.topology import Topology

pytestmark = pytest.mark.gpu

K13_TOL = 5e-4
K2_TOL = 2e-3
AA_TOL = 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(cuda, C, n=40, sites=301, seed=0, datatype="nt"):
    rng = np.random.default_rng(seed)
    ns = 4 if datatype == "nt" else 20
    enc = np.zeros((n, sites, ns), dtype=np.float32)
    enc[np.arange(n)[:, None], np.arange(sites)[None],
        rng.integers(0, ns, size=(n, sites))] = 1.0
    aln = compact(enc, [f"t{i}" for i in range(n)], datatype)
    model = SubstModel(datatype=datatype,
                       name="GTR" if datatype == "nt" else "LG",
                       n_classes=C)
    params = model.init_params(aln.obs_state_freqs)
    if C > 1:
        params["alpha"] = torch.tensor(0.5, dtype=torch.float64)
    eng = LikelihoodEngine(aln, model, dtype=torch.float32, device=cuda)
    rv = Topology.random(n, rng, mean_blen=0.2).rooted()
    tree = tree_arrays(rv, device=cuda)
    sys_ = eng.system_of(params)
    pm = eng._pmats(sys_[0], sys_[1], sys_[2], tree.blen)
    return eng, tree, sys_, pm


@pytest.mark.parametrize("C", [1, 4])
def test_k1_and_k3_match_plain(cuda, C):
    eng, tree, (lam, V, Vinv, pi, w, _), pm = _setup(cuda, C)
    child, sched = eng._topology(tree.child)
    logw = eng._logw(w)
    k1 = clv_slots.uppass_site_lse_slots(sched, eng.tips, pm, pi, logw,
                                         n_slots=eng.slot_count)
    ref = clv_slots.uppass_site_lse_slots_plain(
        sched, eng.tips, pm, pi, logw, n_slots=eng.slot_count)
    assert float((k1 - ref).abs().max()) < K13_TOL
    k3 = clv.uppass_site_lse(child, eng.tips, pm, pi, logw)
    assert float((k3 - ref).abs().max()) < K13_TOL
    pmb = torch.stack([pm, eng._pmats(lam * 1.5, V, Vinv, tree.blen)])
    pib, lwb = torch.stack([pi, pi]), torch.stack([logw, logw])
    k3b = clv.uppass_site_lse(child, eng.tips, pmb, pib, lwb)
    refb = clv.uppass_site_lse_plain(child, eng.tips, pmb, pib, lwb)
    assert float((k3b - refb).abs().max()) < K13_TOL


def test_k2_matches_plain(cuda):
    eng, tree, sys_, pm = _setup(cuda, 4, seed=1)
    lam, V, Vinv, pi, w, _ = sys_
    child, _ = eng._topology(tree.child)
    aux = eng._aux(sys_, None)
    sites = [eng.edge_site_terms(*f(child, eng.tips, pm, V, Vinv, pi),
                                 aux, tree.blen)[0]
             for f in (edotp.edge_dotprods, edotp.edge_dotprods_plain)]
    free = torch.ones(eng.n_nodes, dtype=torch.bool)
    free[-1] = False
    free[int(tree.child[-1, 1])] = False
    assert float((sites[0][free] - sites[1][free]).abs().max()) < K2_TOL


def test_wrappers_reject_float64(cuda):
    eng, tree, sys_, pm = _setup(cuda, 4)
    child, _ = eng._topology(tree.child)
    with pytest.raises(ValueError, match="float32"):
        clv.uppass_site_lse(child, eng.tips.double(), pm.double(),
                            sys_[3].double(), eng._logw(sys_[4]).double())


def _free_edges(eng, tree):
    free = torch.ones(eng.n_nodes, dtype=torch.bool)
    free[-1] = False
    free[int(tree.child[-1, 1])] = False
    return free


def _site_terms_gaps(eng, tree, sys_, pm, kernel):
    """Per-edge site terms on the free edges through an edge-dot-product
    kernel and through K2's plain version in float32, each against the
    plain version in float64: returns the two largest gaps.  At 20
    states the float32 site terms of random sequences are ill
    conditioned (the eigen-basis sum cancels), so the kernel is held
    to the float32 plain version's own accuracy plus K2_TOL."""
    lam, V, Vinv, pi, w, _ = sys_
    child, _ = eng._topology(tree.child)
    aux = {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
           else v for k, v in eng._aux(sys_, None).items()}
    free = _free_edges(eng, tree)
    sites = []
    for f, dt in ((kernel, torch.float32),
                  (edotp.edge_dotprods_plain, torch.float32),
                  (edotp.edge_dotprods_plain, torch.float64)):
        d, sc = f(child, *(x.to(dt) for x in (eng.tips, pm, V, Vinv, pi)))
        sites.append(eng.edge_site_terms(d.double(), sc.double(), aux,
                                         tree.blen.double())[0][free])
    return (float((sites[0] - sites[2]).abs().max()),
            float((sites[1] - sites[2]).abs().max()))


@pytest.mark.parametrize("datatype,C", [("nt", 4), ("aa", 4), ("aa", 1)])
def test_streamed_kernels_match_plain(cuda, datatype, C):
    """K4 against K1's plain version and K5 against K2's, at a ragged
    pattern count."""
    eng, tree, sys_, pm = _setup(cuda, C, seed=2, datatype=datatype)
    assert eng.P % _build.block_patterns(C) != 0
    tol = K13_TOL if datatype == "nt" else AA_TOL
    _, sched = eng._topology(tree.child)
    pi, logw = sys_[3], eng._logw(sys_[4])
    n0 = clv_slots.uppass_site_lse_slots_stream.launches
    k4 = clv_slots.uppass_site_lse_slots_stream(
        sched, eng.tips, pm, pi, logw, n_slots=eng.slot_count)
    ref = clv_slots.uppass_site_lse_slots_plain(
        sched, eng.tips, pm, pi, logw, n_slots=eng.slot_count)
    torch.cuda.synchronize()
    assert clv_slots.uppass_site_lse_slots_stream.launches == n0 + 1
    assert float((k4 - ref).abs().max()) < tol
    k5_err, plain_err = _site_terms_gaps(eng, tree, sys_, pm,
                                         edotp.edge_dotprods_stream)
    assert k5_err < plain_err + K2_TOL


@pytest.mark.parametrize("C", [1, 4])
def test_aa_resident_kernels_match_plain(cuda, C):
    """K1, K2 and K3 (single and batched) at 20 states."""
    eng, tree, sys_, pm = _setup(cuda, C, seed=3, datatype="aa")
    lam, V, Vinv, pi, w, _ = sys_
    child, sched = eng._topology(tree.child)
    logw = eng._logw(w)
    ref = clv_slots.uppass_site_lse_slots_plain(
        sched, eng.tips, pm, pi, logw, n_slots=eng.slot_count)
    k1 = clv_slots.uppass_site_lse_slots(sched, eng.tips, pm, pi, logw,
                                         n_slots=eng.slot_count)
    assert float((k1 - ref).abs().max()) < AA_TOL
    k3 = clv.uppass_site_lse(child, eng.tips, pm, pi, logw)
    assert float((k3 - ref).abs().max()) < AA_TOL
    pmb = torch.stack([pm, eng._pmats(lam * 1.5, V, Vinv, tree.blen)])
    pib, lwb = torch.stack([pi, pi]), torch.stack([logw, logw])
    k3b = clv.uppass_site_lse(child, eng.tips, pmb, pib, lwb)
    refb = clv.uppass_site_lse_plain(child, eng.tips, pmb, pib, lwb)
    assert float((k3b - refb).abs().max()) < AA_TOL
    k2_err, plain_err = _site_terms_gaps(eng, tree, sys_, pm,
                                         edotp.edge_dotprods)
    assert k2_err < plain_err + K2_TOL


def test_aa_engine_takes_the_streamed_route(cuda):
    """At 128 taxa the AA engine routes its host lnL through K4 and its
    edge dot products through K5, and both agree with the float64
    scan path."""
    eng, tree, sys_, _ = _setup(cuda, 4, n=128, sites=257, seed=4,
                                datatype="aa")
    assert (eng.lnl_route, eng.edotp_route) == ("K4", "K5")
    params = eng.model.init_params(eng.aln.obs_state_freqs)
    n4 = clv_slots.uppass_site_lse_slots_stream.launches
    n5 = edotp.edge_dotprods_stream.launches
    lnl = float(eng.loglik(params, tree))
    eng.edge_dotprods_sys(eng.system_of(params), tree)
    torch.cuda.synchronize()
    assert clv_slots.uppass_site_lse_slots_stream.launches == n4 + 1
    assert edotp.edge_dotprods_stream.launches == n5 + 1
    eng64 = LikelihoodEngine(eng.aln, eng.model, dtype=torch.float64,
                             device=cuda)
    want = float(torch.sum(eng64.site_logliks_scan(
        eng64.system_of(params),
        tree._replace(blen=tree.blen.double())) * eng64.weights))
    assert abs(lnl - want) < 0.5
