"""The CUDA kernels against their plain versions, on the card.

Marked `gpu`; each test skips without a CUDA device.  The machine with
the card has no JAX, so run this file without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -m gpu

float32 on both sides, on the same card tensors.  Tolerances as in
tests/test_torch_kernels.py: 5e-4 per site for K1/K3, 2e-3 for K2's
per-edge site terms.  The pattern count (301) is not a multiple of
any block width, so the ragged edge is exercised.
"""

import numpy as np
import pytest
import torch

from phyml_tpu_torch.io.alignment import compact
from phyml_tpu_torch.models.substitution import SubstModel
from phyml_tpu_torch.ops import clv, clv_slots, edotp
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
from phyml_tpu_torch.topology import Topology

pytestmark = pytest.mark.gpu

K13_TOL = 5e-4
K2_TOL = 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(cuda, C, n=40, sites=301, seed=0):
    rng = np.random.default_rng(seed)
    enc = np.zeros((n, sites, 4), dtype=np.float32)
    enc[np.arange(n)[:, None], np.arange(sites)[None],
        rng.integers(0, 4, size=(n, sites))] = 1.0
    aln = compact(enc, [f"t{i}" for i in range(n)], "nt")
    model = SubstModel(datatype="nt", name="GTR", n_classes=C)
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
