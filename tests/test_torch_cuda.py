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
ragged edge is exercised; the edge-dot-product tests add counts below
one tile, one tile plus one and the bench counts, and tree shapes.
"""

import os
import subprocess
import sys

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
AA_TOL = 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(cuda, C, n=40, sites=301, seed=0, datatype="nt", topo=None):
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
    rv = (topo or Topology.random(n, rng, mean_blen=0.2)).rooted()
    tree = tree_arrays(rv, device=cuda)
    sys_ = eng.system_of(params)
    pm = eng._pmats(sys_[0], sys_[1], sys_[2], tree.blen)
    return eng, tree, sys_, pm


@pytest.mark.parametrize("C", [1, 4])
def test_k1_and_k3_match_plain(cuda, C):
    eng, tree, (lam, V, Vinv, pi, w, _), pm = _setup(cuda, C)
    child, sched, n_slots = eng._topology(tree.child)
    logw = eng._logw(w)
    k1 = clv_slots.uppass_site_lse_slots(sched, eng.tips, pm, pi, logw,
                                         n_slots=eng.slot_count)
    ref = clv_slots.uppass_site_lse_slots_plain(
        sched, eng.tips, pm, pi, logw, n_slots=eng.slot_count)
    assert float((k1 - ref).abs().max()) < K13_TOL
    k3 = clv.uppass_site_lse(child, eng.tips, pm, pi, logw, sched=sched,
                             n_slots=n_slots)
    assert float((k3 - ref).abs().max()) < K13_TOL
    pmb = torch.stack([pm, eng._pmats(lam * 1.5, V, Vinv, tree.blen)])
    pib, lwb = torch.stack([pi, pi]), torch.stack([logw, logw])
    k3b = clv.uppass_site_lse(child, eng.tips, pmb, pib, lwb, sched=sched,
                              n_slots=n_slots)
    refb = clv.uppass_site_lse_plain(child, eng.tips, pmb, pib, lwb)
    assert float((k3b - refb).abs().max()) < K13_TOL


def test_k2_matches_plain(cuda):
    eng, tree, sys_, pm = _setup(cuda, 4, seed=1)
    lam, V, Vinv, pi, w, _ = sys_
    child, _, _ = eng._topology(tree.child)
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
    child, sched, n_slots = eng._topology(tree.child)
    with pytest.raises(ValueError, match="float32"):
        clv.uppass_site_lse(child, eng.tips.double(), pm.double(),
                            sys_[3].double(), eng._logw(sys_[4]).double(),
                            sched=sched, n_slots=n_slots)


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
    child, _, _ = eng._topology(tree.child)
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
    assert eng.P % clv_slots.TILE != 0
    tol = K13_TOL if datatype == "nt" else AA_TOL
    _, sched, _ = eng._topology(tree.child)
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
    """K1, K2 and K3 (single and batched) at 20 states; K1 on an 8-taxon
    tree, since it holds each class's P-matrices of the whole tree in
    shared memory, which at 20 states fits a block of four classes only
    for small trees (ops/likelihood.py:kernel_route), the others on a
    40-taxon one."""
    eng, tree, sys_, pm = _setup(cuda, C, n=8, seed=3, datatype="aa")
    _, sched, _ = eng._topology(tree.child)
    pi, logw = sys_[3], eng._logw(sys_[4])
    ref = clv_slots.uppass_site_lse_slots_plain(
        sched, eng.tips, pm, pi, logw, n_slots=eng.slot_count)
    k1 = clv_slots.uppass_site_lse_slots(sched, eng.tips, pm, pi, logw,
                                         n_slots=eng.slot_count)
    assert float((k1 - ref).abs().max()) < AA_TOL
    eng, tree, sys_, pm = _setup(cuda, C, seed=3, datatype="aa")
    lam, V, Vinv, pi, w, _ = sys_
    child, sched, n_slots = eng._topology(tree.child)
    logw = eng._logw(w)
    ref = clv_slots.uppass_site_lse_slots_plain(
        sched, eng.tips, pm, pi, logw, n_slots=eng.slot_count)
    k3 = clv.uppass_site_lse(child, eng.tips, pm, pi, logw, sched=sched,
                             n_slots=n_slots)
    assert float((k3 - ref).abs().max()) < AA_TOL
    pmb = torch.stack([pm, eng._pmats(lam * 1.5, V, Vinv, tree.blen)])
    pib, lwb = torch.stack([pi, pi]), torch.stack([logw, logw])
    k3b = clv.uppass_site_lse(child, eng.tips, pmb, pib, lwb, sched=sched,
                              n_slots=n_slots)
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


def _k3_batch(eng, tree, sys_, pm, B):
    """K3's operands for B parameter sets: the P-matrices at B rate
    scales, the same frequencies and class weights."""
    lam, V, Vinv, pi, w, _ = sys_
    f = torch.linspace(0.5, 2.0, B).tolist() if B > 1 else [1.0]
    pmb = torch.stack([pm if x == 1.0 else
                       eng._pmats(lam * x, V, Vinv, tree.blen) for x in f])
    return (pmb, pi.expand(B, *pi.shape).contiguous(),
            eng._logw(w).expand(B, *w.shape).contiguous())


@pytest.mark.parametrize("B", [1, 2, 13, 65])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_k3_matches_plain(cuda, datatype, C, B):
    """The slot-scheduled K3 against its plain version at the
    optimizer's batch sizes, one launch each; 301 patterns leave a
    ragged last tile at every tile width."""
    eng, tree, sys_, pm = _setup(cuda, C, seed=5, datatype=datatype)
    child, sched, n_slots = eng._topology(tree.child)
    pmb, pib, lwb = _k3_batch(eng, tree, sys_, pm, B)
    n0 = clv.uppass_site_lse.launches
    got = clv.uppass_site_lse(child, eng.tips, pmb, pib, lwb, sched=sched,
                              n_slots=n_slots)
    ref = clv.uppass_site_lse_plain(child, eng.tips, pmb, pib, lwb)
    torch.cuda.synchronize()
    assert clv.uppass_site_lse.launches == n0 + 1
    assert got.shape == (B, eng.P) and bool(torch.isfinite(got).all())
    tol = K13_TOL if datatype == "nt" else AA_TOL
    assert float((got - ref).abs().max()) < tol


@pytest.mark.parametrize("datatype,sites", [("nt", 5), ("aa", 9),
                                            ("nt", 130), ("aa", 47)])
def test_k3_short_and_ragged_pattern_axis(cuda, datatype, sites):
    """Fewer patterns than one tile (64 at 4 states, 16 at 20) and a
    ragged last tile: no column past P is stored, every valid one is
    right."""
    eng, tree, sys_, pm = _setup(cuda, 4, n=20, sites=sites, seed=6,
                                 datatype=datatype)
    child, sched, n_slots = eng._topology(tree.child)
    pmb, pib, lwb = _k3_batch(eng, tree, sys_, pm, 3)
    out = torch.full((3, eng.P + 64), 7.0, device=cuda)
    got = out[:, :eng.P]
    got.copy_(clv.uppass_site_lse(child, eng.tips, pmb, pib, lwb,
                                  sched=sched, n_slots=n_slots))
    ref = clv.uppass_site_lse_plain(child, eng.tips, pmb, pib, lwb)
    tol = K13_TOL if datatype == "nt" else AA_TOL
    assert float((got - ref).abs().max()) < tol
    assert bool((out[:, eng.P:] == 7.0).all())


@pytest.mark.parametrize("datatype", ["nt", "aa"])
@pytest.mark.parametrize("shape", ["caterpillar", "balanced"])
def test_k3_tree_shapes(cuda, datatype, shape):
    """A caterpillar walks one slot in place (every step reads and
    writes it); a balanced tree needs the most slots of any shape at
    its size (5 at 64 taxa, rooted on tip 0's edge)."""
    n = 64
    topo = (Topology.caterpillar(n, blen=0.05) if shape == "caterpillar"
            else Topology.from_newick(_balanced_newick(0, n) + ";",
                                      [f"t{i}" for i in range(n)]))
    eng, tree, sys_, pm = _setup(cuda, 4, n=n, sites=257, seed=7,
                                 datatype=datatype, topo=topo)
    child, sched, n_slots = eng._topology(tree.child)
    assert n_slots == (1 if shape == "caterpillar" else 5)
    pmb, pib, lwb = _k3_batch(eng, tree, sys_, pm, 2)
    got = clv.uppass_site_lse(child, eng.tips, pmb, pib, lwb, sched=sched,
                              n_slots=n_slots)
    ref = clv.uppass_site_lse_plain(child, eng.tips, pmb, pib, lwb)
    tol = K13_TOL if datatype == "nt" else AA_TOL
    assert float((got - ref).abs().max()) < tol


def _balanced_newick(lo, hi):
    if hi - lo == 1:
        return f"t{lo}:0.1"
    mid = (lo + hi) // 2
    return (f"({_balanced_newick(lo, mid)},{_balanced_newick(mid, hi)})"
            ":0.05")


def test_k3_allocates_only_its_output(cuda):
    """A B=13 protein-shaped call (128 taxa, ~3900 patterns, C=4) holds
    no workspace: its peak stays below inputs + output + 64 MB (the
    kernel before the slot schedule took 2.1 GB of scratch here)."""
    eng, tree, sys_, pm = _setup(cuda, 4, n=128, sites=4096, seed=8,
                                 datatype="aa")
    child, sched, n_slots = eng._topology(tree.child)
    pmb, pib, lwb = _k3_batch(eng, tree, sys_, pm, 13)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    out = clv.uppass_site_lse(child, eng.tips, pmb, pib, lwb, sched=sched,
                              n_slots=n_slots)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - base
    assert peak <= out.numel() * 4 + 64 * 2 ** 20
    assert bool(torch.isfinite(out).all())


# A child process: K3 on a card schedule that does not fit its launch
# must trap (the context is lost, hence the process of its own).
_BAD_SCHEDULE = """
import sys
import numpy as np
import torch
from phyml_tpu_torch.ops import clv
from phyml_tpu_torch.ops.clv_slots import build_slot_schedule
from phyml_tpu_torch.topology import Topology

rng = np.random.default_rng(0)
n, ns, P, C = 20, int(sys.argv[1]), 300, 4
child = np.asarray(Topology.random(n, rng).rooted().child, dtype=np.int32)
sched, n_slots = build_slot_schedule(n, child)
if sys.argv[2] == "slot":
    n_slots -= 1          # the schedule's last slot lies past the launch
else:
    sched[-1, 0] = 2 * n  # a node past the tree
cuda = torch.device("cuda")
f = lambda *shape: torch.rand(*shape, device=cuda)
pm = f(1, 2 * n - 1, C, ns, ns).contiguous()
try:
    clv.uppass_site_lse(torch.as_tensor(child, device=cuda), f(n, ns, P),
                        pm, f(1, C, ns), f(1, C),
                        sched=torch.as_tensor(sched, device=cuda),
                        n_slots=n_slots)
    torch.cuda.synchronize()
except RuntimeError as exc:
    print("raised:", exc)
    sys.exit(0)
sys.exit(1)
"""


@pytest.mark.parametrize("what", ["slot", "node"])
@pytest.mark.parametrize("ns", [4, 20])
def test_k3_traps_on_a_schedule_that_does_not_fit(cuda, ns, what):
    """The wrapper checks a card schedule's shape only; the kernel
    checks each row's slots and nodes as it loads it, so a schedule
    whose slots exceed n_slots (which size the shared memory) or whose
    nodes lie past the tree raises instead of writing past the slots."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _BAD_SCHEDULE, str(ns), what],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "raised:" in run.stdout


def _edotp_kernel(name):
    return {"K2": edotp.edge_dotprods, "K5": edotp.edge_dotprods_stream}[name]


def _tree_of(shape, n, rng):
    if shape == "caterpillar":
        return Topology.caterpillar(n, blen=0.05)
    if shape == "balanced":
        return Topology.from_newick(_balanced_newick(0, n) + ";",
                                    [f"t{i}" for i in range(n)])
    return Topology.random(n, rng, mean_blen=0.2)


def _simulated_setup(cuda, C, n, sites, seed, datatype, topo):
    """_setup's engine and operands on sequences simulated down the tree
    under its own model (float64 on the CPU), so the site likelihoods
    are those of real data: random sequences at 20 states and C = 1 make
    the float32 site terms cancel (see _site_terms_gaps)."""
    from phyml_tpu_torch.models.eigen import pmat

    rng = np.random.default_rng(seed)
    ns = 4 if datatype == "nt" else 20
    model = SubstModel(datatype=datatype,
                       name="GTR" if datatype == "nt" else "LG",
                       n_classes=C)
    params = model.init_params(np.full(ns, 1.0 / ns))
    if C > 1:
        params["alpha"] = torch.tensor(0.5, dtype=torch.float64)
    lam, V, Vinv, pi, w, _ = model.class_system(params)
    rv = topo.rooted()
    t = torch.as_tensor(rv.node_blen)[:, None].expand(rv.n_nodes, C)
    P = np.clip(pmat(lam, V, Vinv, t).numpy(), 0.0, None)
    P /= P.sum(-1, keepdims=True)
    cls = rng.choice(C, size=sites, p=w.numpy() / float(w.sum()))
    states = np.zeros((rv.n_nodes, sites), dtype=np.int64)
    states[-1] = rng.choice(ns, size=sites, p=pi.numpy()[0])
    for i in range(rv.n_internal - 1, -1, -1):       # preorder
        for c in rv.child[i]:
            cum = P[int(c), cls, states[n + i], :].cumsum(axis=1)
            r = rng.random(sites)[:, None]
            states[int(c)] = np.clip((r > cum).sum(axis=1), 0, ns - 1)
    enc = np.zeros((n, sites, ns), dtype=np.float32)
    enc[np.arange(n)[:, None], np.arange(sites)[None], states[:n]] = 1.0
    aln = compact(enc, [f"t{i}" for i in range(n)], datatype)
    eng = LikelihoodEngine(aln, model, dtype=torch.float32, device=cuda)
    tree = tree_arrays(rv, device=cuda)
    sys_ = eng.system_of(params)
    return eng, tree, sys_, eng._pmats(sys_[0], sys_[1], sys_[2], tree.blen)


@pytest.mark.parametrize("shape", ["caterpillar", "balanced", "random"])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("datatype", ["nt", "aa"])
@pytest.mark.parametrize("kernel", ["K2", "K5"])
def test_edotp_tree_shapes(cuda, kernel, datatype, C, shape):
    """K2 and K5 (one body) against K2's plain version through the
    per-edge site terms on the free edges, on a caterpillar (every step
    hands its result to the next), a balanced and a random tree, on 400
    sites simulated down the tree (260-400 patterns); one launch
    each."""
    n = 32
    topo = _tree_of(shape, n, np.random.default_rng(9))
    eng, tree, sys_, pm = _simulated_setup(cuda, C, n, 400, 9, datatype,
                                           topo)
    f = _edotp_kernel(kernel)
    n0 = f.launches
    k_err, plain_err = _site_terms_gaps(eng, tree, sys_, pm, f)
    torch.cuda.synchronize()
    assert f.launches == n0 + 1
    assert k_err < plain_err + K2_TOL


@pytest.mark.parametrize("case", ["below-tile", "tile+1", "bench"])
@pytest.mark.parametrize("datatype", ["nt", "aa"])
@pytest.mark.parametrize("kernel", ["K2", "K5"])
def test_edotp_pattern_counts(cuda, kernel, datatype, case):
    """Fewer patterns than one tile, one tile plus one, and the odd
    bench counts (3767 DNA, 3945 protein patterns at 128 taxa): every
    column up to P right, the root row zero."""
    ns = 4 if datatype == "nt" else 20
    T = edotp.TILE[ns]
    n, sites = {"below-tile": (20, 5), "tile+1": (20, T + 1),
                "bench": (128, 3767 if ns == 4 else 3945)}[case]
    eng, tree, sys_, pm = _setup(cuda, 4, n=n, sites=sites, seed=10,
                                 datatype=datatype)
    assert eng.P == sites
    f = _edotp_kernel(kernel)
    k_err, plain_err = _site_terms_gaps(eng, tree, sys_, pm, f)
    assert k_err < plain_err + K2_TOL
    child, _, _ = eng._topology(tree.child)
    d, sc = f(child, eng.tips, pm, sys_[1], sys_[2], sys_[3])
    assert bool((d[-1] == 0).all()) and bool((sc[-1] == 0).all())
    assert bool(torch.isfinite(d).all()) and bool(torch.isfinite(sc).all())


@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_edotp_allocates_outputs_and_workspace_only(cuda, datatype):
    """A bench-shaped call (128 taxa, 4096 sites, C=4) holds d, sc_d and
    the two workspace tensors at its peak, nothing more."""
    ns = 4 if datatype == "nt" else 20
    eng, tree, sys_, pm = _setup(cuda, 4, n=128, sites=4096, seed=11,
                                 datatype=datatype)
    child, _, _ = eng._topology(tree.child)
    g = edotp.geometry(ns, 4, eng.P)
    want = (eng.n_nodes * 4 * (ns + 1) * eng.P
            + 2 * (eng.n_otu - 1) * g["workspace_floats_per_node"]) * 4
    for f in (edotp.edge_dotprods, edotp.edge_dotprods_stream):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda)
        base = torch.cuda.memory_allocated(cuda)
        d, sc = f(child, eng.tips, pm, sys_[1], sys_[2], sys_[3])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(cuda) - base
        assert peak <= want + 2 ** 20, (peak, want)
        del d, sc


# A child process: K2/K5 on a child table that is not a postorder must
# trap (the context is lost, hence the process of its own).
_BAD_CHILD = """
import sys
import numpy as np
import torch
from phyml_tpu_torch.ops import edotp
from phyml_tpu_torch.topology import Topology

rng = np.random.default_rng(0)
n, ns, P, C = 20, int(sys.argv[1]), 300, 4
child = np.asarray(Topology.random(n, rng).rooted().child, dtype=np.int32)
child[0, 0] = n + 5      # row 0 reads an internal node made later
cuda = torch.device("cuda")
f = lambda *shape: torch.rand(*shape, device=cuda)
fn = edotp.edge_dotprods if sys.argv[2] == "K2" else edotp.edge_dotprods_stream
try:
    fn(torch.as_tensor(child, device=cuda), f(n, ns, P),
       f(2 * n - 1, C, ns, ns).contiguous(), f(C, ns, ns), f(C, ns, ns),
       f(C, ns))
    torch.cuda.synchronize()
except RuntimeError as exc:
    print("raised:", exc)
    sys.exit(0)
sys.exit(1)
"""


@pytest.mark.parametrize("kernel", ["K2", "K5"])
@pytest.mark.parametrize("ns", [4, 20])
def test_edotp_traps_on_a_child_table_out_of_postorder(cuda, ns, kernel):
    """The wrapper checks a card child table's shape only; each block
    checks that row i's children lie in [0, n_otu + i) and traps, since
    the workspace is indexed by node."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _BAD_CHILD, str(ns), kernel],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "raised:" in run.stdout


def _slot_kernel(name):
    return {"K1": clv_slots.uppass_site_lse_slots,
            "K4": clv_slots.uppass_site_lse_slots_stream}[name]


def _slot_check(eng, tree, sys_, pm, kernel, rel=0.0):
    """One launch of K1 or K4 on the schedule's own slot count, on the
    engine's row-padded tips and on the contiguous tips (which the
    wrapper pads first at an odd P), against K1's plain version and
    against K3 at B=1 on the same tensors, within the tolerance plus
    rel times the site lnL; returns the kernel's output."""
    child, sched, n_slots = eng._topology(tree.child)
    pi, logw = sys_[3], eng._logw(sys_[4])
    f = _slot_kernel(kernel)
    ref = clv_slots.uppass_site_lse_slots_plain(sched, eng.tips, pm, pi,
                                                logw, n_slots=n_slots)
    k3 = clv.uppass_site_lse(child, eng.tips, pm, pi, logw, sched=sched,
                             n_slots=n_slots)
    tol = (K13_TOL if eng.ns == 4 else AA_TOL) + rel * ref.abs()
    assert eng.slot_tips.stride(1) % 32 == 0
    for tips in (eng.slot_tips, eng.tips):
        n0 = f.launches
        got = f(sched, tips, pm, pi, logw, n_slots=n_slots)
        torch.cuda.synchronize()
        assert f.launches == n0 + 1
        assert got.shape == (eng.P,) and bool(torch.isfinite(got).all())
        assert bool(((got - ref).abs() < tol).all())
        assert bool(((got - k3).abs() < tol).all())
    return got


@pytest.mark.parametrize("shape", ["caterpillar", "balanced", "random"])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("datatype", ["nt", "aa"])
@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_slot_kernels_tree_shapes(cuda, kernel, datatype, C, shape):
    """K1 and K4 (one body) on a caterpillar (one slot, rewritten in
    place every step), a balanced tree (the most slots: 5 at 32 taxa)
    and a random one, on sequences simulated down the tree; 8 taxa for
    K1 at 20 states and four classes, whose whole-tree matrices of four
    classes must fit a block."""
    n = 8 if (kernel, datatype, C) == ("K1", "aa", 4) else 32
    topo = _tree_of(shape, n, np.random.default_rng(12))
    eng, tree, sys_, pm = _simulated_setup(cuda, C, n, 400, 12, datatype,
                                           topo)
    _slot_check(eng, tree, sys_, pm, kernel)


@pytest.mark.parametrize("sites,C", [(1, 1), (31, 2), (33, 3), ("bench", 4)])
@pytest.mark.parametrize("datatype", ["nt", "aa"])
@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_slot_kernels_pattern_counts(cuda, kernel, datatype, sites, C):
    """One pattern, one below and one above a 32-pattern tile (and 31,
    33 around two 16-pattern tiles), and the odd bench counts (3767 DNA,
    3945 protein patterns at 128 taxa; 8 taxa for K1 at 20 states, whose
    whole-tree matrices of four classes must fit a block): no column
    past P is stored, every valid one is right."""
    ns = 4 if datatype == "nt" else 20
    n = 8 if (kernel, ns) == ("K1", 20) else 20
    if sites == "bench":
        sites = 3767 if ns == 4 else 3945
        n = 8 if (kernel, ns) == ("K1", 20) else 128
    eng, tree, sys_, pm = _setup(cuda, C, n=n, sites=sites, seed=13,
                                 datatype=datatype)
    assert eng.P == sites
    _slot_check(eng, tree, sys_, pm, kernel)


@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_slot_kernels_allocate_their_outputs_only(cuda, datatype):
    """A bench-shaped call (128 taxa, 4096 sites, C=4) of the route's
    slot kernel holds only its output [P]."""
    eng, tree, sys_, pm = _setup(cuda, 4, n=128, sites=4096, seed=14,
                                 datatype=datatype)
    _, sched, n_slots = eng._topology(tree.child)
    f = _slot_kernel(eng.lnl_route)
    args = (sched, eng.slot_tips, pm, sys_[3], eng._logw(sys_[4]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    out = f(*args, n_slots=n_slots)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - base
    assert peak <= eng.P * 4 + 2 ** 20, peak
    assert bool(torch.isfinite(out).all())


def test_k1_refuses_a_tree_whose_matrices_do_not_fit(cuda):
    """K1 holds each class's P-matrices of the whole tree in shared
    memory: at 128-taxon protein (408 KB a class) it raises, naming the
    shape limit, and the engine routes that tree to K4."""
    eng, tree, sys_, pm = _setup(cuda, 4, n=128, sites=64, seed=15,
                                 datatype="aa")
    assert eng.lnl_route == "K4"
    _, sched, n_slots = eng._topology(tree.child)
    with pytest.raises(NotImplementedError, match="shared memory"):
        clv_slots.uppass_site_lse_slots(sched, eng.tips, pm, sys_[3],
                                        eng._logw(sys_[4]), n_slots=n_slots)


@pytest.mark.parametrize("datatype,n", [("nt", 6500), ("aa", 3000)])
def test_slot_kernels_on_trees_of_thousands_of_taxa(cuda, datatype, n):
    """K4 (the route of such trees) on random trees of thousands of
    taxa: its shared memory does not grow with the tree, only with the
    schedule's slot count.  The site lnL runs to the thousands there, so
    the tolerance adds 4e-7 of it (a few float32 steps)."""
    topo = _tree_of("random", n, np.random.default_rng(17))
    eng, tree, sys_, pm = _simulated_setup(cuda, 4, n, 33, 17, datatype,
                                           topo)
    assert eng.lnl_route == "K4"
    _slot_check(eng, tree, sys_, pm, "K4", rel=4e-7)


@pytest.mark.parametrize("C,n,shape,want", [
    (8, 16, "caterpillar", "K4"), (8, 16, "balanced", "K3"),
    (8, 3000, "random", "K3"), (4, 3000, "random", "K4")])
def test_single_passes_go_to_k3_where_k4_does_not_fit(cuda, C, n, shape,
                                                      want):
    """At 20 states K4's block of C warps holds a ring and the slots per
    warp: at C = 8 one slot only (the 16-taxon balanced tree needs 3,
    the 3000-taxon random one 6), at C = 4 twelve.  A single-system pass
    whose schedule needs more goes to K3 at B = 1
    (ops/likelihood.py:single_pass_kernel), and agrees with K1's plain
    version."""
    topo = _tree_of(shape, n, np.random.default_rng(18))
    eng, tree, sys_, pm = _simulated_setup(cuda, C, n, 33, 18, "aa", topo)
    _, sched, n_slots = eng._topology(tree.child)
    f4, k3 = clv_slots.uppass_site_lse_slots_stream, clv.uppass_site_lse
    n4, n3 = f4.launches, k3.launches_by_batch.get(1, 0)
    got = eng._site_logliks_sys(sys_, tree)
    torch.cuda.synchronize()
    ran = {(1, 0): "K4", (0, 1): "K3"}[
        (f4.launches - n4, k3.launches_by_batch.get(1, 0) - n3)]
    assert (eng.lnl_route, ran) == ("K4", want)
    lse = clv_slots.uppass_site_lse_slots_plain(
        sched, eng.tips, pm, sys_[3], eng._logw(sys_[4]), n_slots=n_slots)
    ref = eng._mix_invar(lse, sys_[3], sys_[4], sys_[5])
    assert bool(((got - ref).abs() < AA_TOL + 4e-7 * ref.abs()).all())


@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_single_systems_take_the_slot_kernels(cuda, datatype):
    """The branch-length probes' _loglik_sys with one system launches
    the route's slot kernel, not K3; a batch of two launches K3."""
    n = 128 if datatype == "aa" else 40
    eng, tree, sys_, pm = _setup(cuda, 4, n=n, sites=301, seed=16,
                                 datatype=datatype)
    f = _slot_kernel(eng.lnl_route)
    n_slot, n_k3 = f.launches, clv.uppass_site_lse.launches
    one = eng._loglik_sys(sys_, tree)
    torch.cuda.synchronize()
    assert (f.launches, clv.uppass_site_lse.launches) == (n_slot + 1, n_k3)
    two = eng._loglik_sys(tuple(torch.stack([x, x]) for x in sys_), tree)
    torch.cuda.synchronize()
    assert (f.launches, clv.uppass_site_lse.launches) == (n_slot + 1,
                                                          n_k3 + 1)
    assert abs(float(one) - float(two[0])) < 1e-2


# A child process: K1 or K4 on a card schedule that does not fit its
# launch must trap (the context is lost, hence the process of its own).
_BAD_SLOT_SCHEDULE = """
import sys
import numpy as np
import torch
from phyml_tpu_torch.ops import clv_slots
from phyml_tpu_torch.topology import Topology

rng = np.random.default_rng(0)
ns, P, C = int(sys.argv[1]), 300, 4
# K1 at 20 states holds the whole tree's matrices of 4 classes: 8 taxa
n = 8 if (sys.argv[3], ns) == ("K1", 20) else 20
n_slots = 1
while n_slots < 2:   # a slot to take away
    child = np.asarray(Topology.random(n, rng).rooted().child,
                       dtype=np.int32)
    sched, n_slots = clv_slots.build_slot_schedule(n, child)
what = sys.argv[2]
if what == "slot":
    n_slots -= 1            # the schedule's last slot lies past the launch
elif what == "node":
    sched[-1, 0] = 2 * n    # a node past the tree
    sched[-1, 1] = 0
else:
    sched[0, 0], sched[0, 1] = n + 3, 1   # a tip past the tips
cuda = torch.device("cuda")
f = lambda *shape: torch.rand(*shape, device=cuda)
fn = clv_slots.uppass_site_lse_slots if sys.argv[3] == "K1" \
    else clv_slots.uppass_site_lse_slots_stream
try:
    fn(torch.as_tensor(sched, device=cuda), f(n, ns, P),
       f(2 * n - 1, C, ns, ns).contiguous(), f(C, ns), f(C),
       n_slots=n_slots)
    torch.cuda.synchronize()
except NotImplementedError as exc:   # refused at launch: no trap
    print("refused:", exc)
    sys.exit(2)
except RuntimeError as exc:
    print("raised:", exc)
    sys.exit(0)
sys.exit(1)
"""


@pytest.mark.parametrize("what", ["slot", "node", "tip"])
@pytest.mark.parametrize("ns", [4, 20])
@pytest.mark.parametrize("kernel", ["K1", "K4"])
def test_slot_kernels_trap_on_a_schedule_that_does_not_fit(cuda, kernel, ns,
                                                           what):
    """The wrappers check a card schedule's shape only; each block
    checks every row once and traps on a slot past n_slots (which sizes
    the shared memory), an internal node past the tree or a tip past
    the tips."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _BAD_SLOT_SCHEDULE, str(ns),
                          what, kernel], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "raised:" in run.stdout


# ----------------------------------------------------------------------
# the search's tensor code (no kernel of its own): the card in float32
# against the CPU in float64 on the same simulated alignment
# ----------------------------------------------------------------------
SEARCH_LNL_TOL = 0.05    # lnL of a 40 x 400 problem, float32 vs float64
D_TOL = 1e-3             # ML distances (chip_smoke.py's bound)


def _search_setup(cuda, datatype, n=40, sites=400, seed=3):
    """(card float32 engine, CPU float64 engine, params, tree of each)
    on sequences simulated down a random tree."""
    from phyml_tpu_torch.ops.likelihood import tree_arrays as ta_of

    rng = np.random.default_rng(seed)
    topo = Topology.random(n, rng, mean_blen=0.1)
    eng, tree, _, _ = _simulated_setup(cuda, 4, n, sites, seed, datatype,
                                       topo)
    params = eng.model.init_params(np.full(eng.ns, 1.0 / eng.ns))
    params["alpha"] = torch.tensor(0.5, dtype=torch.float64)
    eng64 = LikelihoodEngine(eng.aln, eng.model, dtype=torch.float64,
                             device="cpu")
    rv = Topology.random(n, rng, mean_blen=0.1).rooted()
    return (eng, eng64, params, rv, ta_of(rv, device=cuda),
            ta_of(rv, dtype=torch.float64, device="cpu"))


@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_distances_on_the_card(cuda, datatype):
    from phyml_tpu_torch.search.distances import ml_pairwise_distances

    eng, eng64, params, *_ = _search_setup(cuda, datatype)
    D = ml_pairwise_distances(eng, params)
    D64 = ml_pairwise_distances(eng64, params)
    assert np.abs(D - D64).max() <= D_TOL


@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_masked_passes_on_the_card(cuda, datatype):
    """The masked up and down passes with a candidate axis, through what
    the scorers read from them: each candidate's per-site lnL at the
    root (the pruned tree's) within 5e-3 and at every edge (outside .
    inside) within 2e-2, totals within SEARCH_LNL_TOL.  Single
    partials are no measure: a float32 P(t) of 20 states holds its rare
    transitions to a few per cent, so a partial forced through one moves
    by as much (CPU float32 against float64 on this problem: 1.2e-3 and
    8.7e-3 per site at 20 states)."""
    eng, eng64, params, rv, tree, tree64 = _search_setup(cuda, datatype)
    mask = (np.random.default_rng(1).random((3, rv.n_internal, 2))
            < 0.2).astype(np.float32)
    res = []
    for e, t in ((eng, tree), (eng64, tree64)):
        s = e.system_of(params)
        pm = e._pmats(s[0], s[1], s[2], t.blen)
        pup, clv, sc = e._up_pass(pm, t.child, mask)
        out, sc_out = e._down_pass(pm, t.child, pup, sc, s[3], mask)
        root = torch.stack([e._root_site_loglik(pup[k], sc[k], *s[3:])
                            for k in range(3)])
        edge = torch.log(torch.einsum("kncxp,kncxp->kncp", out, pup)) + \
            sc_out + sc
        edge = torch.logsumexp(edge + torch.log(s[4])[:, None], dim=-2)
        res.append((root.double().cpu(), edge[:, :-1].double().cpu()))
    (root, edge), (root64, edge64) = res
    torch.testing.assert_close(root, root64, rtol=0, atol=5e-3)
    torch.testing.assert_close(edge, edge64, rtol=0, atol=2e-2)
    w = eng64.weights
    torch.testing.assert_close((root * w).sum(-1), (root64 * w).sum(-1),
                               rtol=0, atol=SEARCH_LNL_TOL)


@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_nni_scores_on_the_card(cuda, datatype):
    """Every edge's three configurations: lnL within SEARCH_LNL_TOL and
    the four optimized lengths within 1e-2 relative + 1e-3."""
    from phyml_tpu_torch.search.nni import candidate_arrays, nni_scores

    eng, eng64, params, rv, tree, tree64 = _search_setup(cuda, datatype)
    cand = candidate_arrays(rv)
    lnl, ts = nni_scores(eng, params, tree, cand)
    lnl64, ts64 = nni_scores(eng64, params, tree64, cand)
    np.testing.assert_allclose(lnl, lnl64, rtol=0, atol=SEARCH_LNL_TOL)
    for t, t64 in zip(ts, ts64):
        np.testing.assert_allclose(t, t64, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_spr_scores_on_the_card(cuda, datatype):
    from phyml_tpu_torch.search.spr import (
        prune_candidates, spr_move_arrays, spr_scores_batched,
    )

    eng, eng64, params, rv, tree, tree64 = _search_setup(cuda, datatype)
    block = [v for v in prune_candidates(rv)
             if int(rv.parent[v]) != rv.n_nodes - 1][:6]
    mv = [spr_move_arrays(rv, v) for v in block]
    args = (np.stack([m for m, _ in mv]), np.asarray(block),
            np.stack([va for _, va in mv]))
    lnl = spr_scores_batched(eng, params, tree, *args)[0]
    lnl64 = spr_scores_batched(eng64, params, tree64, *args)[0]
    valid = args[2]
    assert np.array_equal(np.isneginf(lnl), ~valid)
    np.testing.assert_allclose(lnl[valid], lnl64[valid], rtol=0,
                               atol=SEARCH_LNL_TOL)


# ----------------------------------------------------------------------
# the rapid bootstrap's forms: K3 with a slot schedule per batch entry,
# K2/K5 with a tree axis (one launch for a stack of replicate trees)
# ----------------------------------------------------------------------

SHAPES = ["caterpillar", "balanced", "random"]


def _stack_setup(cuda, datatype, n=32, sites=400, seed=9):
    """One simulated alignment and a stack of three trees of different
    shapes on its taxa: (engine, stacked TreeArrays, the trees' own
    TreeArrays, system, stacked P-matrices)."""
    from phyml_tpu_torch.ops.likelihood import TreeArrays

    rng = np.random.default_rng(seed)
    topos = [_tree_of(s, n, rng) for s in SHAPES]
    eng, _, sys_, _ = _simulated_setup(cuda, 4, n, sites, seed, datatype,
                                       topos[2])
    trees = [tree_arrays(t.rooted(), device=cuda) for t in topos]
    stack = TreeArrays(torch.stack([t.child for t in trees]),
                       torch.stack([t.blen for t in trees]))
    pm = eng._pmats(sys_[0], sys_[1], sys_[2], stack.blen)
    return eng, stack, trees, sys_, pm


@pytest.mark.parametrize("shared", [True, False], ids=["one-system",
                                                       "system-each"])
@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_k3_schedule_per_entry_matches_plain_and_single_launches(
        cuda, datatype, shared):
    """A caterpillar, a balanced and a random tree in one K3 launch,
    each entry walking its own schedule (n_slots the largest of theirs):
    against the plain version walking each entry's child table, and
    equal, entry by entry, to one launch per tree on its own schedule
    (the per-entry form moves only base pointers)."""
    eng, stack, trees, sys_, pm = _stack_setup(cuda, datatype)
    child, sched, n_slots = eng._topology(stack.child)
    assert sched.shape == (3, eng.n_internal, 7)
    pi, logw = sys_[3], eng._logw(sys_[4])
    if not shared:
        pi = torch.stack([pi, pi.flip(-1), pi])
        logw = logw.expand(3, eng.C).contiguous()
    n0 = clv.uppass_site_lse.launches_by_trees.get(3, 0)
    got = clv.uppass_site_lse(child, eng.tips, pm, pi, logw, sched=sched,
                              n_slots=n_slots)
    torch.cuda.synchronize()
    assert clv.uppass_site_lse.launches_by_trees[3] == n0 + 1
    ref = clv.uppass_site_lse_plain(child, eng.tips, pm, pi, logw)
    tol = K13_TOL if datatype == "nt" else AA_TOL
    torch.testing.assert_close(got, ref, rtol=0, atol=tol)
    for r, t in enumerate(trees):
        c1, s1, k1 = eng._topology(t.child)
        one = clv.uppass_site_lse(
            c1, eng.tips, pm[r:r + 1], pi[r:r + 1] if not shared
            else pi[None], logw[r:r + 1] if not shared else logw[None],
            sched=s1, n_slots=k1)
        torch.testing.assert_close(got[r], one[0], rtol=0, atol=0)


@pytest.mark.parametrize("datatype", ["nt", "aa"])
@pytest.mark.parametrize("kernel", ["K2", "K5"])
def test_edotp_tree_axis_matches_plain_and_single_launches(cuda, kernel,
                                                           datatype):
    """Three trees of different shapes in one K2/K5 launch (grid.z):
    each tree's per-edge site terms within K2_TOL of the plain version
    (beyond the float32 plain version's own gap, _site_terms_gaps), and
    d and sc_d equal to one launch per tree."""
    eng, stack, trees, sys_, pm = _stack_setup(cuda, datatype)
    lam, V, Vinv, pi, w, _ = sys_
    f = _edotp_kernel(kernel)
    child, _, _ = eng._topology(stack.child)
    n0, b0 = f.launches, f.launches_by_trees.get(3, 0)
    d, sc = f(child, eng.tips, pm, V, Vinv, pi)
    torch.cuda.synchronize()
    assert (f.launches, f.launches_by_trees[3]) == (n0 + 1, b0 + 1)
    assert d.shape == (3, eng.n_nodes, eng.C, eng.ns, eng.P)
    for r, t in enumerate(trees):
        c1, _, _ = eng._topology(t.child)
        d1, sc1 = f(c1, eng.tips, pm[r].contiguous(), V, Vinv, pi)
        torch.testing.assert_close(d[r], d1, rtol=0, atol=0)
        torch.testing.assert_close(sc[r], sc1, rtol=0, atol=0)
        k_err, plain_err = _site_terms_gaps(
            eng, t, sys_, pm[r].contiguous(),
            lambda *a, _d=d[r], _s=sc[r]: (_d, _s))
        assert k_err < plain_err + K2_TOL


def test_stacks_take_one_launch_in_the_engine(cuda):
    """The engine's stacked _loglik_sys (K3, a schedule per tree) and
    edge_dotprods_sys (K2 at this shape, a tree axis): one launch each,
    lnL per tree as the tree's own host lnL (K1) under its weights."""
    eng, stack, trees, sys_, _ = _stack_setup(cuda, "nt")
    rng = np.random.default_rng(4)
    W = torch.as_tensor(rng.integers(0, 3, (3, eng.P)), dtype=torch.float64,
                        device=cuda)
    k3 = clv.uppass_site_lse.launches
    lnl = eng._loglik_sys(sys_, stack, W)
    assert clv.uppass_site_lse.launches == k3 + 1
    for r, t in enumerate(trees):
        one = float(torch.sum(eng._site_logliks_sys(sys_, t).double() * W[r]))
        assert abs(float(lnl[r]) - one) <= K13_TOL * float(W[r].sum())
    k2 = edotp.edge_dotprods.launches
    d, sc_d, aux = eng.edge_dotprods_sys(sys_, stack, W)
    assert edotp.edge_dotprods.launches == k2 + 1
    assert aux["weights"].shape == (3, 1, eng.P)


_BAD_STACK = """
import sys
import numpy as np
import torch
from phyml_tpu_torch.ops import clv, edotp
from phyml_tpu_torch.ops.clv_slots import build_slot_schedule
from phyml_tpu_torch.topology import Topology

rng = np.random.default_rng(0)
n, ns, P, C, R = 20, int(sys.argv[1]), 300, 4, 3
child = np.stack([np.asarray(Topology.random(n, rng).rooted().child,
                             dtype=np.int32) for _ in range(R)])
cuda = torch.device("cuda")
f = lambda *shape: torch.rand(*shape, device=cuda)
pm = f(R, 2 * n - 1, C, ns, ns).contiguous()
try:
    if sys.argv[2] == "K3":
        built = [build_slot_schedule(n, c) for c in child]
        sched = np.stack([s for s, _ in built])
        sched[1, -1, 0] = 2 * n          # tree 1: a node past the tree
        clv.uppass_site_lse(torch.as_tensor(child, device=cuda),
                            f(n, ns, P), pm, f(C, ns), f(C),
                            sched=torch.as_tensor(sched, device=cuda),
                            n_slots=max(k for _, k in built))
    else:
        child[2, 0, 0] = n + 5           # tree 2: out of postorder
        fn = edotp.edge_dotprods if sys.argv[2] == "K2" \\
            else edotp.edge_dotprods_stream
        fn(torch.as_tensor(child, device=cuda), f(n, ns, P), pm,
           f(C, ns, ns), f(C, ns, ns), f(C, ns))
    torch.cuda.synchronize()
except RuntimeError as exc:
    print("raised:", exc)
    sys.exit(0)
sys.exit(1)
"""


@pytest.mark.parametrize("kernel", ["K3", "K2", "K5"])
@pytest.mark.parametrize("ns", [4, 20])
def test_stacked_forms_trap_on_a_bad_tree_in_the_stack(cuda, ns, kernel):
    """Each block checks its own tree's schedule (K3) or child table
    (K2/K5): a bad one in any tree of the stack traps."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _BAD_STACK, str(ns), kernel],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "raised:" in run.stdout


BATCHED_LNL_TOL = 0.1    # lnL of a fit at 40 x 400, card f32 vs CPU f64
#                          (chip_smoke.py's E2E_TOL: the two stop at
#                          slightly different points of a flat optimum)


@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_batched_branch_lengths_on_the_card(cuda, datatype):
    """optimize_branch_lengths_batched on three replicate trees with
    their bootstrap weights: card float32 against CPU float64, lnL per
    replicate within BATCHED_LNL_TOL; the card's evaluations go through
    the stacked forms only."""
    from phyml_tpu_torch.ops.likelihood import TreeArrays
    from phyml_tpu_torch.optim.blen import optimize_branch_lengths_batched
    from phyml_tpu_torch.search.support import replicate_weights

    eng, eng64, params, *_ = _search_setup(cuda, datatype)
    rng = np.random.default_rng(5)
    rvs = [Topology.random(eng.n_otu, rng, mean_blen=0.1).rooted()
           for _ in range(3)]
    W = np.stack([replicate_weights(eng, 7, r, False) for r in range(3)])
    out = {}
    edge = edotp.edge_dotprods if eng.edotp_route == "K2" \
        else edotp.edge_dotprods_stream
    for e, dt, dev in ((eng, torch.float32, cuda),
                       (eng64, torch.float64, "cpu")):
        tas = [tree_arrays(rv, dtype=dt, device=dev) for rv in rvs]
        stack = TreeArrays(torch.stack([t.child for t in tas]),
                           torch.stack([t.blen for t in tas]))
        n3, ne = dict(clv.uppass_site_lse.launches_by_trees), edge.launches
        k3b = dict(clv.uppass_site_lse.launches_by_batch)
        out[dev if dev == "cpu" else "gpu"] = optimize_branch_lengths_batched(
            e, params, stack, torch.as_tensor(W, device=dev))
        if dev != "cpu":
            assert edge.launches_by_trees and edge.launches > ne
            assert sum(clv.uppass_site_lse.launches_by_trees.values()) > \
                sum(n3.values())
            assert clv.uppass_site_lse.launches_by_batch == k3b
    (tg, lg), (tc, lc) = out["gpu"], out["cpu"]
    np.testing.assert_allclose(lg, lc, rtol=0, atol=BATCHED_LNL_TOL)
    assert np.all(np.isfinite(tg.blen.cpu().numpy()))


@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_nni_scores_batched_on_the_card(cuda, datatype):
    """The NNI scorer on a stack of three replicate trees with their
    weights (one pass over the stack): each replicate's lnL within
    SEARCH_LNL_TOL of the CPU's float64 and of the card's single-tree
    scorer."""
    from phyml_tpu_torch.ops.likelihood import TreeArrays
    from phyml_tpu_torch.search.nni import (
        candidate_arrays, nni_scores, nni_scores_batched,
    )
    from phyml_tpu_torch.search.support import replicate_weights

    eng, eng64, params, *_ = _search_setup(cuda, datatype)
    rng = np.random.default_rng(6)
    rvs = [Topology.random(eng.n_otu, rng, mean_blen=0.1).rooted()
           for _ in range(3)]
    W = np.stack([replicate_weights(eng, 8, r, False) for r in range(3)])
    cands = np.stack([candidate_arrays(rv) for rv in rvs])
    lnl = {}
    for tag, e, dt, dev in (("gpu", eng, torch.float32, cuda),
                            ("cpu", eng64, torch.float64, "cpu")):
        tas = [tree_arrays(rv, dtype=dt, device=dev) for rv in rvs]
        stack = TreeArrays(torch.stack([t.child for t in tas]),
                           torch.stack([t.blen for t in tas]))
        w = torch.as_tensor(W, device=dev)
        lnl[tag] = nni_scores_batched(e, params, stack, cands, w)[0]
        if tag == "gpu":
            one = np.stack([nni_scores(e, params, t, c, weights=w_r)[0]
                            for t, c, w_r in zip(tas, cands, w)])
    assert lnl["gpu"].shape == (3, eng.n_otu - 3, 3)
    np.testing.assert_allclose(lnl["gpu"], lnl["cpu"], rtol=0,
                               atol=SEARCH_LNL_TOL)
    np.testing.assert_allclose(lnl["gpu"], one, rtol=0, atol=SEARCH_LNL_TOL)


@pytest.mark.parametrize("flags", [
    ["--pars_start", "--print_trace", "--json_trace", "-b", "-5"],
    ["--constraint_file", "CONSTRAINT", "-b", "3", "--rapid_boot"],
    ["-b", "2", "--tbe", "--bayesian_bootstrap"]],
    ids=["pars-trace-abayes", "constraint-rapid", "boot-tbe-bayes"])
def test_cli_support_and_start_flags_on_the_card(cuda, flags, tmp_path):
    """The CLI's start-tree, trace and support flags run on the card by
    default (no --platform): a 12 x 300 DNA problem, the tree file with
    a support on every internal edge, the trace files written."""
    from phyml_tpu_torch import cli
    from phyml_tpu_torch.io.newick import parse_newick

    rng = np.random.default_rng(3)
    names = [f"t{i}" for i in range(12)]
    aln = tmp_path / "aln.phy"
    aln.write_text(f" 12 300\n" + "".join(
        f"{nm:<10s}  {''.join(rng.choice(list('ACGT'), 300))}\n"
        for nm in names))
    constraint = tmp_path / "c.nwk"
    constraint.write_text("((t0,t1,t2),(t3,t4),t5,t6,t7,t8,t9,t10,t11);\n")
    argv = ["-i", str(aln), "-m", "GTR", "-c", "4", "--r_seed", "2",
            "--quiet"] + [str(constraint) if f == "CONSTRAINT" else f
                          for f in flags]
    assert cli.main(argv) == 0
    root = parse_newick((tmp_path / "aln.phy_phyml_tree.txt").read_text())
    labels = []

    def walk(node):
        for c in node.children:
            if c.children:
                labels.append(c.support or c.name)
                walk(c)

    walk(root)
    assert len(labels) == 9 and all(labels)
    if "--print_trace" in flags:
        # one newick line and one JSON snapshot per improvement
        lines = (tmp_path / "aln.phy_phyml_trace.txt").read_text().split()
        if lines:
            import json
            snaps = json.loads(
                (tmp_path / "aln.phy_phyml_trace.json").read_text())
            assert len(snaps) == len(lines)
