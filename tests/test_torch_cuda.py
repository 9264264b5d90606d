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
from phyml_tpu_torch.ops import _build, clv, clv_slots, edotp
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
from phyml_tpu_torch.topology import Topology
from phyml_tpu_torch.utils import trace

pytestmark = pytest.mark.gpu

K13_TOL = 5e-4
K2_TOL = 2e-3
# K5's big body past the ladder, held as chip_smoke.py holds K2/K5: its
# per-edge site terms against the float32 plain version's (EDGE_TOL)
EDGE_TOL = 2e-3
AA_TOL = 2e-3


# the kernel each wrapper launches, as the port's counters name it
KERNEL = {"uppass_site_lse_slots": "K1", "edge_dotprods": "K2",
          "uppass_site_lse": "K3", "uppass_site_lse_slots_stream": "K4",
          "edge_dotprods_stream": "K5"}


def launches(f, by=""):
    """The port's count of launches of wrapper f's kernel (utils/
    trace.py), or of those of one batch size ("batch.<B>") or stack of
    trees ("trees.<R>")."""
    name = "launch." + KERNEL[f.__name__] + ("." + by if by else "")
    return trace.snapshot().get(name, 0)


def launches_by(f, kind):
    """{B or R: launches} of wrapper f's kernel by batch size (kind
    "batch") or by the size of a stack of trees ("trees")."""
    head = f"launch.{KERNEL[f.__name__]}.{kind}."
    return {int(k[len(head):]): v for k, v in trace.snapshot().items()
            if k.startswith(head)}


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


def _site_terms_gaps(eng, tree, sys_, pm, kernel, tips=None):
    """Per-edge site terms on the free edges through an edge-dot-product
    kernel and through K2's plain version in float32, each against the
    plain version in float64 (on the engine's tips, or `tips`): returns
    the two largest gaps.  At 20 states the float32 site terms of random
    sequences are ill conditioned (the eigen-basis sum cancels), so the
    kernel is held to the float32 plain version's own accuracy plus
    K2_TOL."""
    tips = eng.tips if tips is None else tips
    lam, V, Vinv, pi, w, _ = sys_
    child, _, _ = eng._topology(tree.child)
    aux = {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
           else v for k, v in eng._aux(sys_, None).items()}
    free = _free_edges(eng, tree)
    sites = []
    for f, dt in ((kernel, torch.float32),
                  (edotp.edge_dotprods_plain, torch.float32),
                  (edotp.edge_dotprods_plain, torch.float64)):
        d, sc = f(child, *(x.to(dt) for x in (tips, pm, V, Vinv, pi)))
        sites.append(eng.edge_site_terms(d.double(), sc.double(), aux,
                                         tree.blen.double())[0][free])
    return (float((sites[0] - sites[2]).abs().max()),
            float((sites[1] - sites[2]).abs().max()))


def _raw_edge_gap(eng, tree, sys_, pm, kernel, tips=None):
    """The largest gap between the per-edge site terms (free edges) of an
    edge-dot-product kernel and of K2's plain version, both float32 on
    the card, on the engine's tips or `tips`."""
    tips = eng.tips if tips is None else tips
    lam, V, Vinv, pi, w, _ = sys_
    child, _, _ = eng._topology(tree.child)
    aux = eng._aux(sys_, None)
    free = _free_edges(eng, tree)
    site = [eng.edge_site_terms(*f(child, tips, pm, V, Vinv, pi), aux,
                                tree.blen)[0][free]
            for f in (kernel, edotp.edge_dotprods_plain)]
    return float((site[0] - site[1]).abs().max())


@pytest.mark.parametrize("datatype,C", [("nt", 4), ("aa", 4), ("aa", 1)])
def test_streamed_kernels_match_plain(cuda, datatype, C):
    """K4 against K1's plain version and K5 against K2's, at a ragged
    pattern count."""
    eng, tree, sys_, pm = _setup(cuda, C, seed=2, datatype=datatype)
    assert eng.P % clv_slots.TILE != 0
    tol = K13_TOL if datatype == "nt" else AA_TOL
    _, sched, _ = eng._topology(tree.child)
    pi, logw = sys_[3], eng._logw(sys_[4])
    n0 = launches(clv_slots.uppass_site_lse_slots_stream)
    k4 = clv_slots.uppass_site_lse_slots_stream(
        sched, eng.tips, pm, pi, logw, n_slots=eng.slot_count)
    ref = clv_slots.uppass_site_lse_slots_plain(
        sched, eng.tips, pm, pi, logw, n_slots=eng.slot_count)
    torch.cuda.synchronize()
    assert launches(clv_slots.uppass_site_lse_slots_stream) == n0 + 1
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
    n4 = launches(clv_slots.uppass_site_lse_slots_stream)
    n5 = launches(edotp.edge_dotprods_stream)
    lnl = float(eng.loglik(params, tree))
    eng.edge_dotprods_sys(eng.system_of(params), tree)
    torch.cuda.synchronize()
    assert launches(clv_slots.uppass_site_lse_slots_stream) == n4 + 1
    assert launches(edotp.edge_dotprods_stream) == n5 + 1
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
    n0 = launches(clv.uppass_site_lse)
    got = clv.uppass_site_lse(child, eng.tips, pmb, pib, lwb, sched=sched,
                              n_slots=n_slots)
    ref = clv.uppass_site_lse_plain(child, eng.tips, pmb, pib, lwb)
    torch.cuda.synchronize()
    assert launches(clv.uppass_site_lse) == n0 + 1
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
@pytest.mark.parametrize("ns", [4, 20, 80])
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
    n0 = launches(f)
    k_err, plain_err = _site_terms_gaps(eng, tree, sys_, pm, f)
    torch.cuda.synchronize()
    assert launches(f) == n0 + 1
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
@pytest.mark.parametrize("ns", [4, 20, 80])
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
        n0 = launches(f)
        got = f(sched, tips, pm, pi, logw, n_slots=n_slots)
        torch.cuda.synchronize()
        assert launches(f) == n0 + 1
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
    n4, n3 = launches(f4), launches(k3, "batch.1")
    got = eng._site_logliks_sys(sys_, tree)
    torch.cuda.synchronize()
    ran = {(1, 0): "K4", (0, 1): "K3"}[
        (launches(f4) - n4, launches(k3, "batch.1") - n3)]
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
    n_slot, n_k3 = launches(f), launches(clv.uppass_site_lse)
    one = eng._loglik_sys(sys_, tree)
    torch.cuda.synchronize()
    assert (launches(f), launches(clv.uppass_site_lse)) == (n_slot + 1, n_k3)
    two = eng._loglik_sys(tuple(torch.stack([x, x]) for x in sys_), tree)
    torch.cuda.synchronize()
    assert (launches(f), launches(clv.uppass_site_lse)) == (n_slot + 1,
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
@pytest.mark.parametrize("ns", [4, 20, 80])
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
    n0 = launches(clv.uppass_site_lse, "trees.3")
    got = clv.uppass_site_lse(child, eng.tips, pm, pi, logw, sched=sched,
                              n_slots=n_slots)
    torch.cuda.synchronize()
    assert launches(clv.uppass_site_lse, "trees.3") == n0 + 1
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
    n0, b0 = launches(f), launches(f, "trees.3")
    d, sc = f(child, eng.tips, pm, V, Vinv, pi)
    torch.cuda.synchronize()
    assert (launches(f), launches(f, "trees.3")) == (n0 + 1, b0 + 1)
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
    k3 = launches(clv.uppass_site_lse)
    lnl = eng._loglik_sys(sys_, stack, W)
    assert launches(clv.uppass_site_lse) == k3 + 1
    for r, t in enumerate(trees):
        one = float(torch.sum(eng._site_logliks_sys(sys_, t).double() * W[r]))
        assert abs(float(lnl[r]) - one) <= K13_TOL * float(W[r].sum())
    k2 = launches(edotp.edge_dotprods)
    d, sc_d, aux = eng.edge_dotprods_sys(sys_, stack, W)
    assert launches(edotp.edge_dotprods) == k2 + 1
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
@pytest.mark.parametrize("ns", [4, 20, 80])
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
        n3, ne = launches_by(clv.uppass_site_lse, "trees"), launches(edge)
        k3b = launches_by(clv.uppass_site_lse, "batch")
        out[dev if dev == "cpu" else "gpu"] = optimize_branch_lengths_batched(
            e, params, stack, torch.as_tensor(W, device=dev))
        if dev != "cpu":
            assert launches_by(edge, "trees") and launches(edge) > ne
            assert sum(launches_by(clv.uppass_site_lse, "trees").values()) > \
                sum(n3.values())
            assert launches_by(clv.uppass_site_lse, "batch") == k3b
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


# --- per-class systems: LG4X and a two-matrix DNA mixture -----------------

def _mixture_model(kind):
    """LG4X, or a DNA mixture of an HKY85 class (kappa 4) and a GTR
    class, each with its own pi (as an XML <mixtureelem> list builds
    one), both with FreeRate rates and weights."""
    from phyml_tpu_torch.models.substitution import lg4x_model

    if kind == "lg4x":
        return lg4x_model()
    hky = np.ones((4, 4)) - np.eye(4)
    hky[0, 2] = hky[2, 0] = hky[1, 3] = hky[3, 1] = 4.0
    gtr = np.zeros((4, 4))
    gtr[np.triu_indices(4, k=1)] = [1.2, 3.0, 0.8, 1.1, 4.0, 1.0]
    comps = [(hky, np.array([0.3, 0.2, 0.3, 0.2])),
             (gtr + gtr.T, np.array([0.2, 0.3, 0.25, 0.25]))]
    return SubstModel(datatype="nt", name="XMLMIX", n_classes=2,
                      freerate=True, freqs_mode="model", components=comps)


def _mixture_setup(cuda, kind, n=40, sites=301, seed=4):
    """Engine, tree, system and P-matrices at the mixture's own system
    on sequences simulated under it; the raw rates and weights spread
    the classes (the classes' Q, V, V^-1 and pi all differ)."""
    from phyml_tpu_torch.models.eigen import pmat

    rng = np.random.default_rng(seed)
    model = _mixture_model(kind)
    C, ns = model.n_classes, model.ns
    params = model.init_params()
    params["class_rates_raw"] = torch.as_tensor(rng.normal(0.0, 1.0, C))
    params["class_weights_raw"] = torch.as_tensor(rng.normal(0.0, 0.5, C))
    rv = Topology.random(n, rng, mean_blen=0.15).rooted()
    lam, V, Vinv, pi, w, _ = model.class_system(params)
    t = torch.as_tensor(rv.node_blen)[:, None].expand(rv.n_nodes, C)
    P = np.clip(pmat(lam, V, Vinv, t).numpy(), 0.0, None)
    P /= P.sum(-1, keepdims=True)
    cls = rng.choice(C, size=sites, p=w.numpy())
    states = np.zeros((rv.n_nodes, sites), dtype=np.int64)
    for c in range(C):
        at = cls == c
        states[-1, at] = rng.choice(ns, size=int(at.sum()), p=pi.numpy()[c])
    for i in range(rv.n_internal - 1, -1, -1):       # preorder
        for c in rv.child[i]:
            cum = P[int(c), cls, states[n + i], :].cumsum(axis=1)
            r = rng.random(sites)[:, None]
            states[int(c)] = np.clip((r > cum).sum(axis=1), 0, ns - 1)
    enc = np.zeros((n, sites, ns), dtype=np.float32)
    enc[np.arange(n)[:, None], np.arange(sites)[None], states[:n]] = 1.0
    aln = compact(enc, [f"t{i}" for i in range(n)], model.datatype)
    eng = LikelihoodEngine(aln, model, dtype=torch.float32, device=cuda)
    tree = tree_arrays(rv, device=cuda)
    sys_ = eng.system_of(params)
    assert float((sys_[3][1] - sys_[3][0]).abs().max()) > 1e-2
    return eng, tree, sys_, eng._pmats(sys_[0], sys_[1], sys_[2],
                                       tree.blen), params


@pytest.mark.parametrize("kind, kernel", [
    ("dna_mix", "K1"), ("dna_mix", "K4"), ("lg4x", "K4")])
def test_slot_kernels_at_per_class_systems(cuda, kind, kernel):
    eng, tree, sys_, pm, _ = _mixture_setup(cuda, kind)
    _slot_check(eng, tree, sys_, pm, kernel)


@pytest.mark.parametrize("kind, kernel", [
    ("dna_mix", "K2"), ("dna_mix", "K5"), ("lg4x", "K5")])
def test_edge_kernels_at_per_class_systems(cuda, kind, kernel):
    eng, tree, sys_, pm, _ = _mixture_setup(cuda, kind)
    err, plain_err = _site_terms_gaps(eng, tree, sys_, pm,
                                      _edotp_kernel(kernel))
    assert err < plain_err + K2_TOL


@pytest.mark.parametrize("kind", ["dna_mix", "lg4x"])
def test_k3_at_the_line_search_grid_of_a_mixture(cuda, kind):
    """K3 on the first zoom level of optimize_scalars's grid (every
    FreeRate slot swept over its whole bracket, rate logits to +-7 and
    weight logits to +-9: classes of weight ~e^-9 and rates ~e^+-7
    before normalization), one launch, against its plain version."""
    from phyml_tpu_torch.optim.round import _batched_params, free_scalar_slots

    eng, tree, sys_, pm, params = _mixture_setup(cuda, kind)
    slots = free_scalar_slots(eng.model, params)
    cur = [float(params[nm][i]) for nm, i, *_ in slots]
    S = []
    for j, (_, _, _, lo, hi) in enumerate(slots):
        for x in list(np.linspace(lo, hi, 12)) + [cur[j]]:
            row = list(cur)
            row[j] = x
            S.append(row)
    sysb = eng._system(_batched_params(params, slots, np.asarray(S)))
    pmb = eng._pmats(sysb[0], sysb[1], sysb[2], tree.blen)
    child, sched, n_slots = eng._topology(tree.child)
    logw = eng._logw(sysb[4])
    n0 = launches(clv.uppass_site_lse)
    got = clv.uppass_site_lse(child, eng.tips, pmb, sysb[3], logw,
                              sched=sched, n_slots=n_slots)
    ref = clv.uppass_site_lse_plain(child, eng.tips, pmb, sysb[3], logw)
    torch.cuda.synchronize()
    assert launches(clv.uppass_site_lse) == n0 + 1
    assert got.shape == (len(S), eng.P) and bool(torch.isfinite(got).all())
    tol = K13_TOL if eng.ns == 4 else AA_TOL
    assert float((got - ref).abs().max()) < tol


def test_lg4x_fit_card_against_cpu(cuda, tmp_path):
    """`-d aa -m LG4X -u tree -o lr` on a 16 x 300 problem simulated
    under LG4X: the card's float32 fit within BATCHED_LNL_TOL of the
    CPU's float64 one; the card's passes went through K4, K5 and K3."""
    from phyml_tpu_torch import cli

    eng, tree, *_ = _mixture_setup(cuda, "lg4x", n=16, sites=300)
    names = eng.aln.names
    rv_topo = Topology.random(16, np.random.default_rng(4), mean_blen=0.15)
    (tmp_path / "tree.nwk").write_text(rv_topo.to_newick(names) + "\n")
    seqs = ["".join("ARNDCQEGHILKMFPSTWYV"[s] for s in
                    eng.aln.partials[i][eng.aln.site_to_pattern].argmax(-1))
            for i in range(16)]
    (tmp_path / "aln.phy").write_text(" 16 300\n" + "".join(
        f"{nm:<10s}  {sq}\n" for nm, sq in zip(names, seqs)))
    lnl = {}
    for platform in ("cpu", "gpu"):
        n4, n5 = (launches(clv_slots.uppass_site_lse_slots_stream),
                  launches(edotp.edge_dotprods_stream))
        n3 = launches(clv.uppass_site_lse)
        assert cli.main(["-i", str(tmp_path / "aln.phy"), "-u",
                         str(tmp_path / "tree.nwk"), "-d", "aa", "-m",
                         "LG4X", "-o", "lr", "-b", "0", "--platform",
                         platform, "--quiet"]) == 0
        text = (tmp_path / "aln.phy_phyml_stats.txt").read_text()
        lnl[platform] = float(text.split(". Log-likelihood:")[1].split()[0])
        if platform == "gpu":
            assert launches(clv_slots.uppass_site_lse_slots_stream) > n4
            assert launches(edotp.edge_dotprods_stream) > n5
            assert launches(clv.uppass_site_lse) > n3
    assert abs(lnl["gpu"] - lnl["cpu"]) <= BATCHED_LNL_TOL, lnl


def test_two_partition_xml_card_against_cpu(cuda, tmp_path):
    """A two-<partitionelem> XML run (GTR+G4 and HKY85+G4 halves of a
    16 x 400 problem, BioNJ start, the NNI search): the same trees and
    the combined lnL within BATCHED_LNL_TOL, card float32 against CPU
    float64."""
    from phyml_tpu_torch.io.xmlcfg import run_xml

    rng = np.random.default_rng(6)
    topo = Topology.random(16, rng, mean_blen=0.1)
    eng, *_ = _simulated_setup(cuda, 4, 16, 400, 6, "nt", topo)
    names = eng.aln.names
    seqs = ["".join("ACGT"[s] for s in
                    eng.aln.partials[i][eng.aln.site_to_pattern].argmax(-1))
            for i in range(16)]
    for k, (lo, hi) in enumerate(((0, 200), (200, 400))):
        (tmp_path / f"g{k}.phy").write_text(f" 16 {hi - lo}\n" + "".join(
            f"{nm:<10s}  {sq[lo:hi]}\n" for nm, sq in zip(names, seqs)))
    rates = ",".join(f"R{i}" for i in range(1, 5))
    xml = f"""<phyml run.id="x" output.file="joint">
  <topology><instance id="T1" init.tree="bionj" search="nni"/></topology>
  <ratematrices><instance id="M1" model="GTR"/>
    <instance id="M2" model="HKY85"/></ratematrices>
  <siterates>{"".join(f'<instance id="R{i}" init.value="1.0"/>'
                      for i in range(1, 5))}
    <weights family="gamma" alpha="1.0"/></siterates>
  <equfreqs><instance id="F1" freqs="empirical"/></equfreqs>
  <branchlengths><instance id="L1"/><instance id="L2"/></branchlengths>
  {"".join(f'''<partitionelem file.name="g{k}.phy" data.type="nt"
    interleaved="no"><mixtureelem list="T1,T1,T1,T1"/>
    <mixtureelem list="{m},{m},{m},{m}"/>
    <mixtureelem list="F1,F1,F1,F1"/><mixtureelem list="{rates}"/>
    <mixtureelem list="{b},{b},{b},{b}"/></partitionelem>'''
           for k, (m, b) in enumerate((("M1", "L1"), ("M2", "L2"))))}
</phyml>"""
    (tmp_path / "run.xml").write_text(xml)
    out = {}
    for platform in ("cpu", "gpu"):
        n1 = launches(clv_slots.uppass_site_lse_slots)
        assert run_xml(str(tmp_path / "run.xml"), quiet=True,
                       device=platform if platform == "cpu" else cuda) == 0
        stats = (tmp_path / "joint_part1_phyml_stats.txt").read_text()
        combined = float(stats.split("partitions):")[1].split()[0])
        trees = [Topology.from_newick(
            (tmp_path / f"joint_part{k}_phyml_tree.txt").read_text(), names)
            for k in (1, 2)]
        out[platform] = (combined, trees)
        if platform == "gpu":
            assert launches(clv_slots.uppass_site_lse_slots) > n1
    (lc, tc), (lg, tg) = out["cpu"], out["gpu"]
    assert abs(lg - lc) <= BATCHED_LNL_TOL, (lg, lc)
    assert all(a.rf_distance(b) == 0 for a, b in zip(tg, tc))
    assert tg[0].rf_distance(tg[1]) == 0


# ----------------------------------------------------------------------
# the dating chain (phytime) on the card
# ----------------------------------------------------------------------
CHAIN_F64_TOL = 1e-2  # chain lnL at 24 x 300, card f32 vs CPU f64 (the
#                       float32 pass's own rounding, ~1e-7 per site)


@pytest.mark.parametrize("datatype, kernel, n", [
    ("nt", "K1", 40), ("nt", "K4", 40), ("aa", "K4", 40), ("aa", "K1", 6)])
@pytest.mark.parametrize("sigma", [0.05, 0.8])
def test_slot_kernels_at_mgf_pmatrices(cuda, datatype, kernel, n, sigma):
    """K1 and K4 fed the Guindon clock's Gamma-MGF P-matrices
    (models/eigen.py:pmat_mgf_gamma) against K1's plain version."""
    from phyml_tpu_torch.models.eigen import mgf_rates

    rng = np.random.default_rng(3)
    eng, tree, sys_, _ = _simulated_setup(
        cuda, 4, n, 301, 3, datatype, Topology.random(n, rng, mean_blen=0.2))
    pm = eng._pmats(mgf_rates(sys_[0], sigma), sys_[1], sys_[2], tree.blen)
    _slot_check(eng, tree, sys_, pm, kernel)


def _chain_setup(device, n=24, sites=300, rate_kind="lognormal"):
    """A dating chain on a 24 x 300 DNA problem simulated down a
    coalescent chronogram under GTR+G4, float32 on the card, float64 on
    the CPU: (MCMC, its TimeTree)."""
    from phyml_tpu_torch.bayes.chrono import TimeTree
    from phyml_tpu_torch.bayes.mcmc import MCMC, MCMCSettings
    from phyml_tpu_torch.bayes.rates import RateModel
    from phyml_tpu_torch.bayes.times import Calibration, TimePrior

    rng = np.random.default_rng(12)
    tt = TimeTree.coalescent(n, rng, theta=0.3)
    eng, *_ = _simulated_setup(device if device != "cpu" else
                               torch.device("cpu"), 4, n, sites, 12, "nt",
                               tt.to_topology())
    if device == "cpu":
        eng = LikelihoodEngine(eng.aln, eng.model, dtype=torch.float64,
                               device="cpu")
    tt.names = list(eng.aln.names)
    params = eng.model.init_params(eng.aln.obs_state_freqs)
    params["alpha"] = torch.tensor(0.5, dtype=torch.float64)
    h = tt.heights[tt.root]
    prior = TimePrior(kind="birthdeath", calibrations=(Calibration(
        taxa=tuple(tt.names), lower=0.5 * h, upper=3.0 * h),))
    return MCMC(eng, eng.model, params, tt, RateModel(kind=rate_kind), prior,
                MCMCSettings(n_iter=500, burnin=250, batch=250, seed=2),
                sample_topology=True, topo_moves_per_batch=24), tt


@pytest.mark.parametrize("rate_kind", ["lognormal", "guindon"])
def test_dating_chain_on_the_card(cuda, rate_kind):
    """500 iterations and 48 topology proposals on the card: MALA's
    weight is 0, the cached lnL equals a recompute (and a recompute
    twice is bit-identical: K1 is deterministic), every posterior lnL
    went through K1 and none through K3."""
    mcmc, _ = _chain_setup(cuda, rate_kind=rate_kind)
    assert mcmc.move_w[-1] == 0.0
    n1 = launches(clv_slots.uppass_site_lse_slots)
    n3 = launches(clv.uppass_site_lse)
    st, trace, _ = mcmc.run()
    torch.cuda.synchronize()
    assert launches(clv.uppass_site_lse) == n3
    assert launches(clv_slots.uppass_site_lse_slots) - n1 > 100
    again = mcmc._lnL(st)
    assert float(again) == float(mcmc._lnL(st))
    assert abs(float(st.lnL) - float(again)) <= 1e-6
    assert np.isfinite(trace).all() and mcmc.topo_tries == 48


def test_dating_chain_lnl_card_against_cpu(cuda):
    """The card's lnL and log prior at a chain state the card reached,
    recomputed by a CPU float64 chain on the same problem."""
    from phyml_tpu_torch.interop import chain_state_from_numpy

    card, _ = _chain_setup(cuda)
    cpu, _ = _chain_setup("cpu")
    st, _, _ = card.run()
    st_cpu = chain_state_from_numpy({
        k: ({k2: v2.numpy() for k2, v2 in v.items()}
            if isinstance(v, dict) else v.numpy())
        for k, v in st._asdict().items()})
    assert abs(float(card._lnL(st)) - float(cpu._lnL(st_cpu))) \
        <= CHAIN_F64_TOL
    assert float(card._log_prior(st)) == float(cpu._log_prior(st_cpu))


# ----------------------------------------------------------------------
# the state-count ladder: every kernel at every rung, and between rungs
# through the wrappers' padding
# ----------------------------------------------------------------------
def _generic_setup(cuda, ns, C, n, sites=301, seed=21):
    """A float32 engine on random ns-state data under the generic model
    with random state frequencies (a non-uniform pi makes the
    P-matrices' rows differ), its random tree and P-matrices."""
    rng = np.random.default_rng(seed + ns)
    enc = np.zeros((n, sites, ns), dtype=np.float32)
    enc[np.arange(n)[:, None], np.arange(sites)[None],
        rng.integers(0, ns, size=(n, sites))] = 1.0
    aln = compact(enc, [f"t{i}" for i in range(n)], "generic")
    model = SubstModel(datatype="generic", generic_ns=ns, n_classes=C)
    params = model.init_params()
    params["freqs_const"] = torch.as_tensor(rng.dirichlet(np.ones(ns)))
    params["alpha"] = torch.tensor(0.5, dtype=torch.float64)
    eng = LikelihoodEngine(aln, model, dtype=torch.float32, device=cuda)
    tree = tree_arrays(Topology.random(n, rng, mean_blen=0.2).rooted(),
                       device=cuda)
    sys_ = eng.system_of(params)
    return eng, tree, sys_, eng._pmats(sys_[0], sys_[1], sys_[2], tree.blen)


LADDER_CASES = sorted(set(_build.LADDER) | {2, 7, 36})


@pytest.mark.parametrize("ns", LADDER_CASES)
def test_every_kernel_at_every_rung(cuda, ns):
    """K1-K5 against their plain versions at every rung of the ladder and
    at 2, 7 and 36 states, which the wrappers pad to 4, 8 and (past the
    top rung, the big bodies) 48: 5e-4
    per site below 20 states, 2e-3 from 20 up (and for K2/K5's edge
    terms, beyond the float32 plain version's own gap)."""
    tol = K13_TOL if ns < 20 else AA_TOL
    # K1 on a 4-taxon tree (its whole-tree matrices fit a block at every
    # rung), the others on 12 taxa
    for n, kernels in ((4, ("K1",)), (12, ("K3", "K4", "K2", "K5"))):
        eng, tree, sys_, pm = _generic_setup(cuda, ns, 4, n)
        assert eng.ns == ns and eng.tips.shape[1] == ns
        child, sched, n_slots = eng._topology(tree.child)
        pi, logw = sys_[3], eng._logw(sys_[4])
        ref = clv_slots.uppass_site_lse_slots_plain(
            sched, eng.tips, pm, pi, logw, n_slots=n_slots)
        for name in kernels:
            if name in ("K1", "K4"):
                got = _slot_kernel(name)(sched, eng.slot_tips, pm, pi, logw,
                                         n_slots=n_slots)
            elif name == "K3":
                B = 3
                got = clv.uppass_site_lse(
                    child, eng.tips, torch.stack([pm] * B),
                    torch.stack([pi] * B), torch.stack([logw] * B),
                    sched=sched, n_slots=n_slots)
                torch.cuda.synchronize()
                assert float((got - ref[None]).abs().max()) < tol, name
                continue
            else:
                err, plain = _site_terms_gaps(eng, tree, sys_, pm,
                                              _edotp_kernel(name))
                assert err < plain + K2_TOL, (name, err, plain)
                continue
            torch.cuda.synchronize()
            assert got.shape == (eng.P,) and bool(torch.isfinite(got).all())
            assert float((got - ref).abs().max()) < tol, name


def test_past_the_ladder_runs_the_big_bodies_on_the_card(cuda):
    """More than 64 states are no longer refused: an engine at 80 states
    (amino-acid covarion at four hidden classes) builds on the card, runs
    its lnL through the big bodies (K4, its host lnL) and lands within
    0.5 of the CPU float64 lnL on the same data, tree and parameters."""
    rng = np.random.default_rng(0)
    n, sites = 12, 200
    enc = np.zeros((n, sites, 20), dtype=np.float32)
    enc[np.arange(n)[:, None], np.arange(sites)[None],
        rng.integers(0, 20, size=(n, sites))] = 1.0
    aln = compact(enc, [f"t{i}" for i in range(n)], "aa")
    model = SubstModel(datatype="aa", name="LG", n_classes=4, covarion=True,
                       n_hidden=4)
    assert model.ns == 80
    params = model.init_params(aln.obs_state_freqs)
    rv = Topology.random(n, rng, mean_blen=0.2).rooted()
    eng = LikelihoodEngine(aln, model, dtype=torch.float32, device=cuda)
    assert (eng.lnl_route, eng.edotp_route) == ("K4", "K5")
    n0 = launches(clv_slots.uppass_site_lse_slots_stream)
    card = float(eng.loglik(params, tree_arrays(rv, device=cuda)))
    assert launches(clv_slots.uppass_site_lse_slots_stream) == n0 + 1
    eng64 = LikelihoodEngine(aln, model, dtype=torch.float64, device="cpu")
    cpu = float(eng64.loglik(params, tree_arrays(rv, dtype=torch.float64,
                                                 device="cpu")))
    assert abs(card - cpu) < 0.5, (card, cpu)


# ----------------------------------------------------------------------
# past the ladder: the big bodies (csrc/big.cuh, big_ffma.cuh) at a
# run-time state count padded to a multiple of 16
# ----------------------------------------------------------------------
# 40, 48, 60 and 64, once the ladder's top rungs, run at 48 and 64
# (K5 with V and V^-1 resident); 67, 72 and 80 run at 80, where K3/K4
# take the 32-pattern tile at 7 slots, 96 the next width; 48, 80, 112
# (100) and 144 end in a half pair of K5's 32-state tiles and a 16-state
# chunk of K3/K4's ring, 64, 96, 128 and 160 do not
BIG_CASES = [40, 48, 60, 64, 67, 72, 80, 96, 100, 128, 144, 160]


def _big_tips_at(eng, state, cols):
    """The engine's tips with every taxon at `state` in the pattern
    columns `cols`: such a column's maximum lies at that state at every
    step (short branches keep the diagonal of P(t) largest)."""
    tips = eng.tips.clone()
    tips[:, :, cols] = 0.0
    tips[:, state, cols] = 1.0
    return tips


@pytest.mark.parametrize("ns", BIG_CASES)
def test_big_bodies_match_plain(cuda, ns):
    """K4 and K1's entry, K3 (a batch of three systems, and a stack of
    three trees with a schedule each), K5 and K2's entry (one tree, and
    a grid.z stack of three) past the ladder against their plain
    versions at C = 4: 2e-3 per site for K1/K3/K4, the float32 plain
    version's own gap plus 2e-3 for K2/K5's edge terms, and their raw
    gap to the float32 plain version's within EDGE_TOL.  A third of the
    columns carry every taxon at the last real state, in the last
    16-state panel (beside the padded states at 40, 60, 67, 72 and
    100), so their maximum lies there at every step: K5's raw sc_d,
    whose log2 scales come from each warp's column maxima over every
    state, must equal the plain version's (up to an exponent flipped by
    rounding)."""
    eng, tree, sys_, pm = _generic_setup(cuda, ns, 4, 12, sites=150)
    NS = _build.rung(ns)
    assert NS % 16 == 0 and NS >= ns and _build.is_big(NS)
    assert (eng.lnl_route, eng.edotp_route) == ("K4", "K5")
    tips = _big_tips_at(eng, ns - 1, slice(0, None, 3))
    child, sched, n_slots = eng._topology(tree.child)
    lam, V, Vinv, pi, w, _ = sys_
    logw = eng._logw(w)
    ref = clv_slots.uppass_site_lse_slots_plain(sched, tips, pm, pi, logw,
                                                n_slots=n_slots)
    for name in ("K1", "K4"):
        got = _slot_kernel(name)(sched, tips, pm, pi, logw, n_slots=n_slots)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()), name
        assert float((got - ref).abs().max()) < AA_TOL, name
    B = 3
    got = clv.uppass_site_lse(child, tips, torch.stack([pm] * B),
                              torch.stack([pi] * B), torch.stack([logw] * B),
                              sched=sched, n_slots=n_slots)
    torch.cuda.synchronize()
    assert float((got - ref[None]).abs().max()) < AA_TOL
    # a stack of trees, a schedule each, one system
    rng = np.random.default_rng(ns)
    rvs = [Topology.random(12, rng, mean_blen=0.2).rooted()
           for _ in range(B)]
    stack = [tree_arrays(rv, device=cuda) for rv in rvs]
    childs = torch.stack([t.child for t in stack])
    blens = torch.stack([t.blen for t in stack])
    sch, sch_slots = eng._topology(childs)[1:]
    pms = eng._pmats(lam, V, Vinv, blens)
    got = clv.uppass_site_lse(eng._topology(childs)[0], tips, pms, pi, logw,
                              sched=sch, n_slots=sch_slots)
    want = clv.uppass_site_lse_plain(childs, tips, pms, pi, logw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) < AA_TOL
    # the edge dot products, through the per-edge site terms
    for name in ("K2", "K5"):
        err, plain = _site_terms_gaps(eng, tree, sys_, pm, _edotp_kernel(name))
        assert err < plain + K2_TOL, (name, err, plain)
        raw = _raw_edge_gap(eng, tree, sys_, pm, _edotp_kernel(name), tips)
        assert raw <= EDGE_TOL, (name, raw)
    d_k, sc_k = edotp.edge_dotprods_stream(child, tips, pm, V, Vinv, pi)
    d_p, sc_p = edotp.edge_dotprods_plain(child, tips, pm, V, Vinv, pi)
    torch.cuda.synchronize()
    assert d_k.shape == d_p.shape == (eng.n_nodes, 4, ns, eng.P)
    free = _free_edges(eng, tree)
    same = (sc_k[free] - sc_p[free]).abs() < 1e-3
    assert float(same.double().mean()) > 0.99
    # grid.z: a stack of trees in one launch, each against one launch
    n1 = launches(edotp.edge_dotprods_stream)
    d_s, sc_s = edotp.edge_dotprods_stream(eng._topology(childs)[0], tips,
                                           pms, V, Vinv, pi)
    assert launches(edotp.edge_dotprods_stream) == n1 + 1
    for r in range(B):
        d_r, sc_r = edotp.edge_dotprods_stream(
            eng._topology(childs[r])[0], tips, pms[r], V, Vinv, pi)
        torch.cuda.synchronize()
        assert torch.equal(d_s[r], d_r) and torch.equal(sc_s[r], sc_r)


def _big_checks(eng, tree, sys_, pm, tips, tol, ref=None):
    """K4 and K3 (B = 2) on `tips` against the plain version (float32 on
    the card, or `ref`) within tol per site, and K5's edge terms within
    the float32 plain version's own gap plus K2_TOL and within EDGE_TOL
    of the float32 plain version's."""
    child, sched, n_slots = eng._topology(tree.child)
    pi, logw = sys_[3], eng._logw(sys_[4])
    if ref is None:
        ref = clv_slots.uppass_site_lse_slots_plain(sched, tips, pm, pi, logw,
                                                    n_slots=n_slots)
    got = clv_slots.uppass_site_lse_slots_stream(sched, tips, pm, pi, logw,
                                                 n_slots=n_slots)
    got3 = clv.uppass_site_lse(child, tips, torch.stack([pm] * 2),
                               torch.stack([pi] * 2),
                               torch.stack([logw] * 2), sched=sched,
                               n_slots=n_slots)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got.double() - ref).abs().max()) < tol
    assert float((got3.double() - ref[None]).abs().max()) < tol
    err, plain = _site_terms_gaps(eng, tree, sys_, pm,
                                  edotp.edge_dotprods_stream, tips)
    assert err < plain + K2_TOL, (err, plain)
    raw = _raw_edge_gap(eng, tree, sys_, pm, edotp.edge_dotprods_stream, tips)
    assert raw <= EDGE_TOL, raw


@pytest.mark.parametrize("sites", [5, 33, 47])
def test_big_bodies_ragged_tiles(cuda, sites):
    """Pattern counts below one narrow tile (5), one wide tile and one
    (33) and a ragged wide tile (47) at 80 states, where K3/K4 take the
    32-pattern tile and K5 the 64-pattern one (four warps of 16, some
    of them wholly past the last pattern): K4, K3 and K5 against their
    plain versions."""
    eng, tree, sys_, pm = _generic_setup(cuda, 80, 4, 12, sites=sites)
    assert eng.P == sites
    assert clv.big_geometry(80, 4, sites, 4)["tile"] == 32
    assert edotp.geometry(80, 4, sites)["tile"] == 64
    _big_checks(eng, tree, sys_, pm, eng.tips, AA_TOL)


def test_big_bodies_past_the_cluster_size(cuda):
    """Ten rate classes, past the eight a cluster of one-class blocks
    takes: K3/K4's blocks walk the classes in turn (cluster 1); K4, K3
    and K5 against their plain versions at 80 states."""
    eng, tree, sys_, pm = _generic_setup(cuda, 80, 10, 12, sites=60)
    assert eng.C == 10 and clv.big_geometry(80, 10, eng.P, 4)["cluster"] == 1
    _big_checks(eng, tree, sys_, pm, eng.tips, AA_TOL)


@pytest.mark.parametrize("ns", [80, 160])
def test_big_bodies_at_the_worst_slot_count(cuda, ns):
    """A 128-taxon tree walked with 8 slots, the most a schedule of 128
    taxa needs: the wide tile's block would leave one block an SM, so
    K3/K4 take the 16-pattern tile; K4 and K3 (B = 2) against the plain
    version."""
    eng, tree, sys_, pm = _generic_setup(cuda, ns, 4, 128, sites=120)
    child, sched, n_slots = eng._topology(tree.child)
    assert n_slots <= 8
    assert clv_slots.geometry(ns, 4, eng.P, 128, 8, False)["tile"] == 16
    pi, logw = sys_[3], eng._logw(sys_[4])
    ref = clv_slots.uppass_site_lse_slots_plain(sched, eng.tips, pm, pi,
                                                logw, n_slots=n_slots)
    got = clv_slots.uppass_site_lse_slots_stream(sched, eng.slot_tips, pm,
                                                 pi, logw, n_slots=8)
    got3 = clv.uppass_site_lse(child, eng.tips, torch.stack([pm] * 2),
                               torch.stack([pi] * 2),
                               torch.stack([logw] * 2), sched=sched,
                               n_slots=8)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) < AA_TOL
    assert float((got3 - ref[None]).abs().max()) < AA_TOL


@pytest.mark.parametrize("ns", [80, 160])
def test_big_bodies_keep_float32_precision(cuda, ns):
    """Tips whose values span ~40 binary orders ((1 + u) 2^-k, so their
    TF32 lo halves are not zero and the columns' maxima move between
    states) at 80 and 160 states: K4 and K3 within 1e-4 per site of the
    plain version in float64, which one TF32 pass alone would miss
    (tests/test_torch_tf32split.py); K5's edge terms within the float32
    plain version's own gap plus K2_TOL."""
    eng, tree, sys_, pm = _generic_setup(cuda, ns, 4, 12, sites=150)
    rng = np.random.default_rng(ns)
    tips = (1.0 + rng.random(eng.tips.shape)) * \
        2.0 ** -rng.integers(0, 40, eng.tips.shape)
    tips = torch.tensor(tips, dtype=torch.float32, device=cuda)
    _, sched, n_slots = eng._topology(tree.child)
    pi, logw = sys_[3], eng._logw(sys_[4])
    ref = clv_slots.uppass_site_lse_slots_plain(
        sched, tips.double(), pm.double(), pi.double(), logw.double(),
        n_slots=n_slots)
    _big_checks(eng, tree, sys_, pm, tips, 1e-4, ref=ref)


def test_big_refusal_names_the_shape(cuda):
    """The one refusal left past the ladder: a block whose shared memory
    does not fit (here 1280 states: the narrow tile's slots, tip tiles
    and ring pass 227 KB); the message names the shape."""
    n, ns, P, C = 6, 1280, 40, 1
    rng = np.random.default_rng(0)
    child = np.asarray(Topology.random(n, rng).rooted().child,
                       dtype=np.int32)
    sched, n_slots = clv_slots.build_slot_schedule(n, child)
    f = lambda *shape: torch.rand(*shape, device=cuda)
    geo = clv_slots.geometry(ns, C, P, n, n_slots, resident=False)
    assert geo["block_smem_bytes"] > clv_slots.MAX_BLOCK_SMEM
    with pytest.raises(NotImplementedError, match="ns=1280, C=1"):
        clv_slots.uppass_site_lse_slots_stream(
            torch.as_tensor(sched, device=cuda), f(n, ns, P),
            f(2 * n - 1, C, ns, ns).contiguous(), f(C, ns), f(C),
            n_slots=n_slots)


# ----------------------------------------------------------------------
# the auxiliary tools on the card: the scan path's passes in the
# engine's dtype, the fastlk Hessian in float64
# ----------------------------------------------------------------------
AUX_TOL = 1e-3    # posteriors and predictive probabilities, card f32 vs CPU
HESS_REL = 1e-8   # fastlk Hessian, card f64 vs CPU f64, relative to max |H|


def _aux_pair(cuda, datatype="nt", n=24, sites=300):
    """(card float32 engine, CPU float64 engine, params, card tree, CPU
    tree) on one simulated problem."""
    from phyml_tpu_torch.interop import tree_arrays_from_numpy

    rng = np.random.default_rng(31)
    topo = Topology.random(n, rng, mean_blen=0.1)
    eng, tree, _, _ = _simulated_setup(cuda, 4, n, sites, 31, datatype,
                                       topo)
    cpu = LikelihoodEngine(eng.aln, eng.model, dtype=torch.float64,
                           device="cpu")
    params = eng.model.init_params(eng.aln.obs_state_freqs)
    params["alpha"] = torch.tensor(0.5, dtype=torch.float64)
    rv = topo.rooted()
    ctree = tree_arrays_from_numpy(rv.child, rv.node_blen, device="cpu",
                                   dtype=torch.float64)
    return eng, cpu, params, tree, ctree


@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_marginals_and_tip_predictive_card_against_cpu(cuda, datatype):
    from phyml_tpu_torch.ops.ancestral import marginal_posteriors
    from phyml_tpu_torch.ops.crossval import tip_predictive_probs

    eng, cpu, params, tree, ctree = _aux_pair(cuda, datatype)
    got = marginal_posteriors(eng, params, tree, include_root=True)
    assert got.device.type == "cuda" and got.dtype == torch.float64
    want = marginal_posteriors(cpu, params, ctree, include_root=True)
    assert float((got.cpu() - want).abs().max()) < AUX_TOL
    pg = tip_predictive_probs(eng, params, tree)
    pc = tip_predictive_probs(cpu, params, ctree)
    assert np.abs(pg - pc).max() < AUX_TOL


def test_sampling_and_mutation_map_on_the_card(cuda):
    from phyml_tpu_torch.ops.ancestral import map_mutations, sample_ancestral

    eng, _, params, tree, _ = _aux_pair(cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    cls, states = sample_ancestral(eng, params, tree, gen)
    assert cls.device.type == states.device.type == "cuda"
    st = states.cpu().numpy()
    # the tips keep their data
    assert (st[:eng.n_otu] == eng.aln.partials.argmax(-1)).all()
    events = map_mutations(eng, params, tree, cls, states,
                           np.random.default_rng(4), sites=np.arange(20))
    blen = tree.blen.double().cpu().numpy()
    assert events and all(0 < t <= blen[u] + 1e-6 for u, _, t, _, _ in events)


def test_fastlk_hessian_card_against_cpu(cuda):
    from phyml_tpu_torch.optim.fastlk import fit_normal_approx

    eng, cpu, params, tree, ctree = _aux_pair(cuda)
    blen = ctree.blen.clone()
    blen[:-1] = blen[:-1].clamp(min=0.01)    # no zero-length edge
    ga = fit_normal_approx(eng, params, tree._replace(
        blen=blen.to(cuda)))
    ca = fit_normal_approx(cpu, params, ctree._replace(blen=blen))
    assert ga.hess.device.type == "cuda" and ga.hess.dtype == torch.float64
    n = eng.n_nodes - 1
    h, hc = ga.hess.cpu()[:n, :n], ca.hess[:n, :n]
    assert float((h - hc).abs().max()) <= HESS_REL * float(hc.abs().max())
    assert abs(float(ga.lnL0) - float(ca.lnL0)) <= HESS_REL * abs(
        float(ca.lnL0))
    gb = fit_normal_approx(eng, params, tree._replace(
        blen=blen.to(cuda)), chunk_size=3)
    assert float((gb.hess - ga.hess).abs().max()) <= HESS_REL * float(
        hc.abs().max())


# ----------------------------------------------------------------------
# PhyREX: the joint phylogeography chain
# ----------------------------------------------------------------------
PHYREX_F64_TOL = 0.5  # PhyREX chain lnL, card f32 against CPU f64


@pytest.mark.parametrize("kind", ["rrw", "slfv"])
def test_phyrex_chain_lnl_card_against_cpu(cuda, kind):
    """run_phyrex on the card (an rrw chain of 500 iterations with
    topology moves, or 25 SLFV sweeps): every posterior lnL through K1,
    none through K3, and the lnL at the final state recomputed by the
    CPU in float64 within PHYREX_F64_TOL; the rrw chain's log prior,
    the location term included, equal to the CPU's."""
    from phyml_tpu_torch.bayes.mcmc import MCMC, MCMCSettings
    from phyml_tpu_torch.bayes.phyrex import run_phyrex
    from phyml_tpu_torch.bayes.rates import RateModel
    from phyml_tpu_torch.bayes.slfv import make_seq_loglik_fn
    from phyml_tpu_torch.bayes.times import TimePrior
    from phyml_tpu_torch.interop import chain_state_from_numpy

    card, tt = _chain_setup(cuda)
    cpu, _ = _chain_setup("cpu")
    rng = np.random.default_rng(3)
    par, dt = tt.parent, tt.edge_durations()
    x = np.zeros((tt.n_nodes, 2))
    for u in range(tt.n_nodes - 2, -1, -1):
        x[u] = x[par[u]] + rng.normal(size=2) * np.sqrt(dt[u])
    x = x[:tt.n_otu]
    n1 = launches(clv_slots.uppass_site_lse_slots)
    n3 = launches(clv.uppass_site_lse)
    res = run_phyrex(card.engine.aln, x, tt, model=card.engine.model,
                     trait_kind=kind, settings=MCMCSettings(
                         n_iter=500, burnin=250, batch=250, seed=4),
                     engine=card.engine)
    torch.cuda.synchronize()
    assert launches(clv.uppass_site_lse) == n3
    assert launches(clv_slots.uppass_site_lse_slots) - n1 > 20
    assert np.isfinite(res.anc_locations).all()
    params = cpu.engine.model.init_params(cpu.engine.aln.obs_state_freqs)
    if kind == "slfv":
        smp = res.sampler
        want = make_seq_loglik_fn(cpu.engine, params)(smp.state, smp.clock)
        assert abs(smp.seq_lnl - want) <= PHYREX_F64_TOL
        return
    st = res.state
    mc = MCMC(cpu.engine, cpu.engine.model, params, tt,
              RateModel(kind="lognormal"), TimePrior(kind="coalescent"),
              MCMCSettings(seed=4), trait_x=x, trait_kind=kind)
    st_cpu = chain_state_from_numpy({
        k: ({k2: v2.numpy() for k2, v2 in v.items()}
            if isinstance(v, dict) else v.numpy())
        for k, v in st._asdict().items()})
    assert res.sampler.move_w[-1] == 0.0
    assert abs(float(st.lnL) - float(mc._lnL(st_cpu))) <= PHYREX_F64_TOL
    assert float(st.lp) == float(mc._log_prior(st_cpu))
