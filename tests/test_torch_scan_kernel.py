"""K7, the scan passes' kernel (ops/scan.py, csrc/scan.cu).

On the CPU: `LikelihoodEngine._scan_kernel` picks the engine's loops for
CPU tensors, float64 and a prune mask, and K7 for unmasked float32
P-matrices on a CUDA device at any state count; K7's wrapper refuses
what the kernel does not take, a child table that is not a postorder
before any launch.

On the card (marked `gpu`; the machine with the card has no JAX, so run
this file without the suite's conftest:
`python -m pytest tests/test_torch_scan_kernel.py --noconftest -m gpu`):
K7's pup, clv, sc, out and sc_out against the float32 loops on the same
card tensors at every rung of the ladder (4 to 32 states; 7 and 28
padded to 8 and 32), and past it at 80, 114 (padded to 116) and 160
states (the matrix staged), 184 and 255 (read in place, tiles of 32),
301 (16), 600 (8) and 1,100 (4), one to four classes, one tree and a
stack of three; the blocks' geometry; the NNI scorer through K7 against
the scorer through the loops; the launches.  K7
takes the loops' products and divisions to the bit, but sums each
matrix product in its own order (ascending, fused multiply-adds; the
loops' einsum is cuBLAS's): partials differ by float32 rounding, each
tolerance below says how much.
"""

import types

import numpy as np
import pytest
import torch

from phyml_tpu_torch.datatypes import AA_STATES, NT_STATES
from phyml_tpu_torch.evolve import simulate_alignment
from phyml_tpu_torch.io.alignment import compact
from phyml_tpu_torch.models.substitution import SubstModel
from phyml_tpu_torch.ops import _build, scan
from phyml_tpu_torch.ops.likelihood import (
    LikelihoodEngine, TreeArrays, tree_arrays,
)
from phyml_tpu_torch.search import nni, spr
from phyml_tpu_torch.topology import Topology
from phyml_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The Tier-1 run's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(device, dtype, ns=4, C=4, n=10, sites=200, seed=0):
    """(engine, params, topology) at ns states: DNA (GTR) at 4, amino
    acids (LG) at 20, the LG covarion at 20 h (h hidden classes), the
    nucleotide covarion at other multiples of 4, and a JC alphabet of ns
    states otherwise (random tips, K7's padded rows); C rate classes."""
    rng = np.random.default_rng(seed)
    topo = Topology.random(n, rng, mean_blen=0.1)
    if ns % 4:
        states = rng.integers(0, ns, (n, sites))
        enc = np.zeros((n, sites, ns), dtype=np.float32)
        enc[np.arange(n)[:, None], np.arange(sites)[None], states] = 1.0
        aln = compact(enc, [f"t{i}" for i in range(n)], "generic")
        model = SubstModel(datatype="generic", generic_ns=ns, n_classes=C)
        params = model.init_params()
    else:
        dt, obs = ("nt", 4) if ns % 20 else ("aa", 20)
        name = "GTR" if dt == "nt" else "LG"
        sim = SubstModel(datatype=dt, name=name, n_classes=1)
        p0 = sim.init_params(np.full(obs, 1.0 / obs))
        names, seqs = simulate_alignment(topo, sim, p0, sites, rng)
        alphabet = NT_STATES if dt == "nt" else AA_STATES
        idx = np.array([[alphabet.index(ch) for ch in s] for s in seqs])
        enc = np.zeros(idx.shape + (obs,), dtype=np.float32)
        enc[np.arange(n)[:, None], np.arange(sites)[None], idx] = 1.0
        aln = compact(enc, names, dt)
        hidden = ns // obs
        model = SubstModel(datatype=dt, name=name, n_classes=C,
                           covarion=hidden > 1, n_hidden=max(hidden, 2))
        params = model.init_params(np.full(obs, 1.0 / obs))
    if C > 1:
        params["alpha"] = torch.tensor(0.6, dtype=torch.float64)
    eng = LikelihoodEngine(aln, model, dtype=dtype, device=device)
    assert eng.ns == ns
    return eng, params, topo


def _stack(n, R, seed, dtype, device):
    """R random trees of n taxa: stacked TreeArrays and their NNI
    candidates [R, E, 5]."""
    rng = np.random.default_rng(seed)
    rvs = [Topology.random(n, rng, mean_blen=0.1).rooted() for _ in range(R)]
    tas = [tree_arrays(rv, dtype=dtype, device=device) for rv in rvs]
    trees = TreeArrays(child=torch.stack([t.child for t in tas]),
                       blen=torch.stack([t.blen for t in tas]))
    return trees, np.stack([nni.candidate_arrays(rv) for rv in rvs])


def _k7_launches():
    return trace.snapshot().get("launch.K7", 0)


# ---- CPU: the route ---------------------------------------------------------

CPU = dict(device="cpu", dtype=torch.float32)


def test_route_takes_the_loop_on_the_cpu(monkeypatch):
    eng, params, topo = _problem(**CPU)
    tree = tree_arrays(topo.rooted(), **CPU)
    lam, V, Vinv, pi = eng.system_of(params)[:4]
    pm = eng._pmats(lam, V, Vinv, tree.blen)
    assert not eng._scan_kernel(pm, None)

    def refuse(*a, **kw):
        raise AssertionError("K7 on CPU tensors")

    monkeypatch.setattr(scan, "up_pass", refuse)
    monkeypatch.setattr(scan, "down_pass", refuse)
    before = _k7_launches()
    pup, clv, sc = eng._up_pass(pm, tree.child)
    out, sc_out = eng._down_pass(pm, tree.child, pup, sc, pi)
    assert _k7_launches() == before
    assert pup.shape == clv.shape == out.shape == (eng.n_nodes, 4, 4, eng.P)
    assert float(out[-1].abs().max()) == 0.0


@pytest.mark.parametrize("case,want", [
    ("cuda float32", True), ("cuda float64", False), ("cpu float32", False),
    ("mask", False), ("180 states", True), ("184 states", True),
    ("4096 states", True)])
def test_route_by_device_dtype_mask_and_states(case, want):
    """The route reads only the P-matrices' device and dtype and the mask,
    not the state count (K7 runs or its launch is refused): a stand-in
    for the P-matrices carries the first two, so the CUDA cases are
    decided without a card."""
    eng, _, _ = _problem(**CPU)
    pm = types.SimpleNamespace(is_cuda=not case.startswith("cpu"),
                               dtype=torch.float64 if "64" in case
                               else torch.float32)
    mask = np.zeros((2, eng.n_internal, 2)) if case == "mask" else None
    if case.endswith("states"):
        eng.ns = int(case.split()[0])
    assert eng._scan_kernel(pm, mask) is want


# ---- CPU: what K7's wrapper refuses ------------------------------------------

def _operands(dtype=torch.float32):
    eng, params, topo = _problem(device="cpu", dtype=dtype)
    tree = tree_arrays(topo.rooted(), device="cpu", dtype=dtype)
    lam, V, Vinv, pi = eng.system_of(params)[:4]
    pm = eng._pmats(lam, V, Vinv, tree.blen)
    pup, _, sc = eng._up_pass(pm, tree.child)
    return eng, tree.child, pm, pup, sc, pi


def _as_up_pass_stores(x):
    """x stored as K7's up pass stores it (rows scan.padded(P) apart)."""
    y = scan._empty(x.shape, x.shape[-1], x.device)
    y.copy_(x)
    return y


def test_wrapper_refuses_cpu_tensors():
    eng, child, pm, pup, sc, pi = _operands()
    with pytest.raises(ValueError, match="CUDA"):
        scan.up_pass(child, eng.tips, pm)
    with pytest.raises(ValueError, match="CUDA"):
        scan.down_pass(child, pm, _as_up_pass_stores(pup),
                       _as_up_pass_stores(sc), pi)


@pytest.mark.parametrize("which", ["up", "down"])
def test_cpu_tensors_are_refused_before_the_library(which, monkeypatch):
    """The device is checked before the launch geometry is asked of the
    kernel library, which a machine without CUDA cannot build."""
    eng, child, pm, pup, sc, pi = _operands()

    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(_build, "library", no_library)
    with pytest.raises(ValueError, match="CUDA"):
        if which == "up":
            scan.up_pass(child, eng.tips, pm)
        else:
            scan.down_pass(child, pm, _as_up_pass_stores(pup),
                           _as_up_pass_stores(sc), pi)


def test_the_down_pass_takes_the_up_pass_layout():
    """pup and sc with rows P apart (the loop's) are refused: the kernel
    reads them rows scan.padded(P) apart, as the up pass stores them."""
    eng, child, pm, pup, sc, pi = _operands()
    assert eng.P % 32 and pup.is_contiguous()
    with pytest.raises(ValueError, match="up pass"):
        scan.down_pass(child, pm, pup, sc, pi)
    assert scan.padded(eng.P) == -(-eng.P // 32) * 32
    y = _as_up_pass_stores(pup)
    assert y.shape == pup.shape and y.stride(-2) == scan.padded(eng.P)


def test_wrapper_refuses_other_dtypes():
    eng, child, pm, pup, sc, pi = _operands(torch.float64)
    with pytest.raises(ValueError, match="float32"):
        scan.up_pass(child, eng.tips, pm)
    with pytest.raises(ValueError, match="float32"):
        scan.down_pass(child, pm, pup, sc, pi)


def test_wrapper_refuses_a_strided_pattern_axis():
    eng, child, pm, pup, sc, pi = _operands()
    tips = torch.cat([eng.tips, eng.tips], -1)[..., ::2]
    assert tips.shape == eng.tips.shape and tips.stride(-1) == 2
    with pytest.raises(ValueError, match="contiguous"):
        scan.up_pass(child, tips, pm)
    pup2 = torch.cat([pup, pup], -1)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        scan.down_pass(child, pm, pup2, sc, pi)


@pytest.mark.parametrize("what", ["child", "rows", "pmats", "pup", "sc",
                                  "pi", "stack"])
def test_wrapper_refuses_shapes_that_do_not_match(what):
    """A child table of one row less is a consistent shape to the down
    pass (a tree of one tip more), so only the up pass, which has the
    tips, can refuse it."""
    eng, child, pm, pup, sc, pi = _operands()
    if what == "child":
        child = child[:, :1]
    elif what == "rows":
        child = child[:-1]
    elif what == "pmats":
        pm = pm[:, :, :-1]
    elif what == "pup":
        pup = pup[..., :-1]
    elif what == "sc":
        sc = sc[:-1]
    elif what == "pi":
        pi = pi[:, :-1]
    else:
        child = child[None, None]
    if what != "rows":
        with pytest.raises(ValueError, match="shape"):
            scan.down_pass(child, pm, pup, sc, pi)
    if what in ("child", "rows", "pmats", "stack"):
        with pytest.raises(ValueError, match="shape"):
            scan.up_pass(child, eng.tips, pm)


@pytest.mark.parametrize("fault", ["outside", "later", "equal", "negative"])
def test_a_bad_child_table_is_refused_before_launch(fault, monkeypatch):
    """Checked on the host, before the kernel library is touched: the
    wrapper's host table and the engine's route (`_scan_child`)."""
    eng, child, pm, pup, sc, pi = _operands()
    bad = child.clone()
    i = eng.n_internal - 2
    if fault == "outside":
        bad[i, 0] = eng.n_nodes
    elif fault == "later":
        bad[i, 0] = eng.n_otu + i
    elif fault == "equal":
        bad[i, 1] = bad[i, 0]
    else:
        bad[0, 1] = -1

    def no_library():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(_build, "library", no_library)
    with pytest.raises(ValueError, match="postorder"):
        scan.up_pass(bad, eng.tips, pm)
    with pytest.raises(ValueError, match="postorder"):
        scan.down_pass(bad, pm, pup, sc, pi)
    with pytest.raises(ValueError, match="postorder"):
        eng._scan_child(bad)
    with pytest.raises(ValueError, match="postorder"):
        eng._scan_child(torch.stack([child, bad]))
    scan.check_child_table("ok", torch.stack([child, child]), eng.n_otu)


# ---- the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD = dict(dtype=torch.float32)

# Each output of K7 against the float32 loop's, the largest gap relative
# to that column's maximum over the states: both are float32 walks of
# the same tree whose products differ in their order of sums only (a
# few ulp a step, 1e-7 relative); the rounding compounds along a path of
# at most ~20 steps here, and at 80 and 160 states each product sums 4-8
# times the terms.  A fault (a wrong child, matrix, scale or row) is off
# by O(1).
GAP_TOL = 5e-5
GAP_TOL_WIDE = 1e-4   # past 64 states
# Scales: natural logs of the column maxima summed along the path, held
# within SC_TOL x (1 + |the loop's|).
SC_TOL = 5e-5
# The NNI scorer's lnL, relative: the partials' gaps (GAP_TOL) move each
# site's lnL by about that much of 1, a few lnL units at most over a
# supermatrix's |lnL| of 1e5-1e6; aBayes supports turn on differences of
# a few units, so the scorer is held a hundred times tighter than that.
LNL_TOL = 1e-6


def _gap(got, ref):
    m = ref.abs().amax(dim=-2, keepdim=True).clamp(min=1e-30)
    return float(((got - ref).abs() / m).max())


def _passes(eng, pm, child, pi):
    pup, clv, sc = eng._up_pass(pm, child)
    out, sc_out = eng._down_pass(pm, child, pup, sc, pi)
    return pup, clv, sc, out, sc_out


@pytest.mark.gpu
@pytest.mark.parametrize("ns,C", [(4, 1), (4, 4), (7, 4), (12, 4), (16, 2),
                                  (20, 1), (20, 4), (24, 1), (28, 4), (80, 1),
                                  (80, 4), (114, 1), (160, 1), (184, 1),
                                  (255, 2), (301, 1), (600, 1), (1100, 1)])
@pytest.mark.parametrize("R", [0, 3])
def test_k7_matches_the_loop(cuda, ns, C, R, monkeypatch):
    eng, params, topo = _problem(cuda, ns=ns, C=C, n=24 if ns < 80 else 12,
                                 sites=700 if ns < 80 else 160,
                                 seed=ns + C + R, **CARD)
    lam, V, Vinv, pi = eng.system_of(params)[:4]
    tree = _stack(eng.n_otu, R, seed=R, device=cuda, **CARD)[0] if R else \
        tree_arrays(topo.rooted(), device=cuda, **CARD)
    pm = eng._pmats(lam, V, Vinv, tree.blen)
    assert eng._scan_kernel(pm, None)
    before = _k7_launches()
    got = _passes(eng, pm, tree.child, pi)
    torch.cuda.synchronize()
    assert _k7_launches() == before + 2
    monkeypatch.setattr(eng, "_scan_kernel", lambda pmats, mask: False)
    ref = _passes(eng, pm, tree.child, pi)
    lead = (R,) if R else ()
    for x, y in zip(got, ref):
        assert x.shape == y.shape and x.stride(-1) == 1
        assert x.stride(-2) == scan.padded(eng.P)
        assert bool(torch.isfinite(x).all())
    tol = GAP_TOL_WIDE if ns > 64 else GAP_TOL
    gaps = {name: _gap(got[k], ref[k])
            for k, name in ((0, "pup"), (1, "clv"), (3, "out"))}
    for k, name in ((2, "sc"), (4, "sc_out")):
        gaps[name] = float(((got[k] - ref[k]).abs()
                            / (1 + ref[k].abs())).max())
    print(f"ns={ns} C={C} R={R}: {gaps}")
    assert max(gaps[k] for k in ("pup", "clv", "out")) <= tol, gaps
    assert max(gaps["sc"], gaps["sc_out"]) <= SC_TOL, gaps
    root = eng.n_nodes - 1
    out, sc_out = got[3], got[4]
    assert out.shape == lead + (eng.n_nodes, C, ns, eng.P)
    assert float(out[..., root, :, :, :].abs().max()) == 0.0
    assert float(sc_out[..., root, :, :].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("ns,C", [(4, 4), (20, 4), (80, 1)])
def test_nni_scorer_through_k7_matches_the_loop(cuda, ns, C, monkeypatch):
    """At a small bench-like shape: the NNI scorer's lnL of every edge's
    three arrangements within LNL_TOL relative of the scorer's through
    the loops, and its lengths' median gap within 1e-4."""
    eng, params, topo = _problem(cuda, ns=ns, C=C, n=32 if ns < 80 else 16,
                                 sites=256, seed=11, **CARD)
    rv = topo.rooted()
    tree = tree_arrays(rv, device=cuda, **CARD)
    cand = nni.candidate_arrays(rv)
    before = _k7_launches()
    lnl, ts = nni.nni_scores(eng, params, tree, cand)
    assert _k7_launches() == before + 2
    monkeypatch.setattr(eng, "_scan_kernel", lambda pmats, mask: False)
    lnl0, ts0 = nni.nni_scores(eng, params, tree, cand)
    assert _k7_launches() == before + 2
    rel = np.abs(lnl - lnl0) / np.abs(lnl0)
    lens = np.concatenate([np.abs(a - b).ravel() / np.abs(b).ravel()
                           for a, b in zip(ts, ts0)])
    print(f"ns={ns} C={C}: lnL max {rel.max():.3e}, lengths median "
          f"{np.median(lens):.3e}")
    assert rel.max() <= LNL_TOL
    assert np.median(lens) <= 1e-4


@pytest.mark.gpu
def test_launches_per_scorer_call(cuda):
    """Two a call of the NNI scorer, one tree or a stack (also counted by
    its size); none for the SPR scorer's masked passes."""
    eng, params, topo = _problem(cuda, ns=4, C=4, n=16, sites=256, seed=3,
                                 **CARD)
    rv = topo.rooted()
    tree = tree_arrays(rv, device=cuda, **CARD)
    before = trace.snapshot()
    nni.nni_scores(eng, params, tree, nni.candidate_arrays(rv))
    moved = trace.since(before)
    assert moved.get("launch.K7", 0) == 2
    trees, cands = _stack(eng.n_otu, 3, seed=5, device=cuda, **CARD)
    before = trace.snapshot()
    nni.nni_scores_batched(eng, params, trees, cands,
                           eng.weights.expand(3, -1))
    moved = trace.since(before)
    assert moved.get("launch.K7", 0) == 2
    assert moved.get("launch.K7.trees.3", 0) == 2
    vs = spr.prune_candidates(rv)[:4]
    moves = [spr.spr_move_arrays(rv, v) for v in vs]
    before = trace.snapshot()
    spr.spr_scores_batched(eng, params, tree, np.stack([m for m, _ in moves]),
                           vs, np.stack([v for _, v in moves]))
    assert trace.since(before).get("launch.K7", 0) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("ns,NS,tile,threads,staged", [
    (2, 4, 32, 32, False), (4, 4, 32, 32, False), (7, 8, 32, 32, False),
    (12, 12, 32, 32, False), (20, 20, 32, 32, False), (28, 32, 16, 32, False),
    (32, 32, 16, 32, False), (36, 36, 32, 72, True), (80, 80, 32, 160, True),
    (114, 116, 32, 232, True), (180, 180, 32, 360, True),
    (184, 184, 32, 368, False), (256, 256, 32, 512, False),
    (301, 304, 16, 304, False), (512, 512, 16, 512, False),
    (600, 600, 8, 300, False), (1100, 1100, 4, 275, False),
    (2048, 2048, 4, 512, False)])
def test_geometry(cuda, ns, NS, tile, threads, staged):
    """One warp a block at the rung of the ladder up to 32 states; past
    them blocks of NS / 4 x tile / 4 threads, the widest tile of 32, 16,
    8 or 4 patterns within 512 threads, the up pass's matrix staged up
    to 180 states; each block within the card's shared memory."""
    for down in (False, True):
        g = scan.geometry(ns, down)
        assert (g["NS"], g["tile"], g["threads"]) == (NS, tile, threads)
        assert g["staged"] == (staged and not down)
        assert 0 < g["smem_bytes"] <= _build.MAX_BLOCK_SMEM


@pytest.mark.gpu
def test_no_block_past_2048_states(cuda):
    """Past 2,048 states K7 has no block: the launch is refused, not
    routed to the loops."""
    assert scan.geometry(2052)["smem_bytes"] == 0
    eng, params, topo = _problem(cuda, ns=2051, C=1, n=4, sites=8, **CARD)
    tree = tree_arrays(topo.rooted(), device=cuda, **CARD)
    lam, V, Vinv, pi = eng.system_of(params)[:4]
    pm = eng._pmats(lam, V, Vinv, tree.blen)
    assert eng._scan_kernel(pm, None)
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
        eng._up_pass(pm, tree.child)
