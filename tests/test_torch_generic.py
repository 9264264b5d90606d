"""Custom alphabets (`-d generic`) and the kernels' state-count padding,
on the CPU.

* The engine's lnL at 2, 7 and 36 states (JC over the alphabet, +G4)
  against phyml_tpu's, in float64, within 1e-6.
* The CLI's default run (BioNJ, then the NNI search) on 2- and 7-state
  data against phyml_tpu.cli on the same file: the same tree, the stats
  lnL within 1e-6.
* The padding the CUDA wrappers apply (`ops/_build.py`: a state count
  between the ladder's rungs goes up to the next rung): each plain
  kernel (K1/K4's, K3's, K2/K5's) on operands padded to the next rung
  equals its unpadded result within 1e-12 in float64, at 2, 7, 12, 36
  and 60 states (12 is a rung: padded to the next one up; 36 and 60
  pass the top rung, 32, and are padded to 48 and 64, the big bodies'
  widths), and the padded states' rows of d are zero.  No kernel runs here, so this
  holds the padding logic in the CPU tests.
* The ladder read from csrc/ladder.cuh, and the rules that size the
  search and the bootstrap (`default_batch_k`, `rep_chunk_for`) read
  the true state count, not the rung.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu import cli as jcli
from phyml_tpu.evolve import write_phylip
from phyml_tpu.io.alignment import compact as jcompact
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.ops.likelihood import LikelihoodEngine as JEngine
from phyml_tpu.ops.likelihood import tree_arrays as jtree_arrays
from phyml_tpu.topology import Topology
from phyml_tpu_torch import cli as tcli
from phyml_tpu_torch.interop import params_from_numpy, tree_arrays_from_numpy
from phyml_tpu_torch.io.alignment import compact as tcompact
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.ops import _build, clv, clv_slots, edotp
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine
from phyml_tpu_torch.search import spr as tspr
from phyml_tpu_torch.search import support as tsupport
from test_torch_bionj import _stats_lnl

LNL_TOL = 1e-6
PAD_TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """As in tests/test_torch_bionj.py: one torch thread for the many
    small ops of the search."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jc_states(ns, n_taxa, n_sites, seed, mean_blen=0.15):
    """[n_taxa, n_sites] states simulated under JC over ns states down a
    random tree (the generic model's process), and the tree."""
    rng = np.random.default_rng(seed)
    topo = Topology.random(n_taxa, rng, mean_blen=mean_blen)
    rv = topo.rooted()
    states = np.zeros((rv.n_nodes, n_sites), dtype=np.int64)
    states[-1] = rng.integers(0, ns, n_sites)
    for i in range(rv.n_internal - 1, -1, -1):        # preorder
        for c in (int(x) for x in rv.child[i]):
            t = float(rv.node_blen[c])
            same = 1.0 / ns + (1.0 - 1.0 / ns) * np.exp(-ns * t / (ns - 1))
            keep = rng.random(n_sites) < same
            other = (states[rv.n_otu + i]
                     + rng.integers(1, ns, n_sites)) % ns
            states[c] = np.where(keep, states[rv.n_otu + i], other)
    return states[:rv.n_otu], topo


def _one_hot(states, ns):
    n, sites = states.shape
    enc = np.zeros((n, sites, ns), dtype=np.float32)
    enc[np.arange(n)[:, None], np.arange(sites)[None], states] = 1.0
    return enc


@pytest.mark.parametrize("ns", [2, 7, 36])
def test_loglik_matches_phyml_tpu(ns):
    states, topo = _jc_states(ns, 10, 200, seed=ns)
    enc = _one_hot(states, ns)
    names = [f"t{i}" for i in range(10)]
    kw = dict(datatype="generic", generic_ns=ns, n_classes=4)
    jm, tm = JModel(**kw), TModel(**kw)
    jaln, taln = jcompact(enc, names, "generic"), tcompact(enc, names,
                                                           "generic")
    p = {k: np.asarray(v) for k, v in jm.init_params().items()}
    p["alpha"] = np.asarray(0.6)
    jeng = JEngine(jaln, jm, dtype=jnp.float64, use_pallas=False)
    teng = TEngine(taln, tm, dtype=torch.float64, device="cpu")
    assert teng.ns == ns and teng.tips.shape[1] == ns
    jta = jtree_arrays(topo.rooted(), dtype=jnp.float64)
    tta = tree_arrays_from_numpy(np.asarray(jta.child), np.asarray(jta.blen),
                                 device="cpu", dtype=torch.float64)
    want = float(jeng.loglik({k: jnp.asarray(v) for k, v in p.items()}, jta))
    got = float(teng.loglik(params_from_numpy(p), tta))
    assert abs(got - want) < LNL_TOL, (got, want)


@pytest.mark.parametrize("ns", [2, 7])
def test_cli_generic_matches_phyml_tpu(ns, tmp_path, monkeypatch):
    """`-d generic` (JC over the inferred alphabet, +G4), the default
    run: the same tree and the stats lnL within 1e-6 in both CLIs."""
    import phyml_tpu.io.output as jout
    import phyml_tpu_torch.io.output as tout

    states, _ = _jc_states(ns, 7, 120, seed=10 + ns)
    names = [f"t{i}" for i in range(7)]
    seqs = ["".join("0123456789"[s] for s in row) for row in states]
    runs = {}
    for tag, main, mod in (("jax", jcli.main, jout),
                           ("torch", tcli.main, tout)):
        d = tmp_path / tag
        d.mkdir()
        aln = str(d / "aln.phy")
        write_phylip(aln, names, seqs)
        seen = _stats_lnl(monkeypatch, mod)
        assert main(["-i", aln, "-d", "generic", "-c", "4", "-b", "0",
                     "--platform", "cpu", "--r_seed", "1", "--quiet"]) == 0
        with open(f"{aln}_phyml_tree.txt") as fh:
            runs[tag] = (float(seen[-1]),
                         Topology.from_newick(fh.read(), names))
    (lj, tj), (lt, tt) = runs["jax"], runs["torch"]
    assert tt.rf_distance(tj) == 0
    assert abs(lt - lj) < LNL_TOL, (lt, lj)


def test_covarion_alphabet_loglik_matches_phyml_tpu():
    """A 36-state alphabet under the covarion model at two hidden
    classes (72 states, past the kernels' ladder: the big bodies' route,
    their plain versions on the CPU) against phyml_tpu, float64, within
    1e-6."""
    ns, n = 36, 10
    states, topo = _jc_states(ns, n, 200, seed=ns)
    enc = _one_hot(states, ns)
    names = [f"t{i}" for i in range(n)]
    kw = dict(datatype="generic", generic_ns=ns, n_classes=4, covarion=True,
              n_hidden=2)
    jm, tm = JModel(**kw), TModel(**kw)
    assert jm.ns == tm.ns == 72
    p = {k: np.asarray(v) for k, v in jm.init_params().items()}
    p["alpha"], p["cov_delta"] = np.asarray(0.6), np.asarray(0.8)
    jeng = JEngine(jcompact(enc, names, "generic"), jm, dtype=jnp.float64,
                   use_pallas=False)
    teng = TEngine(tcompact(enc, names, "generic"), tm, dtype=torch.float64,
                   device="cpu")
    assert (teng.lnl_route, teng.edotp_route) == ("K4", "K5")
    jta = jtree_arrays(topo.rooted(), dtype=jnp.float64)
    tta = tree_arrays_from_numpy(np.asarray(jta.child), np.asarray(jta.blen),
                                 device="cpu", dtype=torch.float64)
    want = float(jeng.loglik({k: jnp.asarray(v) for k, v in p.items()}, jta))
    got = float(teng.loglik(params_from_numpy(p), tta))
    assert abs(got - want) < LNL_TOL, (got, want)


def test_cli_covarion_alphabet_matches_phyml_tpu(tmp_path, monkeypatch):
    """`-d generic --cov --cov_ncats 2 -o lr` on a 36-state alphabet (72
    states): BioNJ, then the fixed-topology fit, in both CLIs: the same
    tree and the stats lnL within 1e-6."""
    import phyml_tpu.io.output as jout
    import phyml_tpu_torch.io.output as tout

    from phyml_tpu_torch.datatypes import GENERIC_STATES

    states, _ = _jc_states(36, 6, 100, seed=46)
    names = [f"t{i}" for i in range(6)]
    seqs = ["".join(GENERIC_STATES[s] for s in row) for row in states]
    runs = {}
    for tag, main, mod in (("jax", jcli.main, jout),
                           ("torch", tcli.main, tout)):
        d = tmp_path / tag
        d.mkdir()
        aln = str(d / "aln.phy")
        write_phylip(aln, names, seqs)
        seen = _stats_lnl(monkeypatch, mod)
        assert main(["-i", aln, "-d", "generic", "-c", "4", "-b", "0",
                     "--cov", "--cov_ncats", "2", "-o", "lr",
                     "--platform", "cpu", "--r_seed", "1", "--quiet"]) == 0
        with open(f"{aln}_phyml_tree.txt") as fh:
            runs[tag] = (float(seen[-1]),
                         Topology.from_newick(fh.read(), names))
    (lj, tj), (lt, tt) = runs["jax"], runs["torch"]
    assert tt.rf_distance(tj) == 0
    assert abs(lt - lj) < LNL_TOL, (lt, lj)


# ----------------------------------------------------------------------
# the wrappers' padding, held on the plain versions
# ----------------------------------------------------------------------
def _next_rung(ns):
    """The rung a wrapper pads ns to; for a rung, the next one up."""
    return _build.rung(ns + 1) if ns in _build.LADDER else _build.rung(ns)


def _plain_operands(ns, C=3, n=9, P=37, seed=4):
    """float64 operands of the plain kernels on random ns-state data: a
    random tree, random reversible system, random tips."""
    rng = np.random.default_rng(seed + ns)
    enc = _one_hot(rng.integers(0, ns, size=(n, P)), ns)
    tm = TModel(datatype="generic", generic_ns=ns, n_classes=C)
    aln = tcompact(enc, [f"t{i}" for i in range(n)], "generic")
    eng = TEngine(aln, tm, dtype=torch.float64, device="cpu")
    p = tm.init_params()
    p["freqs_const"] = torch.as_tensor(rng.dirichlet(np.ones(ns)))
    p["alpha"] = torch.tensor(0.7, dtype=torch.float64)
    tree = tree_arrays_from_numpy(
        np.asarray(Topology.random(n, rng, mean_blen=0.2).rooted().child),
        rng.uniform(0.01, 0.4, 2 * n - 1), device="cpu",
        dtype=torch.float64)
    lam, V, Vinv, pi, w, _ = eng.system_of(p)
    pm = eng._pmats(lam, V, Vinv, tree.blen)
    child, sched, n_slots = eng._topology(tree.child)
    return dict(eng=eng, child=child, sched=sched, n_slots=n_slots,
                tips=eng.tips, pm=pm, V=V, Vinv=Vinv, pi=pi,
                logw=eng._logw(w))


@pytest.mark.parametrize("ns", [2, 7, 12, 36, 60])
def test_plain_kernels_unchanged_by_padding(ns):
    o = _plain_operands(ns)
    NS = _next_rung(ns)
    assert NS > ns
    pad = _build.pad_states
    tips, pm = pad(o["tips"], NS, (1,)), pad(o["pm"], NS, (2, 3))
    pi, V, Vinv = pad(o["pi"], NS, (1,)), pad(o["V"], NS, (1, 2)), \
        pad(o["Vinv"], NS, (1, 2))
    assert tips.shape[1] == pm.shape[-1] == NS
    assert float(pm[..., ns:, :].abs().max()) == 0.0
    # K1/K4's plain version, on the slot tips padded as the wrapper pads
    # them (rows to the tile, states to the rung)
    slot_tips = clv_slots.padded_tips(o["tips"], NS)
    assert slot_tips.shape == tips.shape and \
        slot_tips.stride(1) % clv_slots.TILE == 0
    want = clv_slots.uppass_site_lse_slots_plain(
        o["sched"], o["tips"], o["pm"], o["pi"], o["logw"],
        n_slots=o["n_slots"])
    got = clv_slots.uppass_site_lse_slots_plain(
        o["sched"], slot_tips, pm, pi, o["logw"], n_slots=o["n_slots"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=PAD_TOL)
    # K3's, a batch of two systems
    want3 = clv.uppass_site_lse_plain(
        o["child"], o["tips"], torch.stack([o["pm"]] * 2),
        torch.stack([o["pi"]] * 2), torch.stack([o["logw"]] * 2))
    got3 = clv.uppass_site_lse_plain(
        o["child"], tips, torch.stack([pm] * 2), torch.stack([pi] * 2),
        torch.stack([o["logw"]] * 2))
    np.testing.assert_allclose(got3.numpy(), want3.numpy(), rtol=0,
                               atol=PAD_TOL)
    # K2/K5's: the first ns rows of d and sc_d unchanged, the padded
    # states' rows zero
    d0, s0 = edotp.edge_dotprods_plain(o["child"], o["tips"], o["pm"],
                                       o["V"], o["Vinv"], o["pi"])
    d1, s1 = edotp.edge_dotprods_plain(o["child"], tips, pm, V, Vinv, pi)
    np.testing.assert_allclose(d1[:, :, :ns].numpy(), d0.numpy(), rtol=0,
                               atol=PAD_TOL)
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), rtol=0, atol=PAD_TOL)
    assert float(d1[:, :, ns:].abs().max()) == 0.0


@pytest.mark.parametrize("ns,NS", [(60, 64), (40, 48)])
def test_edge_dotprods_plain_unchanged_by_padding_to_the_big_width(ns, NS):
    """K5's plain version in float64 at the amino-acid covarion widths
    the big body runs padded (60 -> 64, 40 -> 48): its call on every
    operand zero-padded to NS states equals its call at ns within 1e-12
    in d's first ns rows and in sc_d, and the padded rows of d are
    zero, so the big body's padded states add nothing to its sums."""
    assert _build.rung(ns) == NS
    o = _plain_operands(ns, C=4, n=12, P=53)
    pad = _build.pad_states
    d0, s0 = edotp.edge_dotprods_plain(o["child"], o["tips"], o["pm"],
                                       o["V"], o["Vinv"], o["pi"])
    d1, s1 = edotp.edge_dotprods_plain(
        o["child"], pad(o["tips"], NS, (1,)), pad(o["pm"], NS, (2, 3)),
        pad(o["V"], NS, (1, 2)), pad(o["Vinv"], NS, (1, 2)),
        pad(o["pi"], NS, (1,)))
    assert d1.shape[2] == NS and d0.dtype == torch.float64
    np.testing.assert_allclose(d1[:, :, :ns].numpy(), d0.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), rtol=0, atol=1e-12)
    assert float(d1[:, :, ns:].abs().max()) == 0.0


def test_ladder_read_from_the_kernel_sources():
    """The rungs and tiles come from csrc/ladder.cuh: seven rungs or
    fewer cover every ns from 2 to 32, 4, 12 and 20 are exact, a warp's
    tile divides the tips' padding and the edge kernels' tile divides
    32; past the top rung, 32, `rung` pads to a multiple of 16 (the big
    bodies' panel): 40 to 48, 60 to 64, 65 to 80."""
    assert {4, 12, 20} <= set(_build.LADDER)
    assert _build.LADDER[-1] == 32 and len(_build.LADDER) <= 7
    for ns in range(2, 33):
        NS = _build.rung(ns)
        assert NS >= ns and NS % 4 == 0
        assert clv_slots.TILE % _build.tile("slot", ns) == 0
        assert 32 % edotp.TILE[NS] == 0
        for family in ("slot", "batch", "edotp"):
            R, _ = _build.RUNGS[NS][family]
            assert 32 % (NS // R) == 0 and NS % R == 0
    assert edotp.geometry(32, 4, 4096)["tile"] == 8
    assert [_build.rung(ns) for ns in (33, 40, 48, 60, 64, 65)] == \
        [48, 48, 48, 64, 64, 80]
    assert not _build.is_big(32) and _build.is_big(48)


def test_big_constants_read_from_the_kernel_sources():
    """The big bodies' constants come from csrc/big.cuh (K3/K4) and
    csrc/big_ffma.cuh (K5): every literal `constexpr` of each reaches
    `_build.BIG` / `_build.BIG_FFMA` with its value; the derived sizes
    follow the headers' own expressions (a piece one m-tile by kBigChunk
    states, or for K5 one pair of m-tiles by 16, two mbarriers of 8
    bytes a stage); a warp's columns are whole n-tiles of the mma (8
    patterns), both tiles whole warps; the two-block line is half an
    SM's 233,472 bytes less the 1 KB the runtime keeps a block; the
    tile rule picks 32 patterns at 80 states and 16 at 160 (7 slots,
    C = 4); K5 takes four warps until its block passes MAX_BLOCK_SMEM
    and keeps V and V^-1 resident where two blocks still fit an SM."""
    import os
    import re

    def read(name, prefix):
        with open(os.path.join(os.path.dirname(_build.__file__), "..",
                               "csrc", name)) as fh:
            text = fh.read()
        return text, {k: int(v) for k, v in re.findall(
            r"constexpr (?:int|size_t) (%s\w+) = (\d+);" % prefix, text)}

    text, lits = read("big.cuh", "kBig")
    assert lits == _build.BIG and len(lits) >= 8
    assert _build.BIG_PANEL == lits["kBigPanel"] == 16
    assert _build.BIG_TILES == (lits["kBigTileWide"], lits["kBigTileNarrow"])
    assert "kBigPieceN = kBigPanel * kBigRowN" in text
    assert "kBigRowN = kBigChunk + kBigPadN" in text
    assert _build.BIG_PIECE_N == 16 * (_build.BIG_CHUNK + _build.BIG_PAD_N)
    assert "kBigBarFloats = 2 * kBigStages * 2" in text
    assert _build.BIG_BAR_FLOATS == 4 * _build.BIG_STAGES
    assert _build.BIG_WARP_COLS % 8 == 0 and 32 % _build.BIG_WARP_COLS == 0
    assert all(T % _build.BIG_WARP_COLS == 0 for T in _build.BIG_TILES)
    assert _build.BIG_CHUNK % 16 == 0 and _build.BIG_STAGES >= 2
    assert _build.BIG_TWO_BLOCKS == 233472 // 2 - 1024
    assert _build.BIG_CLUSTER_MAX == 8   # the portable cluster size
    # an operand's rows are 4 mod 8 floats: the fragment loads are free
    # of bank conflicts
    assert _build.BIG_PAD_N % 8 == 4
    assert _build.big_pass_tile(80, 4, 7) == 32
    assert _build.big_pass_tile(160, 4, 7) == 16
    text, lits = read("big_ffma.cuh", "kFfma")
    assert lits == _build.BIG_FFMA and len(lits) == 4
    assert _build.BIG_FFMA_WARP_COLS == lits["kFfmaWarpCols"] == 16
    assert _build.BIG_FFMA_MAX_WARPS == lits["kFfmaMaxWarps"] == 4
    assert _build.BIG_FFMA_PAIR == lits["kFfmaPair"] == 2 * _build.BIG_PANEL
    assert _build.BIG_FFMA_STAGES == lits["kFfmaStages"] >= 2
    assert "kFfmaItem = kFfmaPair * kBigPanel" in text
    assert "kFfmaBarFloats = 2 * kFfmaStages * 2" in text
    # four warps up to 208 states, then fewer as the warps' tiles grow
    assert [_build.big_edotp_warps(NS) for NS in (48, 80, 160, 208, 224,
                                                  512)] == [4, 4, 4, 4, 3, 1]
    # V and V^-1 resident where two blocks still fit an SM: 48 and 64
    assert [_build.big_edotp_resident(NS) for NS in (48, 64, 80, 160)] == \
        [True, True, False, False]


BIG_GEOMETRY_CASES = [33, 40, 60, 64, 65, 67, 72, 80, 100, 128, 160, 200,
                      240, 256]


@pytest.mark.parametrize("ns", BIG_GEOMETRY_CASES)
def test_big_bodies_geometry(ns):
    """The big bodies' launch shape past the ladder, as csrc/big.cuh and
    its kernels compute it, at C = 4 on a 128-taxon tree (8 slots, the
    worst a schedule of 128 taxa needs): ns padded to a multiple of the
    16-state m-tile; a tile of 32 patterns where the block then leaves
    two blocks an SM, else 16, which divides the tips' row padding; one
    warp per 8 patterns and one that stages the ring; K3/K4 a block a
    class, the classes of a tile one cluster; the block's shared memory
    (mbarriers, ring, slots, tip tiles and class terms) within
    MAX_BLOCK_SMEM; K5's block of up to four warps of 16 patterns and
    one that stages its ring, its shared memory (mbarriers, ring, V and
    V^-1 where resident, the warps' operand tiles) within
    MAX_BLOCK_SMEM; the streamed route."""
    from phyml_tpu_torch.ops.likelihood import kernel_route, \
        single_pass_kernel

    NS = _build.rung(ns)
    assert NS % _build.BIG_PANEL == 0 and ns <= NS < ns + _build.BIG_PANEL
    assert _build.is_big(NS)
    wide, narrow = _build.BIG_TILES
    for family in ("slot", "batch"):
        assert _build.tile(family, ns) == wide
    assert clv_slots.TILE % wide == 0 and clv_slots.TILE % narrow == 0
    T = _build.big_pass_tile(NS, 4, 8)
    assert T in (wide, narrow)
    assert (T == wide) == (_build.big_pass_smem(NS, 4, 8, wide)
                           <= _build.BIG_TWO_BLOCKS)
    for resident in (True, False):
        g = clv_slots.geometry(ns, 4, 4096, 128, 8, resident)
        assert g == clv.big_geometry(ns, 4, 4096, 8)
        # a block a class, the 4 classes of a tile one cluster
        assert g["tile"] == T and g["cluster"] == 4
        assert g["blocks"] == 4096 // T * 4
        # a warp per 8 columns, and the warp that stages the ring
        assert g["warps_per_block"] == T // _build.BIG_WARP_COLS + 1
        assert g["block_smem_bytes"] <= clv_slots.MAX_BLOCK_SMEM
        # mbarriers, the ring (stages x two plain pieces), 8 slots of T
        # pattern rows of NS + 4 and T scales, two tip tiles, class terms
        # (floats)
        ld = NS + 4
        assert g["block_smem_bytes"] == 4 * (
            4 * _build.BIG_STAGES + _build.BIG_STAGES * 2 * _build.BIG_PIECE_N
            + 8 * (T * ld + T) + 2 * T * ld + 4 * T)
    e = edotp.geometry(ns, 4, 4095)
    W = _build.big_edotp_warps(NS)
    assert 1 <= W <= 4
    # a warp per 16 patterns, and the warp that stages the ring
    T = 16 * W
    assert e["tile"] == edotp.TILE[ns] == _build.tile("edotp", ns) == T
    assert e["Pw"] == -(-4095 // T) * T and e["threads"] == 32 * (W + 1)
    assert e["blocks"] == e["Pw"] // T * 4
    assert e["smem_bytes"] <= clv_slots.MAX_BLOCK_SMEM
    # mbarriers, the ring (stages x two pieces of 32 x 16), V and V^-1
    # where resident (only where two blocks still fit an SM), each warp's
    # three tiles of (NS + 1) x 16 and one of NS x 16 (floats)
    res = _build.big_edotp_resident(NS)
    assert e["smem_bytes"] == 4 * (
        4 * _build.BIG_FFMA_STAGES + _build.BIG_FFMA_STAGES * 2 * 512
        + (2 * NS * NS if res else 0) + W * (3 * (NS + 1) + NS) * 16)
    assert not res or e["smem_bytes"] <= _build.BIG_TWO_BLOCKS
    # the most warps (up to 4) that fit
    assert W == 4 or 4 * _build.big_edotp_floats(NS, W + 1, False) > \
        clv_slots.MAX_BLOCK_SMEM
    # a node's partial, its scale and one of its child products a class
    assert e["workspace_floats_per_node"] == 4 * (2 * NS + 1) * e["Pw"]
    assert kernel_route(128, 4, ns) == ("K4", "K5")
    assert kernel_route(3, 4, ns) == ("K4", "K5")
    assert single_pass_kernel("K4", ns, 4, 128, 8) == "K4"


def test_big_geometry_every_state_count():
    """Every state count from 33, past the top rung, to 256: the padded
    width and the tiles as test_big_bodies_geometry, and K3/K4's block at
    8 slots and K5's within MAX_BLOCK_SMEM, on the streamed route."""
    from phyml_tpu_torch.ops.likelihood import kernel_route

    for ns in range(_build.LADDER[-1] + 1, 257):
        NS = _build.rung(ns)
        assert NS % 16 == 0 and ns <= NS < ns + 16
        assert clv_slots.TILE % _build.tile("slot", ns) == 0
        g = clv_slots.geometry(ns, 4, 1000, 128, 8, resident=False)
        assert g["block_smem_bytes"] <= clv_slots.MAX_BLOCK_SMEM
        assert clv_slots.TILE % g["tile"] == 0
        e = edotp.geometry(ns, 4, 1000)
        assert e["smem_bytes"] <= clv_slots.MAX_BLOCK_SMEM
        assert e["Pw"] % e["tile"] == 0 and 0 <= e["Pw"] - 1000 < e["tile"]
        assert kernel_route(128, 4, ns) == ("K4", "K5")


def test_k5_geometry_where_no_block_fits():
    """Past ~850 states not even one warp's tiles fit K5's big block:
    its geometry still reports a shape (a warp of 16 patterns and the
    staging warp) whose shared memory passes MAX_BLOCK_SMEM, which the
    launcher refuses and `_build.check` names, as at 1008 states."""
    assert _build.big_edotp_warps(848) == 0
    e = edotp.geometry(1000, 4, 100)
    assert e["tile"] == 16 and e["Pw"] == 112 and e["threads"] == 64
    assert e["smem_bytes"] > clv_slots.MAX_BLOCK_SMEM
    with pytest.raises(NotImplementedError, match="ns=1000, C=4"):
        _build.check(-1, "edge_dotprods_stream", 1000, C=4,
                     block_smem_bytes=e["smem_bytes"])


def test_past_the_top_rung_every_state_count_takes_the_big_bodies():
    """Every ns from 33, past the top rung, to 64 (once the ladder's
    top rungs) takes the streamed route to the big bodies on any
    tree: K4 for a single pass, K3/K4's block at 8 slots and K5's within
    MAX_BLOCK_SMEM; below, 12 states run a block of C class warps."""
    from phyml_tpu_torch.ops.likelihood import kernel_route, \
        single_pass_kernel

    for ns in range(_build.LADDER[-1] + 1, 65):
        NS = _build.rung(ns)
        assert _build.is_big(NS) and NS in (48, 64)
        for n in (3, 64, 128):
            assert kernel_route(n, 4, ns) == ("K4", "K5")
        assert single_pass_kernel("K4", ns, 4, 128, 8) == "K4"
        g = clv_slots.geometry(ns, 4, 4096, 128, 8, resident=False)
        assert g == clv.big_geometry(ns, 4, 4096, 8)
        assert g["block_smem_bytes"] <= clv_slots.MAX_BLOCK_SMEM
        e = edotp.geometry(ns, 4, 4096)
        assert e["smem_bytes"] <= clv_slots.MAX_BLOCK_SMEM
        assert e["warps_per_block"] == 4 + 1 and e["tile"] == 64
    g12 = clv_slots.geometry(12, 4, 4096, 128, 8, resident=False)
    assert g12["warps_per_block"] == 4 and g12["tile"] == 32
    # 12 states at 128 taxa: K1's whole-tree matrices pass 48 KiB a warp,
    # so the engine takes the streamed route
    assert kernel_route(128, 4, 12) == ("K4", "K5")
    assert kernel_route(128, 4, 2) == ("K1", "K2")


def test_search_and_bootstrap_sizes_read_the_true_state_count():
    """default_batch_k (the SPR block: it decides the search's
    trajectory) and rep_chunk_for (the rapid bootstrap's batch) take the
    engine's true ns, never the rung its kernels pad to: at 36 states a
    128-taxon, 272-pattern SPR block is 10 candidates (at 40, 9)."""
    o = _plain_operands(36)
    eng = o["eng"]
    assert eng.ns == 36 and eng.tips.shape[1] == 36
    rv = Topology.random(128, np.random.default_rng(0)).rooted()
    eng.n_nodes, eng.P, eng.C = 255, 272, 4
    assert tspr.default_batch_k(eng, rv) == 10
    eng.ns = 40
    assert tspr.default_batch_k(eng, rv) == 9
    eng.ns = 36
    per_rep = tsupport.REP_TENSORS * 255 * 4 * 36 * 272 * 8
    assert tsupport.rep_chunk_for(eng, 10 ** 6) == \
        int(tsupport.CPU_REP_BUDGET // per_rep)
