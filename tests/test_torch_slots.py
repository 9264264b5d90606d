"""The slot kernels' route (K1, K4) through the engine against
phyml_tpu, the slot count the engine passes them, their launch geometry
and the wrappers' contract.

Engine: the host lnL (`loglik`, `site_logliks`) and `_loglik_sys` with
one system (the branch-length probes), which both take the route's
slot kernel (on the CPU its plain version), against phyml_tpu's
`site_logliks` / `loglik` (its scan path), both in float64 on the same
alignment, tree and parameters, at 4 and 20 states, one and four rate
classes, on a caterpillar (one slot, rewritten in place every step), a
balanced tree (the most slots: 3 at 16 taxa) and a random one.
Tolerance 1e-6 on per-site and total lnL: float64 roundoff over ~100
patterns, the two sides rescaling differently.
"""

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
from phyml_tpu_torch.ops import clv, clv_slots, likelihood
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine

LNL_TOL = 1e-6
N_TAXA, N_SITES = 16, 110


def _balanced_newick(lo, hi):
    if hi - lo == 1:
        return f"t{lo}:0.11"
    mid = (lo + hi) // 2
    return (f"({_balanced_newick(lo, mid)},{_balanced_newick(mid, hi)})"
            ":0.07")


def _topology(shape, rng):
    names = [f"t{i}" for i in range(N_TAXA)]
    if shape == "caterpillar":
        return Topology.caterpillar(N_TAXA, blen=0.09)
    if shape == "balanced":
        return Topology.from_newick(_balanced_newick(0, N_TAXA) + ";", names)
    return Topology.random(N_TAXA, rng, mean_blen=0.12)


def _problem(datatype, C, shape, seed=0):
    """float64 engines on both sides, one parameter set (random
    frequencies, and rates and shape where the model has them)."""
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
    jta = jtree_arrays(_topology(shape, rng).rooted(), dtype=jnp.float64)
    tta = tree_arrays_from_numpy(np.asarray(jta.child), np.asarray(jta.blen),
                                 device="cpu", dtype=torch.float64)
    jp = jm.init_params(rng.dirichlet(np.full(ns, 8.0)))
    if "rr_val" in jp:
        jp["rr_val"] = jnp.log(jnp.asarray(rng.uniform(0.5, 4.0, 6)))
    if "alpha" in jp:
        jp["alpha"] = jnp.asarray(rng.uniform(0.3, 2.0))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    return jeng, jta, jp, teng, tta, tp, jaln.n_patterns


@pytest.mark.parametrize("shape", ["caterpillar", "balanced", "random"])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("datatype", ["nt", "aa"])
def test_engine_slot_route_matches_phyml_tpu(datatype, C, shape):
    """site_logliks, loglik and the unbatched _loglik_sys (all through
    the slot kernels' plain version) against phyml_tpu."""
    jeng, jta, jp, teng, tta, tp, k = _problem(datatype, C, shape)
    _, _, n_slots = teng._topology(tta.child)
    assert n_slots == {"caterpillar": 1, "balanced": 3}.get(shape, n_slots)
    want_site = np.asarray(jeng.site_logliks(jp, jta))[:k]
    want = float(jeng.loglik(jp, jta))
    np.testing.assert_allclose(teng.site_logliks(tp, tta).numpy(),
                               want_site, rtol=0, atol=LNL_TOL)
    assert abs(float(teng.loglik(tp, tta)) - want) < LNL_TOL
    sysv = teng.system_of(tp)
    np.testing.assert_allclose(teng._site_logliks_sys(sysv, tta).numpy(),
                               want_site, rtol=0, atol=LNL_TOL)
    assert abs(float(teng._loglik_sys(sysv, tta)) - want) < LNL_TOL


@pytest.mark.parametrize("datatype", ["nt", "aa"])
@pytest.mark.parametrize("shape", ["caterpillar", "balanced", "random"])
def test_engine_passes_the_schedules_own_slot_count(monkeypatch, shape,
                                                    datatype):
    """The host lnL and one system's _loglik_sys hand the slot kernel
    build_slot_schedule's own slot count (the kernels size their shared
    memory by it), not the engine's bound; a batch goes to K3."""
    _, jta, _, teng, tta, tp, _ = _problem(datatype, 4, shape, seed=1)
    seen = []

    def spy(fn):
        def wrapped(*args, n_slots, **kw):
            seen.append((fn.__name__, n_slots))
            return fn(*args, n_slots=n_slots, **kw)
        return wrapped

    for name in ("uppass_site_lse_slots", "uppass_site_lse_slots_stream"):
        monkeypatch.setattr(likelihood, name,
                            spy(getattr(clv_slots, name)))
    k3 = []
    monkeypatch.setattr(likelihood, "uppass_site_lse",
                        lambda *a, **kw: k3.append(1) or
                        clv.uppass_site_lse(*a, **kw))
    _, own = clv_slots.build_slot_schedule(N_TAXA, np.asarray(jta.child))
    assert own < teng.slot_count
    teng.loglik(tp, tta)
    sysv = teng.system_of(tp)
    teng._loglik_sys(sysv, tta)
    route = {"K1": "uppass_site_lse_slots",
             "K4": "uppass_site_lse_slots_stream"}[teng.lnl_route]
    assert seen == [(route, own), (route, own)] and not k3
    teng._loglik_sys(tuple(torch.stack([x, x]) for x in sysv), tta)
    assert len(seen) == 2 and k3 == [1]


def test_both_wrappers_run_the_plain_version_on_cpu_tensors():
    ops = _operands()
    want = clv_slots.uppass_site_lse_slots_plain(**ops)
    for f in (clv_slots.uppass_site_lse_slots,
              clv_slots.uppass_site_lse_slots_stream):
        n0 = f.launches
        torch.testing.assert_close(f(**ops), want, rtol=0, atol=0)
        assert f.launches == n0


def _operands(n=8, ns=4, P=33, C=4, dtype=torch.float64):
    """Slot-kernel operands for a random n-taxon tree on the CPU."""
    rng = np.random.default_rng(3)
    child = np.asarray(Topology.random(n, rng).rooted().child,
                       dtype=np.int32)
    sched, n_slots = clv_slots.build_slot_schedule(n, child)
    pm = torch.as_tensor(rng.dirichlet(np.ones(ns), (2 * n - 1, C, ns)),
                         dtype=dtype)
    return dict(sched=torch.as_tensor(sched),
                tips=torch.as_tensor(rng.random((n, ns, P)), dtype=dtype),
                pmats=pm, pi=torch.full((C, ns), 1.0 / ns, dtype=dtype),
                logw=torch.full((C,), np.log(1.0 / C), dtype=dtype),
                n_slots=n_slots)


@pytest.mark.parametrize("change,match", [
    (lambda o: dict(o, sched=o["sched"][:, :6]), "inconsistent"),
    (lambda o: dict(o, pmats=o["pmats"][:-1]), "inconsistent"),
    (lambda o: dict(o, pi=o["pi"][:1]), "inconsistent"),
    (lambda o: dict(o, logw=o["logw"][:2]), "inconsistent"),
    (lambda o: dict(o, n_slots=0), "n_slots=0"),
    (lambda o: dict(o, n_slots=o["n_slots"] - 1), "does not fit"),
    (lambda o: dict(o, sched=o["sched"].index_fill(1, torch.tensor([0]),
                                                   40)), "does not fit"),
], ids=["columns", "pmats", "pi", "logw", "no-slots", "slot-index",
        "node-index"])
@pytest.mark.parametrize("stream", [False, True])
def test_wrappers_reject_bad_operands(stream, change, match):
    f = clv_slots.uppass_site_lse_slots_stream if stream \
        else clv_slots.uppass_site_lse_slots
    with pytest.raises(ValueError, match=match):
        f(**change(_operands()))


@pytest.mark.parametrize("change,match", [
    (lambda o: dict(o, tips=o["tips"].double()), "float32"),
    (lambda o: dict(o, sched=o["sched"].long()), "int32"),
    (lambda o: dict(o, tips=o["tips"].to("meta")), "float32 tensor on cpu"),
    (lambda o: dict(o, pmats=o["pmats"].transpose(2, 3)),
     "contiguous=False"),
], ids=["float64", "int64-schedule", "tips-device", "strided-pmats"])
def test_launch_rejects_what_the_kernels_do_not_take(change, match):
    """The launch path checks dtype, device and contiguity before it
    loads the kernel library (the CPU never reaches a kernel); tips of
    any strides are taken (slot_tips pads them)."""
    ops = change(_operands(dtype=torch.float32))
    n_slots = ops.pop("n_slots")
    with pytest.raises(ValueError, match=match):
        clv_slots._launch_slots("phyml_slot_site_lse",
                                "uppass_site_lse_slots", *ops.values(),
                                n_slots)


@pytest.mark.parametrize("P", [1, 31, 33, 64])
def test_padded_tips(P):
    """The slot kernels' tips: the same values, rows a whole number of
    32-pattern tiles apart (16-byte aligned), padding ones; the wrappers
    give the same result on the view as on the contiguous tips."""
    ops = _operands(P=P)
    view = clv_slots.padded_tips(ops["tips"])
    assert view.shape == ops["tips"].shape and bool((view == ops["tips"]).all())
    ldt = view.stride(1)
    assert ldt % 32 == 0 and P <= ldt < P + 32
    assert view.stride() == (4 * ldt, ldt, 1)
    assert bool((view.as_strided((8, 4, ldt), view.stride())[..., P:] == 1)
                .all())
    want = clv_slots.uppass_site_lse_slots_plain(**ops)
    got = clv_slots.uppass_site_lse_slots(**dict(ops, tips=view))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("layout,copied", [
    ("contiguous-whole-tiles", False), ("padded-view", False),
    ("contiguous-odd", True), ("strided", True), ("misaligned", True)])
def test_slot_tips_pads_only_tips_the_kernels_cannot_read(layout, copied):
    """slot_tips passes tips whose rows are padded as the kernels read
    them and pads any other tips (a copy), with the same values."""
    P = 64 if layout == "contiguous-whole-tiles" else 33
    tips = _operands(P=P, dtype=torch.float32)["tips"]
    if layout == "padded-view":
        tips = clv_slots.padded_tips(tips)
    elif layout == "strided":
        tips = tips.transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "misaligned":
        store = torch.ones(8 * 4 * 64 + 1)[1:].view(8, 4, 64)  # 4 B off
        store[..., :P] = tips
        tips = store[..., :P]
    got = clv_slots.slot_tips(tips)
    assert (got is not tips) == copied
    assert bool((got == tips).all())
    ldt = got.stride(1)
    assert got.stride() == (4 * ldt, ldt, 1) and ldt % 4 == 0
    assert ldt >= -(-P // 32) * 32 and got.data_ptr() % 16 == 0


@pytest.mark.parametrize("ns,P", [(4, 3767), (20, 3945), (4, 1), (20, 33)])
def test_geometry(ns, P):
    """One block of C warps per 32-pattern tile; a warp's shared memory
    is its P-matrix part plus the tip ring and the slots (the schedule
    stays in device memory), and a block holds C of them and C x 32
    class terms."""
    n, C, n_slots = 128, 4, 4
    for resident in (True, False):
        g = clv_slots.geometry(ns, C, P, n, n_slots, resident)
        T, S = g["tile"], clv_slots.STAGES
        assert T == clv_slots.TILE == 32
        assert g["blocks"] == -(-P // T)
        pm = (2 * n - 2) * ns * ns if resident else 2 * S * ns * ns
        floats = pm + 2 * S * ns * T + n_slots * (ns + 1) * T
        assert g["warp_smem_bytes"] == 4 * floats
        assert g["warp_smem_bytes"] % 16 == 0
        assert g["block_smem_bytes"] == C * (g["warp_smem_bytes"] + 4 * T)
    if P > 1000:  # the bench shapes: 118 and 124 blocks of 4 warps
        assert g["blocks"] == {4: 118, 20: 124}[ns]


def test_resident_route_follows_the_warp_budget():
    """kernel_route keeps K1/K2 while K1's shared memory per warp (at the
    schedule's worst-case slot count) fits RESIDENT_WARP_BYTES and its
    block of C warps fits a block; 128-taxon DNA is resident, 128-taxon
    protein streamed (its matrices alone, 408 KB a class, exceed a
    block's 227 KB)."""
    for n, ns, C in [(8, 20, 4), (16, 20, 4), (32, 20, 1), (128, 4, 4),
                     (256, 4, 8), (512, 4, 1), (2048, 4, 4), (128, 20, 4)]:
        slots = int(np.ceil(np.log2(n))) + 1
        g = clv_slots.geometry(ns, C, 1, n, slots, True)
        fits = g["warp_smem_bytes"] <= likelihood.RESIDENT_WARP_BYTES \
            and g["block_smem_bytes"] <= clv_slots.MAX_BLOCK_SMEM
        want = ("K1", "K2") if fits else ("K4", "K5")
        assert likelihood.kernel_route(n, C, ns) == want
    assert likelihood.kernel_route(128, 4, 4) == ("K1", "K2")
    assert likelihood.kernel_route(128, 4, 20) == ("K4", "K5")
    assert clv_slots.geometry(20, 4, 1, 128, 8, True)["warp_smem_bytes"] \
        > clv_slots.MAX_BLOCK_SMEM


@pytest.mark.parametrize("route,ns,C,n,n_slots,want", [
    ("K4", 20, 8, 16, 1, "K4"), ("K4", 20, 8, 16, 2, "K3"),
    ("K4", 20, 4, 4096, 12, "K4"), ("K4", 20, 4, 4096, 13, "K3"),
    ("K4", 4, 4, 6500, 12, "K4"), ("K1", 4, 4, 128, 8, "K1")])
def test_single_pass_kernel_follows_the_block_budget(route, ns, C, n,
                                                     n_slots, want):
    """A single-system pass takes the route's slot kernel while its
    block of C warps fits shared memory at the schedule's own slot
    count, whatever the tree's size; else K3 at B = 1."""
    assert likelihood.single_pass_kernel(route, ns, C, n, n_slots) == want
    g = clv_slots.geometry(ns, C, 1, n, n_slots, route == "K1")
    assert (g["block_smem_bytes"] <= clv_slots.MAX_BLOCK_SMEM) == \
        (want != "K3")


@pytest.mark.parametrize("datatype,n", [("nt", 6500), ("aa", 3000)])
def test_trees_of_thousands_of_taxa_keep_the_streamed_kernel(datatype, n):
    """A random tree of thousands of taxa needs few slots, so K4 takes
    its single passes at four classes."""
    ns = 4 if datatype == "nt" else 20
    child = np.asarray(Topology.random(n, np.random.default_rng(17))
                       .rooted().child, dtype=np.int32)
    _, n_slots = clv_slots.build_slot_schedule(n, child)
    assert likelihood.kernel_route(n, 4, ns) == ("K4", "K5")
    assert likelihood.single_pass_kernel("K4", ns, 4, n, n_slots) == "K4"


@pytest.mark.parametrize("shape,want", [("caterpillar", "K4"),
                                        ("balanced", "K3")])
def test_engine_at_eight_protein_classes(monkeypatch, shape, want):
    """At 20 states and 8 classes K4's block holds a one-slot schedule
    only: the caterpillar's single passes take K4, the balanced tree's
    K3 at B = 1; both agree with phyml_tpu."""
    jeng, jta, jp, teng, tta, tp, k = _problem("aa", 8, shape)
    assert teng.lnl_route == "K4"
    ran = []
    monkeypatch.setattr(likelihood, "uppass_site_lse_slots_stream",
                        lambda *a, **kw: ran.append("K4") or
                        clv_slots.uppass_site_lse_slots_stream(*a, **kw))
    monkeypatch.setattr(likelihood, "uppass_site_lse",
                        lambda *a, **kw: ran.append("K3") or
                        clv.uppass_site_lse(*a, **kw))
    want_site = np.asarray(jeng.site_logliks(jp, jta))[:k]
    np.testing.assert_allclose(teng.site_logliks(tp, tta).numpy(),
                               want_site, rtol=0, atol=LNL_TOL)
    sysv = teng.system_of(tp)
    np.testing.assert_allclose(teng._site_logliks_sys(sysv, tta).numpy(),
                               want_site, rtol=0, atol=LNL_TOL)
    assert ran == [want, want]
