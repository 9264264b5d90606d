"""The port's --distributed path against phyml_tpu, on the CPU.

Each configuration runs once, as a world of spawned processes joined
with gloo through a file under the test's tmp directory (one torch
thread a rank, a join timeout in the parent that kills the world on
overrun); the module-scoped fixture of a world does all of its work, and
each check below is its own test.  The inputs are tests/test_multichip.py's
toy problem (12 taxa, 200 random DNA sites, GTR+G4, seed 3), built here
with phyml_tpu and handed to the ranks as numpy arrays; everything in
float64 unless stated:

* 1 x 4 sites mesh (`sharded_engine`): the host lnL against phyml_tpu's
  sharded engine on 4 virtual CPU devices and its unsharded one (1e-9),
  the gathered `site_logliks` (1e-9 a site), `optimize_branch_lengths
  (max_rounds=3)` (lnL 1e-8 against phyml_tpu's; lengths 1e-8 against
  the port's unsharded engine: ROADMAP.md Queue 3), `nni_round` (the
  same swap count, lnL 1e-7), +I with the zero-weight padding (finite, 1e-9), and
  float32 K3 per shard on 10 taxa x 150 sites against phyml_tpu's
  sharded Pallas kernel in interpret mode (5e-3 total), the single pass
  at B = 1 through K3 and never K1;
* 2 x 2 mesh: a replicate-weight batch [4, P] split over the boot axis
  against phyml_tpu's per-replicate lnL (1e-9);
* 2 ranks: `run_bootstrap_distributed` with 6 replicates equals
  phyml_tpu's serial `bootstrap_supports(seed=11)` exactly;
* 2 ranks: the CLI's `--distributed -b 2` writes phyml_tpu.cli's tree
  and supports (rank 0 only).

The workers import only the port (this module imports JAX inside the
tests alone).
"""

import multiprocessing
import os
import time

import numpy as np
import pytest
import torch

LNL_TOL = 1e-9
SITE_TOL = 1e-9
BLEN_TOL = 1e-8
NNI_TOL = 1e-7
F32_TOL = 5e-3     # tests/test_multichip.py:176
WORLD_TIMEOUT_S = 240


# ----------------------------------------------------------------------
# the ranks' side (spawned; the port only)
# ----------------------------------------------------------------------
def _port_problem(spec, invar=False):
    """The port's alignment, model, parameters and topology of a spec
    built by _toy_spec."""
    from phyml_tpu_torch.interop import params_from_numpy
    from phyml_tpu_torch.io.alignment import compact
    from phyml_tpu_torch.models.substitution import SubstModel
    from phyml_tpu_torch.topology import Topology

    states = spec["states"]
    n_otu, n_sites = states.shape
    enc = np.zeros((n_otu, n_sites, 4), dtype=np.float32)
    for i in range(n_otu):
        enc[i, np.arange(n_sites), states[i]] = 1.0
    aln = compact(enc, [f"t{i}" for i in range(n_otu)], "nt")
    model = SubstModel(datatype="nt", name="GTR", n_classes=4, invar=invar,
                       **spec.get("model_kw", {}))
    params = params_from_numpy(spec["invar_params" if invar else "params"])
    topo = Topology(n_otu, np.asarray(spec["edges"]),
                    np.asarray(spec["blen"]))
    return aln, model, params, topo


def _sites_world(spec):
    """1 x 4: the sharded engine's entry points (float64), +I, and K3
    per shard in float32 with the kernels it chose recorded."""
    from phyml_tpu_torch.ops import likelihood as lk
    from phyml_tpu_torch.optim.blen import optimize_branch_lengths
    from phyml_tpu_torch.parallel.mesh import make_mesh, sharded_engine
    from phyml_tpu_torch.search.nni import nni_round

    f64 = dict(dtype=torch.float64, device="cpu")
    mesh = make_mesh(1, 4)
    aln, model, params, topo = _port_problem(spec["toy"])
    eng = sharded_engine(aln, model, mesh, dtype=torch.float64,
                         device="cpu")
    tree = lk.tree_arrays(topo.rooted(), **f64)
    out = {"lnl": float(eng.loglik(params, tree)),
           "site": eng.site_logliks(params, tree).numpy(),
           "P_local": eng.P}
    tree3, out["blen_lnl"] = optimize_branch_lengths(eng, params, tree,
                                                     max_rounds=3)
    out["blen"] = tree3.blen.numpy()
    _, out["nni_lnl"], out["nni_n"] = nni_round(eng, params, topo.copy())

    aln, model, params, topo = _port_problem(spec["toy"], invar=True)
    eng = sharded_engine(aln, model, mesh, dtype=torch.float64,
                         device="cpu")
    tree = lk.tree_arrays(topo.rooted(), **f64)
    out["invar_lnl"] = float(eng.loglik(params, tree))
    d, sc_d, aux = eng.edge_dotprods_sys(eng.system_of(params), tree)
    site, d1, d2 = eng.edge_site_terms(d, sc_d, aux, tree.blen[:, None])
    out["invar_terms_finite"] = bool(torch.isfinite(site).all()
                                     and torch.isfinite(d1).all()
                                     and torch.isfinite(d2).all())

    calls = []
    k3, k1 = lk.uppass_site_lse, lk.uppass_site_lse_slots

    def spy_k3(child, tips, pmats, *a, **kw):
        calls.append(("K3", pmats.shape[0] if pmats.dim() == 5 else 1))
        return k3(child, tips, pmats, *a, **kw)

    def spy_k1(*a, **kw):
        calls.append(("K1", 1))
        return k1(*a, **kw)

    lk.uppass_site_lse, lk.uppass_site_lse_slots = spy_k3, spy_k1
    try:
        aln, model, params, topo = _port_problem(spec["small"])
        eng = sharded_engine(aln, model, mesh, dtype=torch.float32,
                             device="cpu")
        tree = lk.tree_arrays(topo.rooted(), dtype=torch.float32,
                              device="cpu")
        out["f32_lnl"] = float(eng.loglik(params, tree))
        out["f32_route"] = (eng.lnl_route, calls)
    finally:
        lk.uppass_site_lse, lk.uppass_site_lse_slots = k3, k1
    return out


def _boot_world(spec):
    """2 x 2: lnL [R] of replicate weights [R, P] on one tree."""
    from phyml_tpu_torch.ops.likelihood import tree_arrays
    from phyml_tpu_torch.parallel.mesh import make_mesh, sharded_engine

    mesh = make_mesh(2, 2)
    aln, model, params, topo = _port_problem(spec["toy"])
    eng = sharded_engine(aln, model, mesh, dtype=torch.float64,
                         device="cpu")
    tree = tree_arrays(topo.rooted(), dtype=torch.float64, device="cpu")
    wmat = torch.as_tensor(spec["wmat"], dtype=torch.float64)
    lnl = eng._loglik_sys(eng.system_of(params), tree, wmat)
    return {"lnl": lnl.numpy()}


def _farm_world(spec):
    """2 ranks: the farmed bootstrap on the searched tree."""
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine
    from phyml_tpu_torch.parallel.boot import run_bootstrap_distributed

    aln, model, params, topo = _port_problem(spec["farm"])
    eng = LikelihoodEngine(aln, model, dtype=torch.float64, device="cpu")
    return {"support": run_bootstrap_distributed(
        eng, model, params, topo, n_replicates=spec["R"], seed=11)}


def _cli_world(spec):
    """2 ranks: the CLI with --distributed, each on its own copy of the
    input."""
    import torch.distributed as dist

    from phyml_tpu_torch import cli

    d = os.path.join(spec["dir"], f"rank{dist.get_rank()}")
    rc = cli.main(["-i", os.path.join(d, "aln.phy"), *spec["argv"],
                   "--distributed"])
    return {"rc": rc, "files": sorted(os.listdir(d))}


_WORLDS = {"sites": _sites_world, "boot": _boot_world,
           "farm": _farm_world, "cli": _cli_world}


def _rank_main(rank, world, init_file, job, spec, out_prefix):
    """One rank: join the gloo world, run its job, save its result."""
    import torch.distributed as dist

    from phyml_tpu_torch.parallel.boot import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(init_method=f"file://{init_file}", rank=rank,
                           world_size=world, on_card=False, timeout_s=120)
    try:
        res = _WORLDS[job](spec)
        torch.save(res, f"{out_prefix}{rank}.pt")
    finally:
        dist.destroy_process_group()


def _run_world(job, world, spec, tmp):
    """Every rank's result of one spawned world, in rank order; the
    world is killed if it outlives WORLD_TIMEOUT_S."""
    ctx = multiprocessing.get_context("spawn")
    prefix = str(tmp / f"{job}_rank")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(tmp / f"{job}.init"), job, spec,
                               prefix))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + WORLD_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.time()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    assert not alive, f"the {job} world outlived {WORLD_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * world, \
        f"{job} world exit codes {[p.exitcode for p in procs]}"
    return [torch.load(f"{prefix}{r}.pt", weights_only=False)
            for r in range(world)]


# ----------------------------------------------------------------------
# phyml_tpu's side and the worlds (JAX imported inside only)
# ----------------------------------------------------------------------
def _toy_spec(n_otu=12, n_sites=200, seed=3):
    """tests/test_multichip.py's _toy, as phyml_tpu builds it, plus the
    numpy arrays a rank rebuilds it from."""
    from phyml_tpu.io.alignment import compact
    from phyml_tpu.models.substitution import SubstModel
    from phyml_tpu.topology import Topology

    rng = np.random.default_rng(seed)
    states = rng.integers(0, 4, size=(n_otu, n_sites))
    enc = np.zeros((n_otu, n_sites, 4), dtype=np.float32)
    for i in range(n_otu):
        enc[i, np.arange(n_sites), states[i]] = 1.0
    aln = compact(enc, [f"t{i}" for i in range(n_otu)], "nt")
    model = SubstModel(datatype="nt", name="GTR", n_classes=4)
    topo = Topology.random(n_otu, rng)
    params = model.init_params(aln.obs_state_freqs)
    imodel = SubstModel(datatype="nt", name="GTR", n_classes=4, invar=True)
    iparams = imodel.init_params(aln.obs_state_freqs)
    iparams["pinv"] = np.asarray(0.2)
    spec = {"states": states, "edges": np.asarray(topo.edges),
            "blen": np.asarray(topo.blen),
            "params": {k: np.asarray(v) for k, v in params.items()},
            "invar_params": {k: np.asarray(v) for k, v in iparams.items()}}
    return spec, (aln, model, topo, params, imodel, iparams)


@pytest.fixture(scope="module")
def toy():
    return _toy_spec()


@pytest.fixture(scope="module")
def sites_world(toy, tmp_path_factory):
    small, _ = _toy_spec(n_otu=10, n_sites=150)
    spec = {"toy": toy[0], "small": small}
    return _run_world("sites", 4, spec, tmp_path_factory.mktemp("sites"))


def _jax_engine(aln, model, **kw):
    import jax.numpy as jnp
    from phyml_tpu.ops.likelihood import LikelihoodEngine

    return LikelihoodEngine(aln, model, dtype=jnp.float64, **kw)


def _jax_tree(topo, dtype=None):
    import jax.numpy as jnp
    from phyml_tpu.ops.likelihood import tree_arrays

    return tree_arrays(topo.rooted(), dtype=dtype or jnp.float64)


def test_sharded_lnl_equals_phyml_tpu(toy, sites_world):
    import jax
    import jax.numpy as jnp
    from phyml_tpu.parallel.mesh import make_mesh, sharded_engine

    aln, model, topo, params = toy[1][:4]
    ref = float(_jax_engine(aln, model).loglik(params, _jax_tree(topo)))
    mesh = make_mesh(1, 4, devices=jax.devices()[:4])
    jsh = float(sharded_engine(aln, model, mesh, dtype=jnp.float64)
                .loglik(params, _jax_tree(topo)))
    for res in sites_world:
        assert res["P_local"] == 128    # 200 patterns padded to 4 x 128
        assert res["lnl"] == pytest.approx(jsh, abs=LNL_TOL)
        assert res["lnl"] == pytest.approx(ref, abs=LNL_TOL)


def test_sharded_site_logliks_gathered(toy, sites_world):
    aln, model, topo, params = toy[1][:4]
    ref = np.asarray(_jax_engine(aln, model).site_logliks(
        params, _jax_tree(topo)))[:aln.n_patterns]
    for res in sites_world:
        assert res["site"].shape == (aln.n_patterns,)
        np.testing.assert_allclose(res["site"], ref, atol=SITE_TOL, rtol=0)


def test_sharded_blen_round_matches(toy, sites_world):
    """Three parallel-Newton rounds: the lnL of phyml_tpu's and of the
    port's unsharded engine, and the port's unsharded lengths.  (Both
    packages' unsharded lengths part by 5.1e-5 on two edges of this flat
    optimum in the third round, their lnL within 4e-12: ROADMAP.md
    Queue 3.)"""
    from phyml_tpu.optim.blen import optimize_branch_lengths
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
    from phyml_tpu_torch.optim.blen import (
        optimize_branch_lengths as port_optimize,
    )

    aln, model, topo, params = toy[1][:4]
    _, lnl = optimize_branch_lengths(_jax_engine(aln, model), params,
                                     _jax_tree(topo), max_rounds=3)
    taln, tmodel, tparams, ttopo = _port_problem(toy[0])
    eng = LikelihoodEngine(taln, tmodel, dtype=torch.float64, device="cpu")
    tree, tlnl = port_optimize(eng, tparams, tree_arrays(
        ttopo.rooted(), dtype=torch.float64, device="cpu"), max_rounds=3)
    for res in sites_world:
        assert res["blen_lnl"] == pytest.approx(lnl, abs=BLEN_TOL)
        assert res["blen_lnl"] == pytest.approx(tlnl, abs=BLEN_TOL)
        np.testing.assert_allclose(res["blen"], tree.blen.numpy(),
                                   atol=BLEN_TOL, rtol=0)


def test_sharded_nni_round(toy, sites_world):
    from phyml_tpu.search.nni import nni_round

    aln, model, topo, params = toy[1][:4]
    _, lnl, n = nni_round(_jax_engine(aln, model), params, topo.copy())
    for res in sites_world:
        assert res["nni_n"] == n
        assert res["nni_lnl"] == pytest.approx(lnl, abs=NNI_TOL)


def test_sharded_invariant_padding_stays_finite(toy, sites_world):
    """+I: the zero-weight padding patterns (tips 1, not invariant)
    reach no result."""
    aln, topo = toy[1][0], toy[1][2]
    imodel, iparams = toy[1][4:]
    ref = float(_jax_engine(aln, imodel).loglik(iparams, _jax_tree(topo)))
    for res in sites_world:
        assert np.isfinite(res["invar_lnl"]) and res["invar_terms_finite"]
        assert res["invar_lnl"] == pytest.approx(ref, abs=LNL_TOL)


def test_k3_per_shard_matches_sharded_pallas(sites_world):
    """float32, 10 taxa x 150 sites: the per-shard pass against
    phyml_tpu's Pallas kernel under shard_map in interpret mode; the
    DNA route is K1, yet a sharded engine's single passes all run K3 at
    B = 1."""
    import jax
    import jax.numpy as jnp
    from phyml_tpu.parallel.mesh import make_mesh, sharded_engine

    _, (aln, model, topo, params, _, _) = _toy_spec(n_otu=10, n_sites=150)
    mesh = make_mesh(1, 4, devices=jax.devices()[:4])
    eng = sharded_engine(aln, model, mesh, dtype=jnp.float32,
                         use_pallas=True)
    assert eng.pallas_interpret
    lnl = float(eng.loglik(params, _jax_tree(topo, jnp.float32)))
    for res in sites_world:
        assert res["f32_lnl"] == pytest.approx(lnl, abs=F32_TOL)
        route, calls = res["f32_route"]
        assert route == "K1" and calls == [("K3", 1)]


def test_boot_axis_replicate_batch(toy, tmp_path):
    """2 x 2: replicate weights [4, P] split by rows over the boot axis
    and by columns over the sites axis; every rank holds the lnL [4]."""
    aln, model, topo, params = toy[1][:4]
    rng = np.random.default_rng(7)
    wmat = np.stack([aln.resample_weights(rng) for _ in range(4)])
    jeng = _jax_engine(aln, model)
    tree = _jax_tree(topo)
    import jax.numpy as jnp
    serial = [float(jeng.loglik(params, tree, jnp.asarray(np.pad(
        w, (0, jeng.P - w.shape[0]))))) for w in wmat]
    spec = {"toy": toy[0], "wmat": wmat}
    for res in _run_world("boot", 4, spec, tmp_path):
        np.testing.assert_allclose(res["lnl"], serial, atol=LNL_TOL, rtol=0)


def test_farmed_bootstrap_equals_serial(tmp_path):
    """Per-replicate seeds: 6 replicates farmed over 2 ranks (0, 2, 4 |
    1, 3, 5) give phyml_tpu's serial counts exactly, on every rank.  The
    model's parameters are held (as tests/test_torch_support.py does), so
    each replicate's search fits lengths and topology only."""
    from phyml_tpu.models.substitution import SubstModel
    from phyml_tpu.search.driver import nni_search
    from phyml_tpu.search.support import bootstrap_supports

    spec, (aln, _, topo, params, _, _) = _toy_spec(8, 120, seed=5)
    spec["model_kw"] = dict(optimize_rr=False, optimize_alpha=False)
    model = SubstModel(datatype="nt", name="GTR", n_classes=4,
                       **spec["model_kw"])
    eng = _jax_engine(aln, model)
    topo, params, _ = nni_search(eng, model, params, topo, opt_params=False)
    serial = bootstrap_supports(eng, model, params, topo, n_replicates=6,
                                seed=11)
    spec.update(edges=np.asarray(topo.edges), blen=np.asarray(topo.blen),
                params={k: np.asarray(v) for k, v in params.items()})
    for res in _run_world("farm", 2, {"farm": spec, "R": 6}, tmp_path):
        assert res["support"] == serial


def test_cli_distributed_bootstrap_matches_phyml_tpu(tmp_path, monkeypatch):
    """`--distributed -b 2` over 2 gloo ranks: rank 0 writes phyml_tpu.cli
    `-b 2`'s tree (supports included) and rank 1 writes nothing."""
    from phyml_tpu import cli as jcli
    from phyml_tpu.evolve import write_phylip
    from phyml_tpu.topology import Topology
    from test_torch_bionj import _simulate

    names, seqs, _ = _simulate("nt", n_taxa=8, n_sites=150)
    argv = ["-m", "GTR", "-c", "4", "-b", "2", "--platform", "cpu",
            "--r_seed", "1", "--quiet"]
    for sub in ("jax", "rank0", "rank1"):
        (tmp_path / sub).mkdir()
        write_phylip(str(tmp_path / sub / "aln.phy"), names, seqs)
    assert jcli.main(["-i", str(tmp_path / "jax" / "aln.phy"), *argv]) == 0
    res = _run_world("cli", 2, {"dir": str(tmp_path), "argv": argv},
                     tmp_path)
    assert [r["rc"] for r in res] == [0, 0]
    assert res[1]["files"] == ["aln.phy"]
    assert "aln.phy_phyml_tree.txt" in res[0]["files"]
    jtree = (tmp_path / "jax" / "aln.phy_phyml_tree.txt").read_text()
    ttree = (tmp_path / "rank0" / "aln.phy_phyml_tree.txt").read_text()
    jt, tt = (Topology.from_newick(t, names) for t in (jtree, ttree))
    assert tt.rf_distance(jt) == 0
    labels = _supports_by_clade(ttree, names)
    assert len(labels) == len(names) - 3 and None not in labels.values()
    assert labels == _supports_by_clade(jtree, names)


def _supports_by_clade(newick, names):
    """{bipartition (the side without the first taxon): support label}
    of a written tree's internal edges."""
    from phyml_tpu_torch.io.newick import parse_newick

    root = parse_newick(newick)
    out = {}

    def leaves(node):
        if node.is_leaf:
            return {node.name}
        below = set().union(*(leaves(c) for c in node.children))
        if node is not root:
            side = below if names[0] not in below else set(names) - below
            out[frozenset(side)] = node.support or node.name
        return below

    leaves(root)
    return out


def test_replicate_shard_and_sum_single_process():
    """Round robin over ranks; the count sum is the identity in one
    process; make_mesh without a group is the 1 x 1 mesh."""
    from phyml_tpu_torch.parallel.boot import (
        _sum_across_processes, initialize_distributed, replicate_shard,
    )
    from phyml_tpu_torch.parallel.mesh import (
        boot_sharding, make_mesh, padded_pattern_count, pattern_sharding,
    )

    assert replicate_shard(7, 1, 3) == [1, 4]
    assert sorted(replicate_shard(6, 0, 2) + replicate_shard(6, 1, 2)) \
        == list(range(6))
    x = np.array([1.0, 2.0, 3.0])
    np.testing.assert_array_equal(_sum_across_processes(x), x)
    mesh = make_mesh()
    assert mesh.shape == {"boot": 1, "sites": 1}
    assert pattern_sharding(mesh, 256) == slice(0, 256)
    assert boot_sharding(mesh, 5) == slice(0, 5)
    # no shard ever holds the alignment's pattern count (_w's rule)
    assert padded_pattern_count(200, 4) == 512
    assert padded_pattern_count(128, 2) == 512
    if "WORLD_SIZE" not in os.environ:
        assert initialize_distributed() == (0, 1)
