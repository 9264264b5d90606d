"""The SLFV event-disk model (bayes/slfv.py) against phyml_tpu on the
CPU.

States are simulated with numpy from one seed (10 lineages, D = 2, the
SLFV parameters of tests/test_slfv_joint.py) and carried across with
interop.slfv_state_from_numpy / slfv_params_from_numpy.  Held:
slfv_loglik (float64 torch, euclidean and great-circle) and _loglik_np
within 1e-10 relative of phyml_tpu's; simulate_slfv, state_from_
timetree and state_to_timetree (with its node map, on multi-mergers
too) equal; slfv_param_mcmc's trace draw for draw; SLFVDensity's
incremental total against a full recompute after every accepted move
of 20 sweeps (disk and hit inserts and deletes among them); and
SLFVJointSampler with a sequence likelihood (float64 engines, HKY85
on 300 sites), 30 sweeps from one seed: the same tries and accepts per
move, the same disk count and genealogy, lp and the state within 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phyml_tpu.bayes import slfv as jsl
from phyml_tpu.evolve import simulate_alignment, write_phylip
from phyml_tpu.io.alignment import read_alignment as jread
from phyml_tpu.models.substitution import SubstModel as JModel
from phyml_tpu.ops.likelihood import LikelihoodEngine as JEngine
from phyml_tpu.topology import Topology as JTopology
from phyml_tpu_torch.bayes import slfv as tsl
from phyml_tpu_torch.bayes.chrono import TimeTree as TTimeTree
from phyml_tpu_torch.interop import (
    params_from_numpy, slfv_params_from_numpy, slfv_state_from_numpy,
)
from phyml_tpu_torch.io.alignment import read_alignment as tread
from phyml_tpu_torch.models.substitution import SubstModel as TModel
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine as TEngine

REL = 1e-10
STATE_TOL = 1e-8
TRUE = dict(lbda=0.8, mu=0.7, rad=1.2, lim_lo=(0.0, 0.0), lim_up=(6.0, 6.0),
            dist_type="euclidean")
FIELDS = ("coord", "h_node", "parent", "h_disk", "centr", "hit")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_state(js):
    return slfv_state_from_numpy({"n_otu": js.n_otu,
                                  **{f: getattr(js, f) for f in FIELDS}})


def _same_state(a, b, tol=0.0):
    assert a.n_otu == b.n_otu
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape, f
        np.testing.assert_allclose(x, y, rtol=tol, atol=tol, err_msg=f)


@pytest.fixture(scope="module")
def sim():
    """(phyml_tpu params, port params, phyml_tpu state, port state)."""
    jp = jsl.SLFVParams(**TRUE)
    js = jsl.simulate_slfv(10, jp, np.random.default_rng(4))
    return jp, slfv_params_from_numpy(TRUE), js, _port_state(js)


def _rel(a, b):
    a, b = float(a), float(b)
    assert abs(a - b) <= REL * max(1.0, abs(a), abs(b)), (a, b)


@pytest.mark.parametrize("dist", ["euclidean", "greatcircle"])
def test_densities_match(sim, dist):
    """slfv_loglik (torch) and _loglik_np against phyml_tpu's, at the
    simulating parameters and at moved ones, and slfv_loglik's
    gradient in the coordinates is finite (the torch form is
    differentiable)."""
    jp, tp, js, ts = sim
    for kw in ({}, {"mu": 0.3, "rad": 2.5, "lbda": 0.2}):
        kw = {**kw, "dist_type": dist}
        jq = jsl.SLFVParams(**{**TRUE, **kw})
        tq = slfv_params_from_numpy({**TRUE, **kw})
        want = float(jsl.slfv_loglik(js, jq))
        _rel(tsl.slfv_loglik(ts, tq), want)
        _rel(tsl._loglik_np(ts, tq), jsl._loglik_np(js, jq))
        _rel(tsl._loglik_np(ts, tq), want)
    coord = torch.tensor(ts.coord, requires_grad=True)
    lnl = tsl.slfv_loglik(tsl.SLFVState(**{**vars(ts), "coord": coord}), tp)
    (g,) = torch.autograd.grad(lnl, coord)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    # a lineage outside the habitat is rejected
    out = _port_state(js)
    out.coord[0, 0] = 100.0
    assert float(tsl.slfv_loglik(out, tp)) == tsl.NEG_INF


def test_simulation_and_tree_conversions_match(sim):
    """simulate_slfv from one numpy seed, state_to_timetree (a
    3-way merger included) and state_from_timetree: equal states,
    trees and node maps."""
    jp, tp, js, ts = sim
    _same_state(tsl.simulate_slfv(10, tp, np.random.default_rng(4)), js)
    for st_j in (js, _multi_merger()):
        st_t = _port_state(st_j)
        jt, jn = jsl.state_to_timetree(st_j, return_node_map=True)
        tt, tn = tsl.state_to_timetree(st_t, return_node_map=True)
        assert isinstance(tt, TTimeTree)
        np.testing.assert_array_equal(tt.child, jt.child)
        np.testing.assert_array_equal(tt.heights, jt.heights)
        np.testing.assert_array_equal(tn, jn)
    jt = jsl.state_to_timetree(js)
    tt = tsl.state_to_timetree(ts)
    coords = js.coord[:js.n_otu]
    _same_state(tsl.state_from_timetree(tt, coords, np.random.default_rng(3)),
                jsl.state_from_timetree(jt, coords, np.random.default_rng(3)))


def _multi_merger():
    """4 tips: one disk hits three lineages, then the root joins."""
    return jsl.SLFVState(
        n_otu=4,
        coord=np.array([[1.0, 1.0], [2.0, 1.5], [1.5, 2.0], [4.0, 4.0],
                        [1.6, 1.4], [3.0, 3.0]]),
        h_node=np.array([0.0, 0.0, 0.0, 0.0, 0.7, 1.9]),
        parent=np.array([4, 4, 4, 5, 5, -1]),
        h_disk=np.array([0.3, 0.7, 1.9]),
        centr=np.array([[5.0, 5.0], [1.5, 1.5], [3.0, 3.0]]),
        hit=np.array([-1, 4, 5]))


def test_param_mcmc_matches(sim):
    jp, tp, js, ts = sim
    jc, jtr = jsl.slfv_param_mcmc(js, jp, n_iter=60, seed=5)
    tc, ttr = tsl.slfv_param_mcmc(ts, tp, n_iter=60, seed=5)
    np.testing.assert_allclose(ttr, jtr, rtol=REL, atol=0)
    assert (tc.lbda, tc.mu, tc.rad) == pytest.approx((jc.lbda, jc.mu, jc.rad),
                                                     rel=REL)


def test_incremental_density_stays_exact(sim):
    """The port's sampler without sequences, 20 sweeps: after every
    accepted move the cached SLFVDensity total equals a full
    _loglik_np recompute (the audit's check, made at every accept), and
    the disk count moved (inserts and deletes happened)."""
    _, tp, _, ts = sim
    smp = tsl.SLFVJointSampler(ts, tp, seed=7)
    seen = set()
    accept = smp._accept

    def audited(*a, **k):
        ok = accept(*a, **k)
        if ok:
            full = tsl._loglik_np(smp.state, smp.params)
            assert abs(smp._dc.total() - full) <= 1e-9 * max(1.0, abs(full))
            seen.add(smp.state.n_disks)
        return ok

    smp._accept = audited
    for _ in range(20):
        smp.sweep()
    assert len(seen) > 2
    assert smp.accepts["indel_disk"] > 0 and smp.accepts["indel_hit"] > 0


@pytest.fixture(scope="module")
def coupled(tmp_path_factory):
    """(state, params, phyml_tpu seq_fn, port seq_fn, clock): an
    8-lineage SLFV history, HKY85 sequences (300 sites) simulated down
    its tree at clock 0.02, both packages' float64 engines."""
    rng = np.random.default_rng(11)
    jp = jsl.SLFVParams(**TRUE)
    st = jsl.simulate_slfv(8, jp, rng)
    tt = jsl.state_to_timetree(st)
    topo = JTopology.from_newick(tt.to_newick(), tt.names)
    topo.blen *= 0.02
    m = JModel(datatype="nt", name="HKY85", n_classes=1)
    names, seqs = simulate_alignment(topo, m, m.init_params(np.ones(4) / 4),
                                     300, rng)
    path = str(tmp_path_factory.mktemp("slfv") / "aln.phy")
    write_phylip(path, names, seqs)
    jaln, taln = jread(path, datatype="nt"), tread(path, datatype="nt")
    assert list(jaln.names) == list(names) == list(taln.names)
    jeng = JEngine(jaln, m, dtype=jnp.float64, use_pallas=False)
    jparams = m.init_params(jaln.obs_state_freqs)
    tm = TModel(datatype="nt", name="HKY85", n_classes=1)
    teng = TEngine(taln, tm, dtype=torch.float64, device="cpu")
    tparams = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()})
    return (st, jp, jsl.make_seq_loglik_fn(jeng, jparams),
            tsl.make_seq_loglik_fn(teng, tparams), 0.02)


def test_seq_loglik_matches(coupled):
    st, _, jfn, tfn, clock = coupled
    for c in (clock, 0.05):
        _rel(tfn(_port_state(st), c), jfn(st, c))


def test_joint_sampler_matches_draw_for_draw(coupled):
    """30 sweeps of SLFVJointSampler with the sequence likelihood from
    one seed in each package: the same move order, tries and accepts,
    disk count and genealogy; lp, clock and the state within 1e-8."""
    st, jp, jfn, tfn, clock = coupled
    js = jsl.SLFVJointSampler(st, jp, seed=2, seq_fn=jfn, clock0=clock)
    ts = tsl.SLFVJointSampler(_port_state(st), slfv_params_from_numpy(TRUE),
                              seed=2, seq_fn=tfn, clock0=clock)
    for _ in range(30):
        js.sweep()
        ts.sweep()
        assert ts.tries == js.tries and ts.accepts == js.accepts
        assert ts.state.n_disks == js.state.n_disks
        np.testing.assert_array_equal(ts.state.parent, js.state.parent)
        np.testing.assert_array_equal(ts.state.hit, js.state.hit)
        assert abs(ts.lp - js.lp) <= STATE_TOL * max(1.0, abs(js.lp))
    _same_state(ts.state, js.state, STATE_TOL)
    assert ts.clock == pytest.approx(js.clock, rel=STATE_TOL)
    assert ts.seq_lnl == pytest.approx(js.seq_lnl, rel=STATE_TOL)
    assert sum(js.accepts.values()) > 60
    assert js.accepts["clock"] > 0 and js.tries["exchange"] > 0
