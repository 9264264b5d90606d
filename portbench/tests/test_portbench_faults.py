"""The comparison against faults planted under a run, on the CPU: the
harness past its look for a card, a small data set, the program in
float64.  A sound run comes out correct; each fault that a cell can
have comes out not correct, on the number that should catch it.  The
exchange between chips is no fault of these one-chip cells.

The control (the reference with TF32 contractions in the program's
place) is read at the cells' taxa on fewer sites and has to come out
not correct through the cells' own judging and limits."""

import copy
import time

import numpy as np
import pytest
import torch

from portbench import checks, gen, harness
from portbench.reference import lnl as L
from portbench.reference import models
from portbench.reference import nni as N

SMALL = {"nt": (16, 1000), "aa": (12, 400)}


# cells built and proven, held out of BENCHMARK.json until their host
# time is steady (PERF.md, Open questions)
HELD_OUT = [{"name": "nt120x10240.fit", "config": "nt120x10240-gtr-g4",
             "traffic": "fit", "chips": 1},
            {"name": "aa120x10240.fit", "config": "aa120x10240-lg-g4",
             "traffic": "fit", "chips": 1}]


def manifest():
    bench = harness.manifest()
    return dict(bench, workloads=bench["workloads"] + HELD_OUT)


def cells_of(mix):
    return [w["name"] for w in manifest()["workloads"]
            if w["traffic"] == mix]


FITS = cells_of("fit")
SUPPORTS = cells_of("abayes")


def run(cell_name, **kw):
    bench = manifest()
    cell, _, cfg, traffic, limits = harness.cell_of(bench, cell_name)
    cfg = copy.deepcopy(cfg)
    cfg["data"]["taxa"], cfg["data"]["sites"] = \
        SMALL[cfg["data"]["datatype"]]
    r = harness.run_cell(cell, cfg, traffic, limits, bench, 2 ** 32 + 9,
                         0.0, False, "cpu", time.perf_counter(),
                         warm=False, **kw)
    return r, limits


def over(r, name):
    c = r["compared"][name]
    return c["value"] > c["limit"]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- fits
@pytest.mark.parametrize("cell", FITS)
def test_fit_sound(cell, one_thread):
    r, _ = run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 1


@pytest.mark.parametrize("cell", FITS)
def test_fit_state_unchanged(cell, one_thread, monkeypatch):
    """Each step of the fit returns what it was given."""
    from phyml_tpu_torch.optim import round as rnd

    monkeypatch.setattr(rnd, "optimize_branch_lengths",
                        lambda eng, params, tree, **kw:
                        (tree, float(eng.loglik(params, tree))))
    monkeypatch.setattr(rnd, "optimize_scalars",
                        lambda eng, model, params, tree, lnl0=None, **kw:
                        (params, lnl0))
    r, _ = run(cell)
    assert not r["correct"] and over(r, "fit_gap")


def halved(w):
    """Half of the patterns left out, the mean taken over the rest."""
    keep = torch.zeros_like(w)
    keep[..., : w.shape[-1] // 2] = 2.0
    return w * keep


@pytest.mark.parametrize("cell", FITS)
def test_fit_half_the_batch(cell, one_thread, monkeypatch):
    from phyml_tpu_torch.ops.likelihood import LikelihoodEngine

    orig = LikelihoodEngine._w
    monkeypatch.setattr(LikelihoodEngine, "_w",
                        lambda self, w: halved(orig(self, w)))
    r, _ = run(cell)
    assert not r["correct"] and over(r, "fit_gap")


@pytest.mark.parametrize("cell", FITS)
def test_fit_answer_altered(cell, one_thread, monkeypatch):
    """The fitted tree leaves the optimiser with its longest branch five
    times as long."""
    from phyml_tpu_torch.optim import round as rnd

    orig = rnd.round_optimize

    def altered(*a, **kw):
        params, tree, lnl = orig(*a, **kw)
        blen = tree.blen.clone()
        blen[int(torch.argmax(blen))] *= 5.0
        return params, tree._replace(blen=blen), lnl

    monkeypatch.setattr(rnd, "round_optimize", altered)
    r, _ = run(cell)
    assert not r["correct"] and over(r, "fit_gap")


# ------------------------------------------------------------- supports
@pytest.mark.parametrize("cell", SUPPORTS)
def test_supports_sound(cell, one_thread):
    r, _ = run(cell)
    assert r["correct"] and r["failed"] == 0


@pytest.mark.parametrize("cell", SUPPORTS)
def test_supports_state_unchanged(cell, one_thread, monkeypatch):
    """The scorer's Newton steps return the lengths they were given."""
    from phyml_tpu_torch.search import nni

    monkeypatch.setattr(nni, "_newton", lambda eng, d, sc, aux, t, **k: t)
    r, _ = run(cell)
    assert not r["correct"] and over(r, "nni_gap")
    assert not over(r, "fit_gap")


@pytest.mark.parametrize("cell", SUPPORTS)
def test_supports_half_the_batch(cell, one_thread, monkeypatch):
    from phyml_tpu_torch.search import support

    orig = support.nni_scores

    def half(engine, params, ta, cand, weights=None, **kw):
        return orig(engine, params, ta, cand,
                    weights=halved(engine._w(weights)), **kw)

    monkeypatch.setattr(support, "nni_scores", half)
    r, _ = run(cell)
    assert not r["correct"] and over(r, "nni_gap")


@pytest.mark.parametrize("cell", SUPPORTS)
def test_supports_answer_altered(cell, one_thread, monkeypatch):
    """The most supported edge's aBayes support flipped to 1 - s."""
    from phyml_tpu_torch.search import support

    orig = support.alrt_supports

    def altered(*a, **kw):
        out = dict(orig(*a, **kw))
        e = max(out, key=out.get)
        out[e] = 1.0 - out[e]
        return out

    monkeypatch.setattr(support, "alrt_supports", altered)
    r, _ = run(cell)
    assert not r["correct"] and over(r, "nni_gap")


# -------------------------------------------------------------- control
@pytest.mark.parametrize("config,sites", [("nt120x10240-gtr-g4", 4096),
                                          ("aa120x10240-lg-g4", 1024)])
def test_control_fails_the_limits(config, sites, tmp_path, one_thread):
    """At the cells' 120 taxa on fewer sites, the control put in the
    program's place at the reference's optimum and judged as the harness
    judges (each cell's `control`, `judge`, its limits) comes out not
    correct: in the fit cell on `fit_gap`, in the supports cell on
    `nni_gap`.  The program's place is held by the reference itself, so
    the same judging reads it correct."""
    bench = manifest()
    cfg = harness.load_json(harness.ROOT, f"portbench/configs/{config}.json")
    cfg["data"]["sites"] = sites
    aln, tree = gen.write_problem(cfg, 5, str(tmp_path))
    data = L.data_of(aln, cfg)
    edges, blen = tree_arrays(cfg)
    # the reference's own optimum from the simulating point
    mod = models.of(cfg)
    x, _ = mod.truth(cfg["model"])
    _, lnl, (blen, x) = L.refine(cfg, data, edges, blen,
                                 mod.values(x, cfg["model"]))
    values = mod.values(x, cfg["model"])
    fit = {"lnl": lnl, "values": values, "edges": edges,
           "blen": np.asarray(blen, dtype=np.float64)}
    prefix = config.split("-")[0]
    memo = {}
    for mix, number, outputs, record in (
            ("fit", "fit_gap", [{"fit": fit}], None),
            ("abayes", "nni_gap", None, {"fit": fit})):
        cell, _, _, traffic, limits = harness.cell_of(bench,
                                                      f"{prefix}.{mix}")
        check = checks.check_of(traffic)
        if outputs is None:
            cand, eid, ref = check.reference_nni(cfg, data, fit, memo)
            outputs = [{"cand": cand, "nni_lnl": ref, "supports": dict(
                zip(eid.tolist(), N.abayes(ref).tolist()))}]
        sound = checks.verdict(
            *check.judge(cfg, data, outputs, record, memo), limits)
        c_out, c_rec = check.control(cfg, data, outputs, record, memo)
        ctl = checks.verdict(*check.judge(cfg, data, c_out, c_rec, memo),
                             limits)
        print(f"{config} at {sites} sites, {mix}: the reference "
              f"{sound['compared']}, the control {ctl['compared']}")
        assert sound["correct"]
        assert not ctl["correct"]
        assert ctl["compared"][number]["value"] > limits[number]


def tree_arrays(cfg):
    """The simulating tree of a configuration's data set."""
    rng = gen.rng_of(cfg["data"]["data_seed"])
    return gen.random_tree(cfg["data"]["taxa"], rng,
                           cfg["data"]["mean_branch_length"])
