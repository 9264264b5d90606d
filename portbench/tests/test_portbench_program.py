"""The readers of the program's own counters (`portbench/program.py`):
by hand on a synthetic trace; every earlier reader, and the breakdown,
read the same with the program's spans in the trace as without them; a
program without the counters gives no reading; the counters read are
those of the profiled window; and a traced run on the CPU reports the
host reads a support call makes."""

import collections
import copy
import json
import os
import sys
import time

import pytest
import torch

from portbench import harness, program, registry
from portbench import trace as T

NEW = ("syncs.supports", "d2h_mib.supports")


def _x(name, ts, dur, cat="user_annotation", **args):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": 1}
    if args:
        ev["args"] = args
    return ev


def _launch(corr, ts, kernel, k_ts, k_dur, cat="kernel"):
    return [_x("cudaLaunchKernel", ts, 2, "cuda_runtime", correlation=corr),
            {"ph": "X", "cat": cat, "name": kernel, "ts": k_ts,
             "dur": k_dur, "args": {"correlation": corr}}]


HARNESS_EVENTS = (
    [_x("pb.window", 0, 1000), _x("pb.unit", 1, 998),
     _x("pb.scan", 390, 20), _x("pb.pruning", 600, 50),
     _x("aten::mul", 395, 10, "cpu_op")]
    + _launch(1, 160, "multiply", 170, 100)
    + _launch(2, 400, "sum", 410, 50)
    + _launch(3, 610, "phyml::slot_kernel", 605, 10)
    + _launch(4, 925, "Memcpy DtoH (Device -> Pageable)", 930, 40,
              "gpu_memcpy"))
# the program's spans: a support call, its scorer, one sweep, one
# Newton solve, a host read
PROGRAM_EVENTS = [
    _x("phyml.support.alrt", 5, 985), _x("phyml.nni.score", 10, 890),
    _x("phyml.nni.sweep", 100, 400), _x("phyml.nni.newton", 150, 150),
    _x("phyml.host.sync", 920, 60),
    _x("phyml.nni.sweep", 100, 400, "gpu_user_annotation")]


def _trace(tmp_path, events, spans=None, name="t.json", units=1):
    spans = spans or T.Spans()
    p = tmp_path / name
    p.write_text(json.dumps({"traceEvents": events}))
    return T.Trace(str(p), spans, units=units, peak=3 * 2 ** 30)


def _harness_spans():
    spans = T.Spans()
    spans.calls["scan"] = 1
    spans.work["pruning"].append((67e12 * 2e-6, 0))
    spans.work["edge"].append((0, 3.35e12 * 1e-6))
    return spans


@pytest.fixture
def window_counts(monkeypatch):
    """The program's profiled counts, fresh: as in a run, whose traced
    window is its process's only profiled one."""
    from phyml_tpu_torch.utils import trace as counters

    fresh = collections.Counter()
    monkeypatch.setattr(counters, "_profiled", fresh)
    return fresh


def test_program_readers_by_hand(tmp_path, window_counts):
    window_counts.update({"host.syncs": 14, "host.syncs.nni.site": 2,
                          "host.d2h_bytes": 6 * 2 ** 20})
    tr = _trace(tmp_path, HARNESS_EVENTS + PROGRAM_EVENTS,
                _harness_spans(), units=2)
    got = {m: registry.load("metrics", m).read(tr) for m in NEW}
    assert got["syncs.supports"] == 7
    assert got["d2h_mib.supports"] == pytest.approx(3.0)


def test_earlier_readers_ignore_the_program(tmp_path, window_counts):
    """Every reader the benchmark had, the breakdown, the idle gaps by
    the harness's spans, busy and window: the same with the program's
    spans and counters as without them."""
    bench = harness.manifest()
    earlier = sorted(f[:-3] for f in os.listdir(os.path.join(harness.HERE,
                                                             "metrics"))
                     if f.endswith(".py") and f[:-3] not in NEW)
    assert "scan_share.supports" in earlier and len(earlier) == 14
    bare = _trace(tmp_path, HARNESS_EVENTS, _harness_spans(), "bare.json")
    window_counts.update({"host.syncs": 7})
    full = _trace(tmp_path, HARNESS_EVENTS + PROGRAM_EVENTS,
                  _harness_spans())
    for m in earlier:
        read = registry.load("metrics", m).read
        assert read(full) == read(bare), m
    assert full.breakdown() == bare.breakdown()
    assert full.idle_by_span == bare.idle_by_span
    assert (full.busy_s, full.window_s) == (bare.busy_s, bare.window_s)
    assert full.ops == bare.ops
    assert {m["name"] for m in bench["per_layer"]} >= set(NEW)


@pytest.mark.parametrize("lacks", ["module", "profiled"])
def test_no_program_counters_read_nothing(tmp_path, monkeypatch, lacks):
    """A program without the counters' module, or with one that keeps
    no profiled counts: no reading, and no error."""
    import phyml_tpu_torch.utils
    from phyml_tpu_torch.utils import trace as counters

    if lacks == "module":
        monkeypatch.delattr(phyml_tpu_torch.utils, "trace")
        monkeypatch.setitem(sys.modules, "phyml_tpu_torch.utils.trace",
                            None)
    else:
        monkeypatch.delattr(counters, "profiled")
    tr = _trace(tmp_path, HARNESS_EVENTS, _harness_spans())
    assert program.counts() is None
    for m in NEW:
        assert registry.load("metrics", m).read(tr) is None, m


def test_counts_are_the_profiled_windows(window_counts):
    """What the program counts outside the profiler is not read; what
    it counts while the profiler records is."""
    from phyml_tpu_torch.utils import trace as counters

    counters.count("host.syncs", 5)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        counters.count("host.syncs", 3)
        counters.to_host(torch.zeros(4, dtype=torch.float64), "test")
    counters.count("host.d2h_bytes", 99)
    assert program.counts() == {"host.syncs": 4, "host.syncs.test": 1,
                                "host.d2h_bytes": 32}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_traced_cpu_run_reports_the_host_reads(one_thread, tmp_path,
                                               window_counts):
    """A traced support run of the DNA cell at 12 taxa x 300 sites on
    the CPU (float64): seven host reads a unit, and their bytes by hand
    from the shapes (the site matrix [E, 3, P], lnL and four lengths
    [E, 3], the weights [P])."""
    from phyml_tpu_torch.io.alignment import read_alignment
    from portbench import gen

    bench = harness.manifest()
    cell, _, cfg, traffic, limits = harness.cell_of(bench,
                                                    "nt120x10240.abayes")
    cfg = copy.deepcopy(cfg)
    cfg["data"]["taxa"], cfg["data"]["sites"] = 12, 300
    seed = 2 ** 32 + 9
    r = harness.run_cell(cell, cfg, traffic, limits, bench, seed, 0.0,
                         True, "cpu", time.perf_counter(), warm=False)
    assert r["correct"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    aln, _ = gen.write_problem(cfg, seed, str(tmp_path))
    E, P = 12 - 3, read_alignment(aln, datatype="nt").n_patterns
    assert got["syncs.supports"] == 7
    assert got["d2h_mib.supports"] * 2 ** 20 == \
        8 * (E * 3 * (1 + 4 + P) + P)
