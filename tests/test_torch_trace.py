"""The port's spans, counters and host reads (utils/trace.py), on the CPU.

* Under torch.profiler an `alrt_supports` call emits the NNI scorer's
  and the engine's spans, each nested in the span the table of
  utils/trace.py's callers gives it; the optimiser's spans nest the same
  way under `round_optimize`.
* With no profiler recording, no `record_function` is entered (it is
  patched to raise), and the supports are bit-identical to a traced
  call's.
* `host.syncs.<site>` and `host.d2h_bytes` equal a count by hand from
  the shapes read; the optimiser's counters agree with each other and
  with the line search's grid.
* `nni.state_flops` equals 2 x rows x C x ns^2 x P summed over the NNI
  scorer's dense products, 35 1/3 products of 3E rows a call, at 80
  states in one class (covarion) and 20 states in four (LG+G4).
* `model.system` spans the class system's construction while a
  profiler records, and only on a miss of the engine's cache; with none
  recording it enters no `record_function` and counts nothing.
* `cli.py --profile_out` on a CPU run writes a Chrome trace with the
  `phyml.cli.*` spans and the run's counters.
"""

import json

import numpy as np
import pytest
import torch

from phyml_tpu_torch import cli
from phyml_tpu_torch.evolve import simulate_alignment, write_phylip
from phyml_tpu_torch.io.alignment import read_alignment
from phyml_tpu_torch.models.substitution import SubstModel
from phyml_tpu_torch.ops.likelihood import LikelihoodEngine, tree_arrays
from phyml_tpu_torch.optim.blen import _N_NEWTON, optimize_branch_lengths
from phyml_tpu_torch.optim.round import free_scalar_slots, round_optimize
from phyml_tpu_torch.search.support import alrt_supports
from phyml_tpu_torch.topology import Topology
from phyml_tpu_torch.utils import trace

N_TAXA, N_SITES = 8, 120
F64 = 8

# each span of the scorer's call and its parent span
SCORER_PARENT = {
    "support.alrt": None,
    "nni.score": "support.alrt",
    "engine.pmats": "nni.score",
    "engine.up_pass": "nni.score",
    "engine.down_pass": "nni.score",
    "nni.outside": "nni.score",
    "nni.sweep": "nni.score",
    "nni.newton": "nni.sweep",
    "nni.final": "nni.score",
    "host.sync": "support.alrt",
    "model.system": "support.alrt",
}
# spans a call opens: two sweeps of four Newton solves; seven host
# reads (lnL, the four lengths, the site matrix, the weights)
SCORER_CALLS = {"nni.sweep": 2, "nni.newton": 8, "host.sync": 7}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread for the many small ops (as the search tests)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """(alignment path, tree path, engine, model, params, topology): 8
    taxa x 120 DNA sites simulated under GTR+G4 on a random tree, the
    engine float64 on the CPU."""
    rng = np.random.default_rng(11)
    model = SubstModel(datatype="nt", name="GTR", n_classes=4)
    params = model.init_params(np.full(4, 0.25))
    topo = Topology.random(N_TAXA, rng, mean_blen=0.15)
    names, seqs = simulate_alignment(topo, model, params, N_SITES, rng)
    d = tmp_path_factory.mktemp("trace")
    aln_path, tree_path = str(d / "aln.phy"), str(d / "tree.nwk")
    write_phylip(aln_path, names, seqs)
    with open(tree_path, "w") as fh:
        fh.write(topo.to_newick(names) + "\n")
    aln = read_alignment(aln_path, datatype="nt")
    topo = Topology.from_newick(open(tree_path).read(), aln.names)
    params = model.init_params(aln.obs_state_freqs)
    eng = LikelihoodEngine(aln, model, dtype=torch.float64, device="cpu")
    return aln_path, tree_path, eng, model, params, topo


def _profiled(fn):
    """(fn's result, {span name: [its parent span names]}) of one call
    under torch.profiler (CPU): the parent is the innermost enclosing
    `phyml.` span, None at the top."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    parents = {}
    for ev in prof.events():
        if not ev.name.startswith(trace.PREFIX):
            continue
        up = ev.cpu_parent
        while up is not None and not up.name.startswith(trace.PREFIX):
            up = up.cpu_parent
        parents.setdefault(ev.name[len(trace.PREFIX):], []).append(
            None if up is None else up.name[len(trace.PREFIX):])
    return out, parents


def test_scorer_and_engine_spans_nest_as_listed(problem):
    _, _, eng, model, params, topo = problem
    eng._sys_cache = None           # the call builds its class system
    _, parents = _profiled(
        lambda: alrt_supports(eng, model, params, topo, method="abayes"))
    assert set(parents) == set(SCORER_PARENT)
    for name, parent in SCORER_PARENT.items():
        assert parents[name] == [parent] * SCORER_CALLS.get(name, 1), name


def test_no_profiler_enters_no_record_function(problem, monkeypatch):
    _, _, eng, model, params, topo = problem
    traced, _ = _profiled(
        lambda: alrt_supports(eng, model, params, topo, method="abayes"))

    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    plain = alrt_supports(eng, model, params, topo, method="abayes")
    assert plain == traced          # bit-identical, edge by edge
    assert trace.span("nni.sweep") is trace.span("cli.read")


@pytest.mark.parametrize("method", ["abayes", "sh", "rell", "alrt-stat"])
def test_host_reads_by_hand(problem, method):
    _, _, eng, model, params, topo = problem
    E, P = N_TAXA - 3, eng.P
    before = trace.snapshot()
    alrt_supports(eng, model, params, topo, method=method)
    got = trace.since(before)
    # lnL [E, 3] float64, four lengths [E, 3] and the site matrix
    # [E, 3, P] in the engine's dtype, the weights [P] float64
    want = {"nni.lnl": 1, "nni.lengths": 4, "nni.site": 1,
            "support.weights": 1}
    nbytes = F64 * (E * 3 + 4 * E * 3 + E * 3 * P + P)
    if method in ("sh", "rell"):
        want["support.frac"] = 1            # the RELL fractions [E]
        nbytes += F64 * E
    assert got["host.syncs"] == sum(want.values())
    assert {k[len("host.syncs."):]: v for k, v in got.items()
            if k.startswith("host.syncs.")} == want
    assert got["host.d2h_bytes"] == nbytes
    assert not any(k.startswith("launch.") for k in got)   # plain versions


@pytest.fixture(scope="module")
def aa_problem(tmp_path_factory):
    """(alignment, topology): 8 taxa x 40 amino-acid sites simulated
    under LG+G4 on a random tree."""
    rng = np.random.default_rng(13)
    model = SubstModel(datatype="aa", name="LG", n_classes=4)
    params = model.init_params(np.full(20, 0.05))
    topo = Topology.random(N_TAXA, rng, mean_blen=0.15)
    names, seqs = simulate_alignment(topo, model, params, 40, rng)
    path = str(tmp_path_factory.mktemp("trace_aa") / "aln.phy")
    write_phylip(path, names, seqs)
    aln = read_alignment(path, datatype="aa")
    return aln, Topology.from_newick(topo.to_newick(names), aln.names)


@pytest.mark.parametrize("covarion, C, ns", [(True, 1, 80),
                                             (False, 4, 20)])
def test_state_flops_by_shape(aa_problem, covarion, C, ns):
    aln, topo = aa_problem
    model = SubstModel(datatype="aa", name="LG", n_classes=C,
                       covarion=covarion, n_hidden=4, cov_mode="alpha")
    params = model.init_params(aln.obs_state_freqs)
    eng = LikelihoodEngine(aln, model, dtype=torch.float64, device="cpu")
    assert (eng.C, eng.ns) == (C, ns)
    before = trace.snapshot()
    alrt_supports(eng, model, params, topo, method="abayes")
    E, P = N_TAXA - 3, eng.P
    # G (E rows) and 35 products of 3E rows: 15 a sweep, 5 at the end
    assert trace.since(before)["nni.state_flops"] == \
        (2 * E + 35 * 2 * 3 * E) * C * ns * ns * P


@pytest.mark.parametrize("recording", [True, False])
def test_model_system_span(problem, monkeypatch, recording):
    _, _, eng, model, params, topo = problem
    eng._sys_cache = None
    before = trace.snapshot()
    if recording:
        _, parents = _profiled(lambda: [eng.system_of(params)
                                        for _ in range(2)])
        assert parents == {"model.system": [None]}     # one miss, one hit
    else:
        def refuse(*a, **kw):
            raise AssertionError("record_function entered with no "
                                 "profiler")

        monkeypatch.setattr(torch.profiler, "record_function", refuse)
        eng.system_of(params)
    assert trace.since(before) == {}


def test_branch_length_counters_agree(problem):
    _, _, eng, model, params, topo = problem
    ta = tree_arrays(topo.rooted(), dtype=torch.float64, device="cpu")
    before = trace.snapshot()
    optimize_branch_lengths(eng, params, ta)
    got = trace.since(before)
    assert got["blen.rounds"] >= 1
    assert got["blen.newton_iters"] == _N_NEWTON * got["blen.rounds"]
    # one lnL at the start, one probe a round and one a backtrack
    assert got["host.syncs.blen.start"] == 1
    assert got["host.syncs.blen.probe"] == \
        got["blen.rounds"] + got.get("blen.backtracks", 0)
    assert got["host.d2h_bytes"] == F64 * got["host.syncs"]


def test_round_optimize_spans_and_counters(problem):
    _, _, eng, model, params, topo = problem
    ta = tree_arrays(topo.rooted(), dtype=torch.float64, device="cpu")
    before = trace.snapshot()
    _, parents = _profiled(lambda: round_optimize(
        eng, model, params, ta, max_rounds=2))
    got = trace.since(before)
    rounds, zooms = got["round.rounds"], got["round.zooms"]
    assert set(parents["round.round"]) == {None}
    assert len(parents["round.round"]) == rounds
    assert set(parents["blen.optimize"]) == {"round.round"}
    assert set(parents["blen.round"]) == {"blen.optimize"}
    assert set(parents["blen.newton"]) == {"blen.round"}
    assert set(parents["round.scalars"]) == {"round.round"}
    assert parents["round.zoom"] == ["round.scalars"] * zooms
    assert set(parents["host.sync"]) == {None, "blen.optimize",
                                         "blen.round", "round.zoom"}
    # each zoom scores its grid, n slots x (grid + 1) rows; each probe
    # past one a zoom is a pair (the joint and the single best move)
    n = len(free_scalar_slots(model, params))
    probes = got["host.syncs.round.probes"]
    assert got["round.probe_rows"] == \
        zooms * n * (12 + 1) + 2 * (probes - zooms)
    assert zooms <= probes <= 2 * zooms
    assert len(parents["blen.round"]) == got["blen.rounds"]


@pytest.mark.parametrize("optimize, spans", [
    ("lr", {"cli.read", "cli.engine", "cli.start", "cli.fit",
            "cli.supports", "cli.output"}),
    ("tlr", {"cli.read", "cli.engine", "cli.start", "cli.search",
             "cli.supports", "cli.output"}),
])
def test_profile_out_writes_spans_and_counters(problem, tmp_path,
                                               optimize, spans):
    aln_path, tree_path = problem[:2]
    out = tmp_path / "run.json"
    argv = ["-i", aln_path, "-m", "GTR", "-c", "4", "-o", optimize,
            "-b", "-5", "--platform", "cpu", "--quiet", "--r_seed", "3",
            "--profile_out", str(out)]
    if optimize == "lr":
        argv += ["-u", tree_path]
    assert cli.main(argv) == 0
    doc = json.loads(out.read_text())
    names = {ev["name"][len("phyml."):] for ev in doc["traceEvents"]
             if ev.get("cat") == "user_annotation"
             and ev["name"].startswith("phyml.")}
    assert {n for n in names if n.startswith("cli.")} == spans
    assert {"support.alrt", "nni.score", "host.sync"} <= names
    counters = doc["phyml_counters"]
    assert counters["round.rounds"] >= 1
    assert counters["host.syncs.nni.site"] >= 1
    assert counters["host.syncs"] == sum(
        v for k, v in counters.items() if k.startswith("host.syncs."))


def test_counters_are_read_as_differences():
    before = trace.snapshot()
    trace.count("launch.K3")
    trace.count("launch.K3.batch.13", 2)
    assert trace.since(before) == {"launch.K3": 1, "launch.K3.batch.13": 2}
    assert trace.since(trace.snapshot()) == {}


def test_profiled_counts_only_what_a_profiler_saw(problem):
    """`profiled()` takes what was counted while a profiler recorded:
    a support call under the profiler adds its counts there as to the
    registry, one outside it adds nothing there."""
    _, _, eng, model, params, topo = problem
    seen, before = trace.profiled(), trace.snapshot()
    alrt_supports(eng, model, params, topo, method="abayes")
    assert trace.profiled() == seen
    mid = trace.snapshot()
    _profiled(lambda: alrt_supports(eng, model, params, topo,
                                    method="abayes"))
    after = trace.profiled()
    moved = {k: v - seen.get(k, 0) for k, v in after.items()
             if v != seen.get(k, 0)}
    assert moved == trace.since(mid)
    assert moved["host.syncs"] == 7
    assert trace.since(before)["host.syncs"] == 14


def _x(name, ts, dur, cat="user_annotation", corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": 1}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_program_spans_tool_reads_a_trace_by_hand(tmp_path):
    """tools/program_spans.py's reader on a synthetic trace: a support
    call, its scorer, one sweep with one Newton solve, a host read; four
    device operations, each launched under another innermost span."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "program_spans.py")
    spec = importlib.util.spec_from_file_location("program_spans", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    events = [_x("pb.window", 0, 1000), _x("aten::mul", 395, 10, "cpu_op"),
              _x("phyml.support.alrt", 5, 985),
              _x("phyml.nni.score", 10, 890),
              _x("phyml.nni.sweep", 100, 400),
              _x("phyml.nni.newton", 150, 150),
              _x("phyml.host.sync", 920, 60),
              _x("phyml.nni.sweep", 100, 400, "gpu_user_annotation")]
    for corr, (t, name, start, dur, cat) in enumerate([
            (160, "multiply", 170, 100, "kernel"),
            (400, "sum", 410, 50, "kernel"),
            (610, "slot_kernel", 605, 10, "kernel"),
            (925, "Memcpy DtoH (Device -> Pageable)", 930, 40,
             "gpu_memcpy")]):
        events += [_x("cudaLaunchKernel", t, 2, "cuda_runtime", corr),
                   _x(name, start, dur, cat, corr)]
    p = tmp_path / "unit.json"
    p.write_text(json.dumps({"traceEvents": events}))
    rows, whole = tool.read_trace(str(p))
    # host: alrt 5-10, 900-920, 980-990; score 10-100, 500-900; sweep
    # 100-150, 300-500; newton 150-300; host.sync 920-980.  Busy
    # 170-270, 410-460, 605-615, 930-970; idle by the innermost span
    # over it: outside 0-5 and 990-1000, host.sync 920-930 and 970-980.
    want = {"support.alrt": [0.035, 0.0, 0, 0.035],
            "nni.score": [0.49, 0.01, 1, 0.48],
            "nni.sweep": [0.25, 0.05, 1, 0.2],
            "nni.newton": [0.15, 0.1, 1, 0.05],
            "host.sync": [0.06, 0.04, 1, 0.02],
            "outside": [0.0, 0.0, 0, 0.015]}
    assert set(rows) == set(want)
    for span, row in want.items():
        assert rows[span] == pytest.approx(row), span
    assert whole["busy_s"] == pytest.approx(200e-6)
    assert whole["launches"] == 4
    assert whole["sync_wait_ms"] == pytest.approx(0.06)
    assert whole["newton_share"] == pytest.approx(50.0)
    assert whole["dispatch_idle"] == pytest.approx(76.5)
    assert whole["copies_ms"] == {
        "host.sync: Memcpy DtoH (Device -> Pageable)": pytest.approx(0.04)}
