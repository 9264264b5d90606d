"""Work counts by hand on a four-taxon tree, and the roofline reader:
the same work for a pass whatever kernel ran it."""

import json

import pytest
import torch

from portbench import trace as T
from portbench import work


def test_pruning_flops_by_hand():
    # 4 taxa: 7 nodes, 6 non-root pushes, 3 internal products; C = 2
    # classes, ns = 4, P = 10 patterns, B = 3 sets
    n_otu, C, ns, P, B = 4, 2, 4, 10, 3
    per = 6 * (2 * 4 * 4) + 3 * 4
    assert work.pruning_flops(n_otu, C, ns, P, B) == B * C * P * per


def test_edotp_flops_by_hand():
    # 4 taxa: 6 pushes up, 2 parent matvecs down, 2 x 6 projections;
    # products: 3 + 2 x 3 + 6 elementwise of ns
    n_otu, C, ns, P = 4, 1, 20, 7
    matvecs = 6 + 2 + 12
    prods = 3 + 6 + 6
    assert work.edotp_flops(n_otu, C, ns, P) == C * P * (
        2 * ns * ns * matvecs + ns * prods)


def test_pass_bytes_count_each_operand_once():
    f = torch.float32
    n_otu, C, ns, P = 4, 2, 4, 10
    sched = torch.zeros(3, 7, dtype=torch.int32)
    tips = torch.zeros(n_otu, ns, 32, dtype=f)        # padded columns
    pm = torch.zeros(7, C, ns, ns, dtype=f)
    pi = torch.zeros(C, ns, dtype=f)
    logw = torch.zeros(C, dtype=f)
    out = torch.zeros(P, dtype=f)
    flops, nb = work.slot_pass((sched, tips, pm, pi, logw), {}, out)
    assert flops == work.pruning_flops(n_otu, C, ns, P)
    assert nb == 4 * (3 * 7 + n_otu * ns * P + 7 * C * ns * ns + C * ns
                      + C + P)


def fake_trace(path, kernel_name, flops_s=1e-3):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "pb.window",
         "ts": 0, "dur": 1000, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb.unit",
         "ts": 1, "dur": 998, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb.pruning",
         "ts": 10, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 20, "dur": 5, "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": kernel_name, "ts": 30,
         "dur": 400, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 200,
         "dur": 50, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 210, "dur": 5, "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 500,
         "dur": 100, "args": {"correlation": 8}},
    ]
    with open(path, "w") as fh:
        json.dump({"traceEvents": ev}, fh)


@pytest.mark.parametrize("name", ["void phyml::batched_uppass_kernel<4>",
                                  "some_redesigned_kernel"])
def test_roofline_reads_work_not_names(name, tmp_path):
    spans = T.Spans()
    spans.work["pruning"].append((67e12 * 1e-4, 0))   # 100 us of FP32
    p = str(tmp_path / "t.json")
    fake_trace(p, name)
    tr = T.Trace(p, spans, units=1, peak=0)
    assert tr.roofline("pruning") == pytest.approx(25.0)   # 100 / 400 us
    assert tr.device_s("pruning") == pytest.approx(400e-6)
    assert tr.device_s(by_torch=True) == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(500e-6)
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.roofline("edge") is None


def test_idle_gaps_by_the_innermost_span():
    marks = {"unit": [(0, 100)], "frontend": [(5, 40)],
             "blen": [(50, 90)], "pruning": [(60, 70)]}
    idle = [(0, 10), (35, 55), (65, 80), (95, 120)]
    got = T._idle_by_span(idle, marks)
    want = {"harness": 20e-6, "unit": 20e-6, "frontend": 10e-6,
            "blen": 15e-6, "pruning": 5e-6}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k])
