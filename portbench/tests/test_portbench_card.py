"""On the card: every cell's comparison at its own size on one seed,
the program inside its limits and the control outside them.

    python -m pytest portbench/tests/test_portbench_card.py -m gpu

Skips where there is no CUDA device."""

import time

import pytest

from portbench import harness


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.manifest()["workloads"]]
                         + ["nt120x10240.fit", "aa120x10240.fit"])
def test_cell_and_control_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the card only")
    bench = harness.manifest()
    # the fit cells, held out of BENCHMARK.json (PERF.md, Open questions)
    bench = dict(bench, workloads=bench["workloads"] + [
        {"name": n, "config": cfg, "traffic": "fit", "chips": 1}
        for n, cfg in (("nt120x10240.fit", "nt120x10240-gtr-g4"),
                       ("aa120x10240.fit", "aa120x10240-lg-g4"))])
    c, _, config, traffic, limits = harness.cell_of(bench, cell)
    r = harness.run_cell(c, config, traffic, limits, bench, 2 ** 33 + 1,
                         0.0, False, "cuda", time.perf_counter(),
                         control=True, warm=False)
    assert r["correct"], r["compared"]
    assert not r["control"]["correct"], r["control"]["compared"]
