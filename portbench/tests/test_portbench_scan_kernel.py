"""The reader of the scan kernel's launches
(`scan_kernel_launches.supports`): the program's `launch.K7` over the
units of the traced window, and no reading from a program whose counters
lack it (the parent of the kernel) or that has no counters."""

import collections

import pytest

from portbench import program, registry

NAME = "scan_kernel_launches.supports"


class _Trace:
    units = 3


@pytest.fixture
def window_counts(monkeypatch):
    from phyml_tpu_torch.utils import trace as counters

    fresh = collections.Counter()
    monkeypatch.setattr(counters, "_profiled", fresh)
    return fresh


def test_reads_the_launches_a_unit(window_counts):
    window_counts.update({"launch.K7": 6, "launch.K6": 24})
    assert registry.load("metrics", NAME).read(_Trace()) == 2


def test_no_kernel_no_reading(window_counts):
    window_counts.update({"launch.K6": 24})
    assert registry.load("metrics", NAME).read(_Trace()) is None


def test_no_counters_no_reading(monkeypatch):
    monkeypatch.setattr(program, "counts", lambda: None)
    assert registry.load("metrics", NAME).read(_Trace()) is None


def test_listed_for_the_support_cells():
    from portbench import harness

    bench = harness.manifest()
    entry = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert len(entry) == 1
    assert entry[0]["moves"] == "supports_s"
    assert entry[0]["layer"] == "engine"
    assert set(entry[0]["workloads"]) == {
        c["name"] for c in bench["workloads"] if c["traffic"] == "abayes"}
