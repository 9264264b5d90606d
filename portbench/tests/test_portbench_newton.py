"""The reader of the Newton kernel's launches (`newton_launches.supports`):
the program's `launch.K6` over the units of the traced window, and no
reading from a program whose counters lack it (the parent of the
kernel) or that has no counters."""

import collections

import pytest

from portbench import program, registry

NAME = "newton_launches.supports"


class _Trace:
    units = 2


@pytest.fixture
def window_counts(monkeypatch):
    from phyml_tpu_torch.utils import trace as counters

    fresh = collections.Counter()
    monkeypatch.setattr(counters, "_profiled", fresh)
    return fresh


def test_reads_the_launches_a_unit(window_counts):
    window_counts.update({"launch.K6": 16, "host.syncs": 14})
    assert registry.load("metrics", NAME).read(_Trace()) == 8


def test_no_kernel_no_reading(window_counts):
    window_counts.update({"host.syncs": 14})
    assert registry.load("metrics", NAME).read(_Trace()) is None


def test_no_counters_no_reading(monkeypatch):
    monkeypatch.setattr(program, "counts", lambda: None)
    assert registry.load("metrics", NAME).read(_Trace()) is None


def test_listed_for_both_support_cells():
    from portbench import harness

    bench = harness.manifest()
    entry = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert len(entry) == 1
    assert entry[0]["moves"] == "supports_s"
    assert entry[0]["workloads"] == ["aa120x10240.abayes",
                                     "nt120x10240.abayes"]
