"""The manifest against the benchmark's contract, the files each cell
and metric is found by, and the runs that must not measure: no card,
and a directory without the program."""

import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import checks, harness, registry, units
from portbench.reference import models

ROOT = harness.ROOT
HERE = harness.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return harness.manifest()


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\t" not in s \
        and "\n" not in s


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(map(line, bench["command"]))
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_run_seconds_fit_the_check(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_and_metric_found_by_name(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        cell, entry, config, traffic, limits = harness.cell_of(bench,
                                                               w["name"])
        assert entry["file"].startswith("portbench/")
        assert config["name"] == entry["name"]
        assert traffic["time_metric"] in e2e
        mine = {m["name"] for m in harness.metrics_of(bench, cell, False)}
        assert {"setup_s", traffic["time_metric"]} <= mine
        layer = harness.metrics_of(bench, cell, True)
        assert layer
        assert all(m["moves"] in mine for m in layer)
        assert limits and all(v > 0 for v in limits.values())
        assert hasattr(units.unit_of(traffic, config, "a", "t", "cpu", 1),
                       "run")
        check = checks.check_of(traffic)
        assert callable(check.judge) and callable(check.control)
        model = models.of(config)
        assert model.ALPHABET and callable(model.mixture)
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"]))
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in bench["workloads"]}


def test_kinds_and_models_are_files_found_by_name():
    """A unit kind, a comparison, a model or a metric is its own file:
    nothing of the harness lists them, so a later one adds a file."""
    for folder in ("units", "checks", "reference/models", "metrics"):
        names = [f[:-3] for f in os.listdir(os.path.join(HERE, folder))
                 if f.endswith(".py") and f != "__init__.py"]
        assert names
        for name in names:
            assert registry.load(folder, name) is registry.load(folder,
                                                                name)
            for src in ("harness.py", "registry.py", "units/__init__.py",
                        "checks/__init__.py", "reference/lnl.py",
                        "reference/nni.py", "gen.py"):
                with open(os.path.join(HERE, src)) as fh:
                    text = fh.read()
                assert not re.search(rf"[\"']{re.escape(name)}[\"']",
                                     text), (src, name)
    with pytest.raises(LookupError):
        registry.load("units", "no_such_kind")
    with pytest.raises(ValueError):
        registry.load("units", "../harness")


def test_no_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "nt120x10240.abayes", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA device" in p.stderr


def test_without_the_program_exits_nonzero(tmp_path):
    """A checkout holding only BENCHMARK.json and portbench/ fails, even
    past the look for a card."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); "
            "from portbench import harness; "
            "harness.card_check = lambda n: 'none'; "
            "sys.exit(harness.main(['--workload', 'nt120x10240.abayes', "
            "'--seed', '1', '--seconds', '1'], 0.0))")
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "phyml_tpu_torch" in p.stderr
    assert "{" not in p.stdout
