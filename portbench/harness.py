"""The benchmark of phyml_tpu_torch on one machine: one cell a run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A cell of BENCHMARK.json names a configuration (`configs/<name>.json`:
the data's sizes, the model, the PhyML options; its model's reference
in `reference/models/<model>.py`) and a traffic mix
(`traffic/<mix>.json`: the kind of unit, `units/<kind>.py`, the
end-to-end metric its time is, the comparison, `checks/<kind>.py`); its
limits are in `limits/<cell>.json` and each per-layer metric's reader
in `metrics/<metric>.py`.  Each is found by its name (`registry.py`):
nothing here names a cell, a configuration, a model, a unit, a
comparison or a metric.

A run: make the inputs from the seed (`gen.py`), set the unit up, run it
once to warm up, then repeat it back to back, a closed loop of one
analysis at a time: the window starts no unit after `--seconds` and
ends when the unit in flight ends.  The unit's metric is the window's
seconds over its units.  With `--trace 1` the window holds one unit,
traced (spans around the program's calls and the profiler), and the
per-layer metrics are reported instead.  Then the program's state is
freed, and the reference judges every distinct output of the window.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "phyml_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def manifest() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_of(bench: dict, name: str):
    """(cell, configuration entry, configuration, traffic, limits)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT, entry["file"])
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    limits = load_json(HERE, "limits", cell["name"] + ".json")
    return cell, entry, config, traffic, limits


def metrics_of(bench: dict, cell: dict, per_layer: bool) -> list:
    """The cell's metric entries: end-to-end ones, or per-layer ones."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not per_layer:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def reader(metric: str):
    from portbench import registry

    return registry.load("metrics", metric).read


def card_check(chips: int):
    """The device kind, or exit: the benchmark runs on CUDA cards only."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), this "
              f"machine has {n}; nothing is measured on the CPU",
              file=sys.stderr)
        raise SystemExit(3)
    return torch.cuda.get_device_name(0)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell, config, traffic, limits, bench, seed: int,
             seconds: float, trace: bool, device: str, t0: float,
             control: bool = False, workdir: str | None = None,
             warm: bool = True, data_seed: int | None = None) -> dict:
    """One run; returns the result (the last line's object), with the
    seconds of its phases and the readings that no limit holds (the
    parts of a compared number).  With `control`, also the control's
    verdict under "control": its outputs judged in the program's place
    through the same limits.  `warm=False` skips the warm-up unit;
    `data_seed` draws another data set than the configuration's."""
    import torch

    from portbench import checks, gen, units
    from portbench.reference import lnl as L

    if data_seed is not None:
        config = dict(config, data=dict(config["data"],
                                        data_seed=int(data_seed)))

    own = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="portbench-")
    try:
        phases = {}
        mark = time.perf_counter()

        def phase(name):
            nonlocal mark
            now = time.perf_counter()
            phases[name] = now - mark
            mark = now

        phase("start")
        aln, tree = gen.write_problem(config, seed, workdir)
        phase("inputs")
        r_seed = int(seed) % (2 ** 31)
        unit = units.unit_of(traffic, config, aln, tree,
                             "gpu" if device == "cuda" else "cpu", r_seed)
        unit.setup()
        phase("unit_setup")
        cuda = device == "cuda"
        if warm:
            unit.run()
            if cuda:
                torch.cuda.synchronize()
            phase("warm_up")
        setup_s = time.perf_counter() - t0
        peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        outputs, spans, prof = [], None, None
        if trace:
            from portbench.trace import Spans

            spans = Spans()
            spans.install()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            window = torch.profiler.record_function("pb.window")
            window.__enter__()
        start = time.perf_counter()
        ends = [start]
        while True:
            if trace:
                with spans.span("unit"):
                    outputs.append(unit.run())
            else:
                outputs.append(unit.run())
            if cuda:
                torch.cuda.synchronize()
            ends.append(time.perf_counter())
            if trace or ends[-1] - start >= seconds:
                break
        wall = time.perf_counter() - start
        phase("window")
        peak_window = torch.cuda.max_memory_allocated() if cuda else 0
        tr = None
        if trace:
            window.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            spans.uninstall()
            path = os.path.join(workdir, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            from portbench.trace import Trace

            tr = Trace(path, spans, len(outputs), peak_window)
            os.remove(path)
        result = {"correct": False, "attempted": len(outputs), "failed": 0}
        if trace:
            result["metrics"] = {}
            for m in metrics_of(bench, cell, per_layer=True):
                v = reader(m["name"])(tr)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": float(v),
                                                    "unit": m["unit"]}
        else:
            values = {"setup_s": setup_s, traffic["time_metric"]:
                      wall / len(outputs)}
            result["metrics"] = {
                m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in metrics_of(bench, cell, per_layer=False)}
        result["device"] = {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(max(peak_setup, peak_window)),
            "power_limit": power_limit() if cuda else "none"}
        if tr is not None:
            result["device"]["busy_s"] = tr.busy_s
            result["device"]["window_s"] = tr.window_s
            result["breakdown"] = tr.breakdown()

        # the program's state goes before the reference runs
        record = unit.record
        unit.free()
        del tr, unit
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        check = checks.check_of(traffic)
        data = L.data_of(aln, config, device=device)
        memo = {}
        judged = checks.verdict(
            *check.judge(config, data, outputs, record, memo), limits)
        if control:
            c_out, c_rec = check.control(config, data, outputs, record,
                                         memo)
            result["control"] = checks.verdict(
                *check.judge(config, data, c_out, c_rec, memo), limits)
        del memo
        phase("reference")
        result["seconds"] = phases
        result["unit_seconds"] = [b - a for a, b in zip(ends, ends[1:])]
        result["readings"] = judged["readings"]
        result["failed"] = judged["failed"]
        result["correct"] = judged["correct"]
        result["compared"] = judged["compared"]
        return result
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest()
    cell, _, config, traffic, limits = cell_of(bench, args.workload)
    card_check(int(cell["chips"]))
    result = run_cell(cell, config, traffic, limits, bench, args.seed,
                      args.seconds, bool(args.trace), "cuda", t0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    for k, v in result["seconds"].items():
        print(f"seconds {k} {v!r}", file=sys.stderr)
    print(f"unit_seconds {result['unit_seconds']!r}", file=sys.stderr)
    for k, v in result["readings"].items():
        print(f"reading {k} {v!r}", file=sys.stderr)
    for k, c in result["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(result)))
    sys.stdout.flush()
    return 0


def finite(x):
    """x with every number a finite float (an infinite or undefined
    reading becomes the largest float), for strict JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, bool) or isinstance(x, (int, str)) or x is None:
        return x
    x = float(x)
    return x if math.isfinite(x) else 1.7976931348623157e308
