#!/usr/bin/env python3
"""The port's own spans in one support unit of a benchmark cell, on the
card, and what the spans cost while the profiler records.

    python3 tools/program_spans.py --workload aa120x10240.abayes \
        --seed 2026081901 [--rounds 6] [--out spans.json]

Sets the cell up as portbench/harness.py does (the seed's inputs, the
set-up fit, one warm-up unit), then times `rounds` rounds of three
units: untraced; under torch.profiler (CPU and CUDA) with the
program's spans switched off; under the profiler with them (the last
two in turn, which first alternating from round to round).  The spans
are switched off by giving phyml_tpu_torch/utils/trace.py a stand-in
for the profiler module whose recording flag reads False, so every
span, `traced` call and `to_host` takes its no-op path while the
profiler records the rest as before.  Each time is the unit's own,
from its start to the card's last operation; the profiler's start and
export are outside it.

Then one more traced unit is read (`read_trace`): for each program
span (and "outside", where none is open), the host's self ms (its time
less its child spans'), the ms and count of the device operations
launched while it was the innermost span, and the ms the card was idle
while it was; and over the unit, the host's ms inside `host.sync`
(`sync_wait_ms`), the % of the device time launched inside
`nni.newton` (`newton_share`) and the % of the unit the card was idle
while a program span other than `host.sync` was innermost
(`dispatch_idle`).  The last line of standard output is a JSON object
with both; `--out` also writes it there.  Needs a CUDA card.
"""

import argparse
import bisect
import collections
import json
import os
import statistics
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PREFIX = "phyml."       # the program's spans (phyml_tpu_torch/utils/trace.py)
OUTSIDE = "outside"     # host time in no program span


def _unit(name, seed, workdir):
    from portbench import gen, harness, units

    bench = harness.manifest()
    _, _, config, traffic, _ = harness.cell_of(bench, name)
    aln, tree = gen.write_problem(config, seed, workdir)
    unit = units.unit_of(traffic, config, aln, tree, "gpu",
                         int(seed) % (2 ** 31))
    unit.setup()
    return unit


def _timed(unit, torch, profile, spans_off):
    from phyml_tpu_torch.utils import trace

    real = trace._profiler
    if spans_off:
        trace._profiler = types.SimpleNamespace(_is_profiler_enabled=False)
    try:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=acts) if profile else None
        if prof is not None:
            prof.__enter__()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        unit.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        return dt
    finally:
        trace._profiler = real


def read_trace(path):
    """The program's spans in a Chrome trace of torch.profiler that
    holds a `pb.window` span: ({span: [host self ms, device ms,
    launches, idle ms]} by the innermost program span open on the host,
    OUTSIDE where none is; the window's own numbers).  A device
    operation belongs to the span its launch (the CUDA runtime call of
    its correlation id) lay in."""
    from portbench import trace as T

    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    launched, marks, dev, window = {}, collections.defaultdict(list), [], None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat"), ev.get("name", "")
        if cat in T.DEVICE_CATS:
            dev.append(ev)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launched[corr] = ev["ts"]
        elif cat == "user_annotation" and name == "pb.window":
            window = (ev["ts"], ev["ts"] + ev["dur"])
        elif cat == "user_annotation" and name.startswith(PREFIX):
            marks[name[len(PREFIX):]].append((ev["ts"],
                                              ev["ts"] + ev["dur"]))
    if window is None:
        raise RuntimeError("the trace has no pb.window span")

    def label(k):       # portbench's helpers call "no span" "harness"
        return OUTSIDE if k == "harness" else k

    segs = [(s, e, label(k)) for s, e, k in T._segments(marks)]
    starts = [s for s, _, _ in segs]
    newton = T._Intervals(marks.get("nni.newton", []))
    rows = collections.defaultdict(lambda: [0.0, 0.0, 0, 0.0])
    copies = collections.defaultdict(float)     # "span: copy" -> ms
    for s, e, k in segs:
        rows[k][0] += (e - s) * 1e-3
    busy, device_ms, newton_ms = [], 0.0, 0.0
    for ev in dev:
        s, e = ev["ts"], ev["ts"] + ev["dur"]
        if e < window[0] or s > window[1]:
            continue
        t = launched.get(ev.get("args", {}).get("correlation"))
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        inner = segs[i][2] if i >= 0 and t <= segs[i][1] else OUTSIDE
        ms = ev["dur"] * 1e-3
        rows[inner][1] += ms
        rows[inner][2] += 1
        device_ms += ms
        if t is not None and newton.covers(t):
            newton_ms += ms
        if ev["name"].startswith("Memcpy"):
            copies[f"{inner}: {ev['name']}"] += ms
        busy.append((max(s, window[0]), min(e, window[1])))
    merged = T._Intervals(busy)
    edges = [window[0]] + [x for pair in zip(merged.starts, merged.ends)
                           for x in pair] + [window[1]]
    idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    for k, sec in T._idle_by_span(idle, marks).items():
        rows[label(k)][3] += sec * 1e3
    window_ms = (window[1] - window[0]) * 1e-3
    sync = T._Intervals(marks.get("host.sync", []))
    whole = dict(
        busy_s=sum(e - s for s, e in zip(merged.starts, merged.ends)) * 1e-6,
        window_s=window_ms * 1e-3,
        program_s=(segs[-1][1] - segs[0][0]) * 1e-6 if segs else 0.0,
        launches=sum(r[2] for r in rows.values()),
        copies_ms=dict(copies),
        # host ms waiting in `to_host`, the queued work included
        sync_wait_ms=sum(e - s for s, e in zip(sync.starts,
                                               sync.ends)) * 1e-3,
        # % of the device time launched inside the Newton solves
        newton_share=100.0 * newton_ms / device_ms if device_ms else None,
        # % of the window idle while the program dispatches, not while
        # it waits in `to_host` and not outside its spans
        dispatch_idle=100.0 * sum(r[3] for k, r in rows.items()
                                  if k not in ("host.sync", OUTSIDE))
        / window_ms)
    return dict(rows), whole


def _table(unit, torch, workdir):
    """read_trace of one traced unit."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("pb.window"):
            unit.run()
            torch.cuda.synchronize()
    path = os.path.join(workdir, "unit.json")
    prof.export_chrome_trace(path)
    return read_trace(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/program_spans.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("program_spans: needs a CUDA card", file=sys.stderr)
        return 3
    with tempfile.TemporaryDirectory(prefix="spans-") as workdir:
        unit = _unit(args.workload, args.seed, workdir)
        unit.run()
        for mode in ((True, True), (True, False)):   # warm the profiler
            _timed(unit, torch, *mode)
        times = {"untraced": [], "profiler": [], "profiler_spans": []}
        kinds = [("untraced", False, False), ("profiler", True, True),
                 ("profiler_spans", True, False)]
        for r in range(args.rounds):
            # the two traced kinds in turn, first one then the other
            for kind, profile, off in kinds[:1] + kinds[1:][::(-1) ** r]:
                times[kind].append(_timed(unit, torch, profile, off))
        rows, whole = _table(unit, torch, workdir)
        unit.free()
    med = {k: statistics.median(v) for k, v in times.items()}
    out = dict(workload=args.workload, seed=args.seed,
               device=torch.cuda.get_device_name(0), unit_s=times,
               median_s=med,
               profiler_cost=med["profiler"] / med["untraced"] - 1,
               spans_cost=med["profiler_spans"] / med["profiler"] - 1,
               spans=rows, traced_unit=whole)
    for label, (host, dev, n, idle) in sorted(rows.items(),
                                              key=lambda kv: -kv[1][0]):
        print(f"{label:18s} host self {host:9.3f} ms  device {dev:9.3f} "
              f"ms  launches {n:6d}  idle {idle:8.3f} ms", file=sys.stderr)
    print(f"copies {whole['copies_ms']}", file=sys.stderr)
    print(f"sync_wait_ms {whole['sync_wait_ms']!r} newton_share "
          f"{whole['newton_share']!r} dispatch_idle "
          f"{whole['dispatch_idle']!r}", file=sys.stderr)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
