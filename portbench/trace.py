"""Spans, counters and the profiler's trace of the traced run, reduced
to what the per-layer metrics read.

`Spans` wraps functions of the program for the traced window only: each
call is timed by the host's clock, counted, and marked for the profiler
with `torch.profiler.record_function("pb.<label>")`; the kernel
wrappers' calls also record the work their shapes ask for
(`portbench/work.py`).  `Trace` reads the profiler's Chrome trace: the
device's operations (kernels, copies, sets), which host call launched
each (the CUDA runtime call with the same correlation id), whether that
call ran inside one of PyTorch's own operators, and inside which marked
spans.
"""

from __future__ import annotations

import bisect
import collections
import importlib
import json
import time

from portbench import work

# (module, attribute, label, work counter): the spans of the traced run
TARGETS = (
    ("phyml_tpu_torch.io.alignment", "read_alignment", "frontend", None),
    ("phyml_tpu_torch.ops.likelihood", "LikelihoodEngine.__init__",
     "frontend", None),
    ("phyml_tpu_torch.optim.round", "optimize_branch_lengths", "blen",
     None),
    ("phyml_tpu_torch.ops.likelihood", "LikelihoodEngine._up_pass", "scan",
     None),
    ("phyml_tpu_torch.ops.likelihood", "LikelihoodEngine._down_pass",
     "scan", None),
    ("phyml_tpu_torch.ops.likelihood", "uppass_site_lse_slots", "pruning",
     work.slot_pass),
    ("phyml_tpu_torch.ops.likelihood", "uppass_site_lse_slots_stream",
     "pruning", work.slot_pass),
    ("phyml_tpu_torch.ops.likelihood", "uppass_site_lse", "pruning",
     work.batched_pass),
    ("phyml_tpu_torch.ops.likelihood", "edge_dotprods", "edge",
     work.edge_pass),
    ("phyml_tpu_torch.ops.likelihood", "edge_dotprods_stream", "edge",
     work.edge_pass),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host spans, call counts and work records by label."""

    def __init__(self):
        self.host_s = collections.defaultdict(float)
        self.calls = collections.Counter()
        self.work = collections.defaultdict(list)   # label -> [(F, B)]
        self._saved = []
        self._depth = collections.Counter()

    def span(self, label):
        """A context manager: a marked, timed span of the harness."""
        return _Span(self, label)

    def install(self):
        import torch

        for mod_name, attr, label, counter in TARGETS:
            owner = importlib.import_module(mod_name)
            parts = attr.split(".")
            for p in parts[:-1]:
                owner = getattr(owner, p)
            orig = getattr(owner, parts[-1])
            self._saved.append((owner, parts[-1], orig))
            setattr(owner, parts[-1],
                    self._wrap(orig, label, counter, torch))

    def uninstall(self):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved = []

    def _wrap(self, fn, label, counter, torch):
        def wrapped(*args, **kwargs):
            # a span counts once when the program nests calls of a label
            outer = self._depth[label] == 0
            self._depth[label] += 1
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(f"pb.{label}"):
                    out = fn(*args, **kwargs)
            finally:
                self._depth[label] -= 1
            if outer:
                self.host_s[label] += time.perf_counter() - t0
                self.calls[label] += 1
            if counter is not None:
                self.work[label].append(counter(args, kwargs, out))
            return out
        wrapped.__wrapped__ = fn
        return wrapped


class _Span:
    def __init__(self, spans, label):
        self.spans, self.label = spans, label

    def __enter__(self):
        import torch

        self.rf = torch.profiler.record_function(f"pb.{self.label}")
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.host_s[self.label] += time.perf_counter() - self.t0
        self.spans.calls[self.label] += 1
        self.rf.__exit__(*exc)
        return False


class _Intervals:
    """Sorted, merged intervals; `covers(t)`."""

    def __init__(self, pairs):
        merged = []
        for s, e in sorted(pairs):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]

    def covers(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def _segments(marks):
    """[(start, end, label)]: the host's time cut at every boundary of
    the marked spans, each piece labelled by the innermost span open
    over it ("harness" where none is).  Spans of one thread nest."""
    events = sorted([(s, 1, -e, k) for k, iv in marks.items()
                     for s, e in iv] + [(e, 0, 0, k) for k, iv in
                                        marks.items() for _, e in iv])
    out, stack, last = [], [], None
    for t, kind, _, label in events:
        if last is not None and t > last:
            out.append((last, t, stack[-1] if stack else "harness"))
        if kind == 1:
            stack.append(label)
        elif label in stack:
            del stack[len(stack) - 1 - stack[::-1].index(label)]
        last = t
    return out


def _idle_by_span(idle, marks) -> dict:
    """Idle seconds by the innermost marked span on the host over them."""
    segs = _segments(marks)
    out = collections.defaultdict(float)
    j = 0
    for s, e in idle:
        while j < len(segs) and segs[j][1] <= s:
            j += 1
        k, t = j, s
        while t < e:
            if k < len(segs) and segs[k][0] <= t < segs[k][1]:
                end, label = min(e, segs[k][1]), segs[k][2]
                k += 1
            elif k < len(segs) and segs[k][0] > t:
                end, label = min(e, segs[k][0]), "harness"
            elif k < len(segs):
                k += 1
                continue
            else:
                end, label = e, "harness"
            out[label] += (end - t) * 1e-6
            t = end
    return dict(out)


class Trace:
    """The traced window's device operations, each with its duration,
    name, whether PyTorch's operators launched it and the marked spans
    its launch lay in; the device's busy time and the window's length;
    the idle gaps by the innermost marked span on the host."""

    def __init__(self, path: str, spans: Spans, units: int, peak: int):
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        self.spans, self.units, self.peak_bytes = spans, units, peak
        runtime, aten, marks, dev = {}, [], collections.defaultdict(list), []
        window = None
        for ev in events:
            cat = ev.get("cat")
            if ev.get("ph") != "X":
                continue
            if cat in DEVICE_CATS:
                dev.append(ev)
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = ev.get("args", {}).get("correlation")
                if corr is not None:
                    runtime[corr] = ev
            elif cat == "cpu_op":
                aten.append((ev["ts"], ev["ts"] + ev["dur"]))
            elif cat == "user_annotation" and ev["name"].startswith("pb."):
                if ev["name"] == "pb.window":
                    window = (ev["ts"], ev["ts"] + ev["dur"])
                else:
                    marks[ev["name"][3:]].append((ev["ts"],
                                                  ev["ts"] + ev["dur"]))
        if window is None:
            raise RuntimeError("the trace has no pb.window span")
        self.window_s = (window[1] - window[0]) * 1e-6
        torch_ops = _Intervals(aten)
        self.mark_iv = {k: _Intervals(v) for k, v in marks.items()}
        self.ops = []           # (seconds, name, by_torch, labels)
        busy = []
        for ev in dev:
            s, e = ev["ts"], ev["ts"] + ev["dur"]
            if e < window[0] or s > window[1]:
                continue
            rt = runtime.get(ev.get("args", {}).get("correlation"))
            t_host = rt["ts"] if rt is not None else None
            labels = frozenset(k for k, iv in self.mark_iv.items()
                               if t_host is not None and iv.covers(t_host))
            self.ops.append((ev["dur"] * 1e-6, ev["name"],
                             t_host is not None and torch_ops.covers(t_host),
                             labels))
            busy.append((max(s, window[0]), min(e, window[1])))
        merged = _Intervals(busy)
        self.busy_s = sum(e - s for s, e in zip(merged.starts,
                                                merged.ends)) * 1e-6
        edges = [window[0]] + [x for pair in zip(merged.starts, merged.ends)
                               for x in pair] + [window[1]]
        idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
        self.idle_by_span = _idle_by_span(idle, marks)

    # -- what the metrics read ------------------------------------------
    def device_s(self, label=None, by_torch=None) -> float:
        return sum(d for d, _, tor, lab in self.ops
                   if (label is None or label in lab)
                   and (by_torch is None or tor == by_torch))

    def launches(self) -> int:
        return len(self.ops)

    def least_s(self, label) -> float:
        return sum(work.least_seconds(f, b)
                   for f, b in self.spans.work.get(label, []))

    def roofline(self, label):
        """Percent of the least time over the device time of the
        kernels launched inside the label's calls; None without any."""
        if not self.spans.work.get(label):
            return None
        t = self.device_s(label)
        return 100.0 * self.least_s(label) / t if t > 0 else None

    def breakdown(self) -> dict:
        by_name = collections.defaultdict(float)
        for d, name, _, _ in self.ops:
            by_name[name[:160]] += d
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}
