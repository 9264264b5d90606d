"""The port's spans, counters and host reads of the card.

Spans mark phases of the program for `torch.profiler`: `span(name)` is
a context manager and `traced(name)` its decorator.  While a profiler
records, each opens `torch.profiler.record_function("phyml." + name)`,
so the span lands in the profiler's own trace on the clock of the
device's operations; each operation's launch lies inside the spans open
on its thread, and their nesting gives each span's parent.  While none
records, a span costs one attribute read and builds nothing.  This
module keeps no clock and no list of spans: the profiler holds them and
writes them with its trace (`cli.py --profile_out PATH`).

Counters are one always-on registry: `count(name, n)` adds, and
`snapshot()` copies it; readers take differences (`since`), nothing
resets it.  What is counted while a profiler records is also kept
apart (`profiled()`), so that whoever ran the profiler reads the
counts of its window after it ends.  Names:

  launch.K1 .. launch.K5        hand-written kernel launches (ops/)
  launch.K6                     the Newton solve (ops/newton.py): one a
                                solve, or one an iteration when sharded
  launch.K7                     the scan passes (ops/scan.py): one a pass
                                (LikelihoodEngine._up_pass, _down_pass)
  nni.state_flops               FLOPs of the NNI scorer's dense state
                                products (search/nni.py: G, push, pushT
                                and both einsums of dots), 2 x rows x C
                                x ns^2 x P each, counted from shapes as
                                each is issued
  (span) model.system           not a counter: the class system's
                                construction (the eigensystem) in
                                LikelihoodEngine.system_of, on a miss
                                of its cache
  launch.K3.batch.<B>           K3 by batch size of one schedule
  launch.K3.trees.<R>           K3, K2, K5, K7 on a stack of R trees
  launch.K2.trees.<R>, launch.K5.trees.<R>, launch.K7.trees.<R>
  round.rounds, round.zooms     outer rounds, line-search zoom levels
  round.probe_rows              parameter sets the line search scored
  blen.rounds, blen.newton_iters, blen.backtracks
  host.syncs, host.syncs.<site> reads of a tensor that may live on the
  host.d2h_bytes                card (`to_host`), and their bytes
"""

from __future__ import annotations

import collections
import functools

import torch
from torch.autograd import profiler as _profiler

PREFIX = "phyml."

_counts: collections.Counter = collections.Counter()
# the part of _counts counted while a profiler recorded
_profiled: collections.Counter = collections.Counter()


class _NoSpan:
    """The span while no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context manager: the span `phyml.<name>` while a profiler
    records, else a shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(PREFIX + name)


def traced(name: str):
    """Decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(PREFIX + name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    _counts[name] += n
    if _profiler._is_profiler_enabled:
        _profiled[name] += n


def snapshot() -> dict:
    """A copy of every counter."""
    return dict(_counts)


def profiled() -> dict:
    """A copy of what was counted while a profiler recorded, over the
    life of the process; readers of several profiled windows take
    differences."""
    return dict(_profiled)


def since(before: dict) -> dict:
    """The counters that moved since the snapshot `before`, by how
    much."""
    return {k: v - before.get(k, 0) for k, v in _counts.items()
            if v != before.get(k, 0)}


def to_host(x: torch.Tensor, site: str) -> torch.Tensor:
    """x on the host (itself when it is there): the one way the
    optimiser, the NNI scorer and the engine read a tensor that may
    live on the card.  Counts host.syncs, host.syncs.<site> and
    host.d2h_bytes on any device; the span host.sync while a profiler
    records covers the host's wait for the card."""
    nbytes = x.numel() * x.element_size()
    _counts["host.syncs"] += 1
    _counts["host.syncs." + site] += 1
    _counts["host.d2h_bytes"] += nbytes
    if not _profiler._is_profiler_enabled:
        return x.cpu()
    _profiled["host.syncs"] += 1
    _profiled["host.syncs." + site] += 1
    _profiled["host.d2h_bytes"] += nbytes
    with torch.profiler.record_function(PREFIX + "host.sync"):
        return x.cpu()
