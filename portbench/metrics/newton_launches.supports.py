"""Launches of the edge-length Newton kernel (K6) a unit: the program's
`launch.K6` counter over the traced window, one a solve; none for a
program without the counters or without the kernel."""

from portbench import program


def read(trace):
    counts = program.counts()
    if counts is None or "launch.K6" not in counts:
        return None
    return counts["launch.K6"] / trace.units
