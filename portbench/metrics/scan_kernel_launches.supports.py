"""Launches of the scan passes' kernel (K7) a unit: the program's
`launch.K7` counter over the traced window, one a pass; none for a
program without the counters or without the kernel."""

from portbench import program


def read(trace):
    counts = program.counts()
    if counts is None or "launch.K7" not in counts:
        return None
    return counts["launch.K7"] / trace.units
