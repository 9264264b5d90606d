"""Percent of the traced window in which no operation ran on the
device, from the profiler's trace."""


def read(trace):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
