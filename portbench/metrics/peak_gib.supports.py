"""Device memory allocated at the peak of the window (GiB), the peak
reset at the window's start."""


def read(trace):
    return trace.peak_bytes / 2 ** 30
