"""Host milliseconds a fit spends in read_alignment and in building
the likelihood engine (the front end: cli.py, io/alignment.py)."""


def read(trace):
    return 1e3 * trace.spans.host_s["frontend"] / trace.units
