"""Percent of a fit's wall-clock inside optimize_branch_lengths
(optim/blen.py), by the host's clock: the call returns a host float,
so the device work it starts ends inside it."""


def read(trace):
    if not trace.spans.calls["blen"]:
        return None
    return 100.0 * trace.spans.host_s["blen"] / trace.spans.host_s["unit"]
