"""Outer rounds of optim/round.py a fit makes: its calls of
optimize_branch_lengths, one a round."""


def read(trace):
    n = trace.spans.calls["blen"]
    return n / trace.units if n else None
