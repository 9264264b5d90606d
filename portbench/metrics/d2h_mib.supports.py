"""MiB the host reads from the card a unit: the program's
`host.d2h_bytes` counter (the bytes of every `to_host`) over the traced
window; none for a program without the counter."""

from portbench import program


def read(trace):
    counts = program.counts()
    if counts is None:
        return None
    return counts.get("host.d2h_bytes", 0) / 2 ** 20 / trace.units
