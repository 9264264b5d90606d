"""Host reads of the card a unit: the program's `host.syncs` counter
(every `to_host` of phyml_tpu_torch/utils/trace.py) over the traced
window; none for a program without the counter."""

from portbench import program


def read(trace):
    counts = program.counts()
    if counts is None:
        return None
    return counts.get("host.syncs", 0) / trace.units
