"""Percent of the card's FP32 peak (`work.PEAK_FLOPS`) that the NNI
scorer's dense state products reach: the program's `nni.state_flops`
over the peak times the device seconds of the traced units outside the
engine's scan passes.  Those seconds also hold K6's Newton solves and
the scorer's elementwise products, so the reading is a lower bound on
the products' own share of the peak.  None for a program without the
counter."""

from portbench import program, work


def read(trace):
    counts = program.counts()
    if counts is None or "nni.state_flops" not in counts:
        return None
    seconds = trace.device_s("unit") - trace.device_s("scan")
    if seconds <= 0:
        return None
    return 100.0 * counts["nni.state_flops"] / (work.PEAK_FLOPS * seconds)
