"""GFLOP a unit of the NNI scorer's dense state products: the program's
`nni.state_flops` counter (2 x rows x C x ns^2 x P for each product,
counted from shapes as it is issued) over the traced window, over 1e9;
none for a program without the counter."""

from portbench import program


def read(trace):
    counts = program.counts()
    if counts is None or "nni.state_flops" not in counts:
        return None
    return counts["nni.state_flops"] / 1e9 / trace.units
