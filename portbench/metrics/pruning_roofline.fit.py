"""Percent of the H100's roofline that the pruning passes reach:
the least time of the work asked for through the slot and batched
pruning kernels (K1, K3, K4), counted from their shapes
(work.pruning_flops and the bytes), over the device time of every
operation launched inside those calls."""


def read(trace):
    return trace.roofline("pruning")
