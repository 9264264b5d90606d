"""Percent of the H100's roofline that the edge dot products reach
(K2, K5): work.edotp_flops and the bytes over the device time of every
operation launched inside those calls."""


def read(trace):
    return trace.roofline("edge")
