"""Device milliseconds a unit spends in operations that PyTorch's
own operators launched (not the port's hand-written kernels)."""


def read(trace):
    return 1e3 * trace.device_s(by_torch=True) / trace.units
