"""Device operations (kernels, copies, sets) a unit launches, from
the profiler's trace."""


def read(trace):
    return trace.launches() / trace.units
