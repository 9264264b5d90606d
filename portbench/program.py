"""The program's own counters over the traced window: what
phyml_tpu_torch/utils/trace.py counted while a profiler recorded
(`profiled()`).  A run profiles its one traced window and nothing
else, so those are the window's counts.  None for a program without
them."""


def counts():
    try:
        from phyml_tpu_torch.utils import trace
    except ImportError:             # a program without counters
        return None
    profiled = getattr(trace, "profiled", None)
    return None if profiled is None else profiled()
