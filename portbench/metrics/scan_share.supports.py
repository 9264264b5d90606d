"""Percent of a support computation's device time in operations
launched inside the engine's scan passes (_up_pass, _down_pass), the
rest being the NNI scorer's Newton terms and products."""


def read(trace):
    total = trace.device_s("unit")
    if not trace.spans.calls["scan"] or total <= 0:
        return None
    return 100.0 * trace.device_s("scan") / total
