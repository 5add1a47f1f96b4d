"""Share of the traced window in which no device operation ran, over the
``planar_slam`` calls of a SLAM cell, in percent (``torch.profiler``)."""


def read(trace, run):
    if trace.window_s <= 0 or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
