"""Share of the program's ``ransac/tail`` spans in which no device operation
ran, in percent: the device-idle ms inside the spans over their host ms (the
spans and the kernels share the trace's clock)."""

from benchmark.core import spans


def read(trace, run):
    tail = spans.span(trace, "ransac/tail")
    if (not tail or tail.host_ms <= 0 or not spans.has_kernels(trace)
            or not spans.fits(trace)):
        return None
    return 100.0 * tail.idle_ms / tail.host_ms
