"""Host milliseconds of the program's ``ransac/tail`` span (the refit of the
top-K candidates, the selection and the polish), per fit (``ransac/fit``)."""

from benchmark.core import spans


def read(trace, run):
    tail = spans.span(trace, "ransac/tail")
    return spans.per_fit(trace, tail and tail.host_ms)
