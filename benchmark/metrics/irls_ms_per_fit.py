"""Host milliseconds of the program's ``ransac/irls`` span (the IRLS refit
of the top-K candidates: weighted NDLT by Jacobi sweeps), per fit."""

from benchmark.core import spans


def read(trace, run):
    irls = spans.span(trace, "ransac/irls")
    return spans.per_fit(trace, irls and irls.host_ms)
