"""Host milliseconds of the program's ``ransac/rescore`` span (the eager
re-solve and re-score of the fused kernel's K winners), per fit."""

from benchmark.core import spans


def read(trace, run):
    rescore = spans.span(trace, "ransac/rescore")
    return spans.per_fit(trace, rescore and rescore.host_ms)
