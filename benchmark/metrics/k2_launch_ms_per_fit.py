"""Host milliseconds of the program's ``ransac/k2`` span on the single fused
fit (K2's arguments and its launch, not its device time), per fit."""

from benchmark.core import spans


def read(trace, run):
    k2 = spans.span(trace, "ransac/k2")
    return spans.per_fit(trace, k2 and k2.host_ms)
