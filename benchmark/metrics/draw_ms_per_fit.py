"""Host milliseconds of the program's ``ransac/draw`` span on the single
fused fit (the minimal sets drawn and laid out for K2), per fit."""

from benchmark.core import spans


def read(trace, run):
    draw = spans.span(trace, "ransac/draw")
    return spans.per_fit(trace, draw and draw.host_ms)
