"""Host milliseconds of the program's ``ransac/polish`` span (the annealed
Levenberg-Marquardt polish of the selected model and its score), per fit."""

from benchmark.core import spans


def read(trace, run):
    polish = spans.span(trace, "ransac/polish")
    return spans.per_fit(trace, polish and polish.host_ms)
