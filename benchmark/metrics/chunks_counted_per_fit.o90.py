"""Chunks the adaptive loop evaluated, per fit, as the program counts them:
the counter ``ransac.chunks`` over the traced window, over its
``ransac/fit`` spans."""

from benchmark.core import spans


def read(trace, run):
    return spans.per_fit(trace,
                         spans.program_counters().get("ransac.chunks"))
