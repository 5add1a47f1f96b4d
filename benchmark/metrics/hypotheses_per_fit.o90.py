"""Minimal sets the adaptive loop drew, per fit: the program's counter
``ransac.hypotheses`` over the traced window, over its ``ransac/fit``
spans."""

from benchmark.core import spans


def read(trace, run):
    return spans.per_fit(trace,
                         spans.program_counters().get("ransac.hypotheses"))
