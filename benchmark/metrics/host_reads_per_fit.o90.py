"""Blocking host reads of the card the adaptive loop made, per fit: the
program's counter ``ransac.host_reads`` over the traced window, over its
``ransac/fit`` spans (one before each chunk, and one more where the bound
stops the loop)."""

from benchmark.core import spans


def read(trace, run):
    return spans.per_fit(trace,
                         spans.program_counters().get("ransac.host_reads"))
