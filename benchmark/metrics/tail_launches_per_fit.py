"""Launches made inside the program's ``ransac/tail`` span (the host's
``cudaLaunch*``, ``cuLaunch*``, ``cudaMemcpy*`` and ``cudaMemset*`` calls),
per fit."""

from benchmark.core import spans


def read(trace, run):
    tail = spans.span(trace, "ransac/tail")
    return spans.per_fit(trace, tail and tail.launches)
