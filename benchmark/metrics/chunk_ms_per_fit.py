"""Host milliseconds of the program's ``ransac/chunk`` spans (one chunk of
hypotheses: draw, solve, score and top-K, with the fused route's re-score of
the K winners), per fit."""

from benchmark.core import spans


def read(trace, run):
    chunk = spans.span(trace, "ransac/chunk")
    return spans.per_fit(trace, chunk and chunk.host_ms)
