"""Host milliseconds of the program's ``ransac/sync`` span (the adaptive
loop's host blocked on its one read of the card a chunk), per fit."""

from benchmark.core import spans


def read(trace, run):
    sync = spans.span(trace, "ransac/sync")
    return spans.per_fit(trace, sync and sync.host_ms)
