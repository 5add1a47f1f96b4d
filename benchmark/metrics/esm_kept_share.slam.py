"""Share of the polished models whose polish the guard kept, in percent:
the program's counters ``esm.kept`` over ``esm.models`` in the traced
window (a program that keeps no such counters reads None)."""

from benchmark.core import calls


def read(trace, run):
    kept, models = calls.counter("esm.kept"), calls.counter("esm.models")
    if kept is None or not models:
        return None
    return 100.0 * kept / models
