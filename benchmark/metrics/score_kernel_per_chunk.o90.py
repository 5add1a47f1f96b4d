"""Launches of the eager chunk's scoring kernel per chunk: the program's
counter ``ransac.score_kernel`` over its counter ``ransac.chunks``, both
over the traced window (1.0 where every eager chunk is scored in one
launch; a program that scores its chunks in eager operations keeps no such
counter and reads None)."""

from benchmark.core import spans


def read(trace, run):
    counted = spans.program_counters()
    kernel, chunks = (counted.get(name) for name in ("ransac.score_kernel",
                                                     "ransac.chunks"))
    if kernel is None or not chunks:
        return None
    return kernel / chunks
