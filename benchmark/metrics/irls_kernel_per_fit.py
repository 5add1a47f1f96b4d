"""Launches of the IRLS refit's kernel per fit: the program's counter
``ransac.irls_kernel`` over the traced window, over its ``ransac/fit``
spans (one a fit where the refit of the top-K candidates runs in one
launch; a program that refits in eager operations keeps no such counter
and reads None)."""

from benchmark.core import spans


def read(trace, run):
    return spans.per_fit(trace,
                         spans.program_counters().get("ransac.irls_kernel"))
