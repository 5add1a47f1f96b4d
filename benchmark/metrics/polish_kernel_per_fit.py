"""Launches of the annealed LM polish's kernel per fit: the program's
counter ``ransac.polish_kernel`` over the traced window, over its
``ransac/fit`` spans (one a fit where the polish of the selected model runs
in one launch; a program that polishes in eager operations keeps no such
counter and reads None)."""

from benchmark.core import spans


def read(trace, run):
    return spans.per_fit(trace,
                         spans.program_counters().get("ransac.polish_kernel"))
