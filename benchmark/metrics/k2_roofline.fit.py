"""K2's share of its roofline in a fit cell, in percent: its frozen bound at
one pair of ``max_iters`` (rounded up to 128) hypotheses against the
configuration's N points, over its device time in the trace."""

from benchmark.core.roofline import k2_roofline_pct


def read(trace, run):
    b = -(-int(run["config"]["max_iters"]) // 128) * 128
    return k2_roofline_pct(trace, 1, b, int(run["config"]["n_points"]))
