"""K2's share of its roofline in a VO cell, in percent: its frozen bound at
T-1 pairs of ``num_hypotheses`` hypotheses against ``num_corners`` match
slots, over its device time in the trace."""

from benchmark.core.roofline import k2_roofline_pct


def read(trace, run):
    c = run["config"]
    return k2_roofline_pct(trace, int(c["num_frames"]) - 1,
                           int(c["num_hypotheses"]), int(c["num_corners"]))
