"""Minimal sets the adaptive loop drew over those the confidence bound asked
for at each fit's last read: the program's counters ``ransac.hypotheses``
over ``ransac.bound``, summed over the traced window's fits."""

from benchmark.core import spans


def read(trace, run):
    counts = spans.program_counters()
    drawn, bound = counts.get("ransac.hypotheses"), counts.get("ransac.bound")
    if not spans.fits(trace) or drawn is None or not bound:
        return None
    return drawn / bound
