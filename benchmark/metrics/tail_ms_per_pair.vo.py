"""Host milliseconds of the program's ``ransac/tail`` range (the fused
route's per-pair top-K re-score, IRLS refit and LM polish), per pair."""


def read(trace, run):
    ms = trace.span_ms("ransac/tail")
    return ms / run["units"] if ms and run["units"] else None
