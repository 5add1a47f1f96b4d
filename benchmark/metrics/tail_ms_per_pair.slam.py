"""Host milliseconds of the program's ``ransac/tail`` ranges (each pair's
top-K re-score, IRLS refit and LM polish, consecutive pairs and closures),
per pair fitted."""


def read(trace, run):
    ms = trace.span_ms("ransac/tail")
    return ms / run["units"] if ms and run["units"] else None
