"""Host milliseconds of the program's ``vo/pose`` and ``vo/chain`` ranges
(pose recovery and the metric chain), per pair."""


def read(trace, run):
    ms = trace.span_ms("vo/pose", "vo/chain")
    return ms / run["units"] if ms and run["units"] else None
