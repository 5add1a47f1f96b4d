"""Host milliseconds of the program's ``vo/describe`` and ``vo/match``
ranges (detection, description, matching), per pair."""


def read(trace, run):
    ms = trace.span_ms("vo/describe", "vo/match")
    return ms / run["units"] if ms and run["units"] else None
