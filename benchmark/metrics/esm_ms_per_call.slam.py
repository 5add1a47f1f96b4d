"""Host milliseconds of the program's ``vo/esm`` ranges (the guarded dense
polish of every model, both batches: the consecutive pairs' and the
closures'), per ``planar_slam`` call."""

from benchmark.core import calls


def read(trace, run):
    return calls.span_ms_per_call(trace, run, "vo/esm")
