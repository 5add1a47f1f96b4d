"""Host milliseconds of the program's ``vo/posegraph`` range (the pose
graph's Gauss-Newton steps, each of conjugate-gradient steps built from
``torch.func.jvp`` and ``vjp``), per ``planar_slam`` call."""

from benchmark.core import calls


def read(trace, run):
    return calls.span_ms_per_call(trace, run, "vo/posegraph")
