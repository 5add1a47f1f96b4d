"""Loop closures at the gate's 12 inliers or more, per ``planar_slam``
call: the program's counter ``vo.closures_kept`` over the traced window (a
program that keeps no such counter reads None)."""

from benchmark.core import calls


def read(trace, run):
    return calls.per_call(run, calls.counter("vo.closures_kept"))
