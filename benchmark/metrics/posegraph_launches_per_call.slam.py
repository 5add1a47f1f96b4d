"""Launches made inside the program's ``vo/posegraph`` range (the host's
``cudaLaunch*``, ``cuLaunch*``, ``cudaMemcpy*``, ``cudaMemset*`` and
``cudaGraphLaunch`` calls), per ``planar_slam`` call."""

from benchmark.core import calls


def read(trace, run):
    return calls.per_call(run, calls.launches(trace, "vo/posegraph"))
