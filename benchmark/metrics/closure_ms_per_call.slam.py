"""Host milliseconds of the program's ``vo/closure`` range (the loop
closures' fits: their K2 batch, tails, dense polish and pose recovery), per
``planar_slam`` call; a program that opens no such range reads None."""

from benchmark.core import calls


def read(trace, run):
    return calls.span_ms_per_call(trace, run, "vo/closure")
