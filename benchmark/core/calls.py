"""The program's VO spans in a traced run, per call of the entry point.

The VO entry points open named ranges of their own (``vo/esm``,
``vo/closure``, ``vo/posegraph``, ...) beside the RANSAC ranges that
``spans.py`` indexes.  Here the launches made inside a span name (the host
runtime calls of ``LAUNCHES``) are read from a
:class:`~benchmark.core.trace.TraceView`'s host events, and a span's host
ms (``TraceView.span_ms``) or a counter is divided by the requests of the
traced window.  A replay of a captured CUDA graph (``cudaGraphLaunch``) is
one launch.  A span that never opened, or a counter the program does not
keep, reads None.
"""

from __future__ import annotations

import bisect

from benchmark.core import spans

#: The host runtime calls counted as launches.
LAUNCHES = spans.LAUNCHES + ("cudaGraphLaunch",)


def per_call(run, value):
    """``value`` over the traced requests; None without either (a span's
    host ms of 0: it never opened)."""
    n = run["requests"]
    return None if value is None or not n else value / n


def span_ms_per_call(view, run, name: str):
    """Host ms of the spans named ``name`` a request, or None."""
    return per_call(run, view.span_ms(name) or None)


def launches(view, name: str):
    """Launch calls made inside the spans named ``name``, or None."""
    intervals = [(s, e) for s, e, n in view.host if n == name]
    if not intervals:
        return None
    starts = sorted(s for s, _, n in view.host
                    if n.startswith(LAUNCHES))
    return sum(bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s)
               for s, e in intervals)


def counter(name: str):
    """The program's counter ``name`` over the traced window, or None."""
    return spans.program_counters().get(name)
