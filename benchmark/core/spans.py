"""The program's own spans and counters in a traced run, per fit.

The program opens named ranges (``record_function``, through its
``utils.profiling.annotate``) at the boundaries of its layers: ``ransac/fit``
around one single-pair fit, ``ransac/tail`` around its refit and polish,
``ransac/irls``, ``ransac/polish``, ``ransac/chunk`` (one chunk of
hypotheses) with the fused chunk's ``ransac/draw``, ``ransac/k2`` and
``ransac/rescore``, and ``ransac/sync`` (the adaptive loop's host read).
The spans are the host events of a
:class:`~benchmark.core.trace.TraceView` (its public ``host`` and
``kernels`` lists), so they share the device kernels' clock.  Each is
indexed once a traced run: per span name, its host ms, how many times it
opened, the launches made inside it (the host runtime calls that put work
on the card: ``cudaLaunch*``, ``cuLaunch*``, ``cudaMemcpy*``,
``cudaMemset*``) and the ms inside it in which no device operation ran.

Counters are the program's (``utils.profiling.counters()``), read from the
program's module where the run loaded it; nothing here imports the program.
A run of a program that opens no ``ransac/fit`` span, or keeps no counter,
reads None.
"""

from __future__ import annotations

import bisect
import sys
import weakref
from dataclasses import dataclass

FIT = "ransac/fit"
#: Span names the index keeps: the program's RANSAC ranges.
PREFIX = "ransac/"
#: Host runtime calls that put work on the card.
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")
#: The program's module that keeps its counters.
COUNTERS_MODULE = "sks_tpu_torch.utils.profiling"


@dataclass
class Span:
    """One span name's totals over the traced window."""

    host_ms: float = 0.0
    opened: int = 0
    launches: int = 0
    idle_ms: float = 0.0


class _Index:
    def __init__(self, view):
        starts, ends, cum = [], [], [0]
        for start, end, _ in view.kernels:  # sorted by start
            end = min(end, view.t1)  # the window's busy time, as TraceView's
            if ends and start <= ends[-1]:
                if end > ends[-1]:
                    cum[-1] += end - ends[-1]
                    ends[-1] = end
            else:
                starts.append(start)
                ends.append(end)
                cum.append(cum[-1] + end - start)
        self._starts, self._ends, self._cum = starts, ends, cum
        self.has_kernels = bool(starts)
        launches, spans = [], {}
        for start, end, name in view.host:
            if name.startswith(LAUNCHES):
                launches.append(start)
            elif name.startswith(PREFIX):
                spans.setdefault(name, []).append((start, end))
        launches.sort()
        self.spans = {}
        for name, intervals in spans.items():
            total = Span()
            for start, end in intervals:
                busy = self._busy_before(end) - self._busy_before(start)
                total.host_ms += (end - start) / 1e6
                total.opened += 1
                total.launches += (bisect.bisect_right(launches, end)
                                   - bisect.bisect_left(launches, start))
                total.idle_ms += (end - start - busy) / 1e6
            self.spans[name] = total

    def _busy_before(self, t: int) -> int:
        """Nanoseconds before ``t`` in which some device operation ran."""
        k = bisect.bisect_right(self._starts, t)
        if not k:
            return 0
        return self._cum[k] - max(0, self._ends[k - 1] - t)


_INDEX: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _index(view) -> _Index:
    if view not in _INDEX:
        _INDEX[view] = _Index(view)
    return _INDEX[view]


def span(view, name: str) -> Span | None:
    """The totals of span ``name`` in the traced window, or None where it
    never opened."""
    return _index(view).spans.get(name)


def fits(view) -> int:
    """The single-pair fits of the traced window: ``ransac/fit`` spans."""
    fit = span(view, FIT)
    return fit.opened if fit else 0


def has_kernels(view) -> bool:
    return _index(view).has_kernels


def per_fit(view, value) -> float | None:
    """``value`` over the fits of the window; None without either."""
    n = fits(view)
    return None if value is None or not n else value / n


def program_counters() -> dict:
    """The program's counters over the traced window ({} where the run did
    not load the module that keeps them, or the program keeps none)."""
    read = getattr(sys.modules.get(COUNTERS_MODULE), "counters", None)
    return read() if callable(read) else {}
