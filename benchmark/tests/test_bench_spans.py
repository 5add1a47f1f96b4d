"""The span index (``core/spans.py``) and the readers of the program's spans
and counters, on a hand-made trace of two fits and a hand-made counter
set."""

from __future__ import annotations

import sys
import types

import pytest
import torch

from benchmark.core import spans, spec
from benchmark.core.trace import WINDOW, TraceView

COUNTED = ("hypotheses_per_fit.o90", "draws_over_bound.o90",
           "chunks_counted_per_fit.o90", "host_reads_per_fit.o90")
READERS = ("tail_ms_per_fit", "irls_ms_per_fit", "polish_ms_per_fit",
           "tail_launches_per_fit", "tail_idle_share.fit",
           "sync_ms_per_fit.o90", "chunk_ms_per_fit", "draw_ms_per_fit",
           "k2_launch_ms_per_fit", "rescore_ms_per_fit", *COUNTED)
COUNTERS = {"ransac.hypotheses": 2000, "ransac.chunks": 4,
            "ransac.host_reads": 5, "ransac.bound": 1500.0}
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class _Event:
    def __init__(self, name, start, end, device=CPU):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d


def _fit(t0, launches):
    """One fit at ``t0``: its spans, and launch calls at the offsets
    given."""
    events = [_Event("ransac/fit", t0, t0 + 400),
              _Event("ransac/sync", t0 + 20, t0 + 40),
              _Event("ransac/chunk", t0 + 40, t0 + 100),
              _Event("ransac/draw", t0 + 40, t0 + 55),
              _Event("ransac/k2", t0 + 55, t0 + 65),
              _Event("cudaLaunchKernel", t0 + 60, t0 + 62),
              _Event("ransac/rescore", t0 + 65, t0 + 95),
              _Event("ransac/tail", t0 + 100, t0 + 400),
              _Event("ransac/irls", t0 + 120, t0 + 220),
              _Event("aten::mul", t0 + 125, t0 + 135),
              _Event("ransac/polish", t0 + 250, t0 + 350)]
    return events + [_Event(name, t0 + dt, t0 + dt + 2)
                     for name, dt in launches]


EVENTS = [
    _Event(WINDOW, 0, 1000),
    *_fit(0, [("cudaLaunchKernel", 130), ("cudaMemcpyAsync", 140),
              ("cudaLaunchKernel", 260)]),
    *_fit(500, [("cuLaunchKernel", 120), ("cudaMemsetAsync", 230),
                ("cudaLaunchKernel", 250)]),
    _Event("ransac/tail", 550, 560, CUDA),  # a host range's device copy
    _Event("k", 50, 150, CUDA), _Event("k", 140, 200, CUDA),
    _Event("k", 620, 640, CUDA), _Event("k", 650, 660, CUDA),
]


@pytest.fixture
def program(monkeypatch):
    """The program's counters module, as a run that loaded it holds it."""
    module = types.SimpleNamespace(counters=lambda: dict(COUNTERS))
    monkeypatch.setitem(sys.modules, spans.COUNTERS_MODULE,
                        module)
    return module


def _read(name, events):
    return spec.reader("metrics", name)(TraceView(events), {"requests": 2})


def test_the_index_totals_each_span():
    view = TraceView(EVENTS)
    assert spans.fits(view) == 2
    tail = spans.span(view, "ransac/tail")
    assert tail.opened == 2 and tail.host_ms == pytest.approx(600e-6)
    assert tail.launches == 6
    # Busy inside the tails: 100-200 of the first (two kernels merged), 20 +
    # 10 ns of the second.
    assert tail.idle_ms == pytest.approx((300 - 100 + 300 - 30) / 1e6)
    irls = spans.span(view, "ransac/irls")
    assert irls.launches == 3 and irls.idle_ms == pytest.approx(
        (100 - 80 + 100 - 30) / 1e6)
    polish = spans.span(view, "ransac/polish")  # no kernel inside
    assert polish.idle_ms == pytest.approx(polish.host_ms)
    k2 = spans.span(view, "ransac/k2")
    assert k2.opened == 2 and k2.launches == 2
    assert spans.span(view, "ransac/general") is None
    assert spans.span(view, "cudaLaunchKernel") is None


def test_the_readers_on_two_fits(program):
    want = {"tail_ms_per_fit": 300e-6, "irls_ms_per_fit": 100e-6,
            "polish_ms_per_fit": 100e-6, "tail_launches_per_fit": 3.0,
            "tail_idle_share.fit": 100.0 * 470 / 600,
            "sync_ms_per_fit.o90": 20e-6, "chunk_ms_per_fit": 60e-6,
            "draw_ms_per_fit": 15e-6, "k2_launch_ms_per_fit": 10e-6,
            "rescore_ms_per_fit": 30e-6, "hypotheses_per_fit.o90": 1000.0,
            "draws_over_bound.o90": 2000 / 1500,
            "chunks_counted_per_fit.o90": 2.0,
            "host_reads_per_fit.o90": 2.5}
    got = {name: _read(name, EVENTS) for name in READERS}
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_a_run_with_no_fit_span_reads_none(program, name):
    """A program that opens no ``ransac/fit`` (the parent of these spans)
    reads None, and raises nothing."""
    events = [e for e in EVENTS if e.name() != "ransac/fit"]
    assert _read(name, events) is None


@pytest.mark.parametrize("name", COUNTED)
def test_a_program_with_no_counters_reads_none(monkeypatch, name):
    monkeypatch.setitem(sys.modules, spans.COUNTERS_MODULE,
                        types.SimpleNamespace())
    assert _read(name, EVENTS) is None
    monkeypatch.delitem(sys.modules, spans.COUNTERS_MODULE)
    assert _read(name, EVENTS) is None


def test_the_idle_share_needs_device_kernels(program):
    events = [e for e in EVENTS if e.device_type() != CUDA]
    assert _read("tail_idle_share.fit", events) is None
    assert _read("tail_ms_per_fit", events) == pytest.approx(300e-6)


def test_the_new_entries_name_their_readers():
    entries = {m["name"]: m for m in spec.load_spec()["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["moves"] == "fit_ms_p50"
        assert m["source"] == ("program_counter" if name in COUNTED
                               else "program_span")
        assert callable(spec.reader("metrics", name))
