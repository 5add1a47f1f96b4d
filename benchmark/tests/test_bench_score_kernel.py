"""The reader of ``score_kernel_per_chunk.o90``, the eager chunk's scoring
kernel launches per chunk, on the hand-made trace and counters of
``test_bench_spans``."""

from __future__ import annotations

import sys
import types

import pytest

from benchmark.core import spans, spec
from benchmark.tests.test_bench_spans import COUNTERS, EVENTS, _read

SCORE_KERNEL = "score_kernel_per_chunk.o90"


@pytest.mark.parametrize("counted,want", [
    ({"ransac.score_kernel": 4}, 1.0),  # every chunk scored in the kernel
    ({"ransac.score_kernel": 3}, 0.75),
    ({}, None),  # a program that scores its chunks eagerly
])
def test_the_score_kernel_reader(monkeypatch, counted, want):
    """``ransac.score_kernel`` over ``ransac.chunks``; None where the
    program keeps no such counter (the parent of the kernel), where it
    counts no chunk, or where no program module was loaded."""
    module = types.SimpleNamespace(
        counters=lambda: {**COUNTERS, **counted})
    monkeypatch.setitem(sys.modules, spans.COUNTERS_MODULE, module)
    assert _read(SCORE_KERNEL, EVENTS) == (
        None if want is None else pytest.approx(want))
    module.counters = lambda: {**counted, "ransac.chunks": 0}
    assert _read(SCORE_KERNEL, EVENTS) is None
    monkeypatch.delitem(sys.modules, spans.COUNTERS_MODULE)
    assert _read(SCORE_KERNEL, EVENTS) is None


def test_the_score_kernel_entry():
    m = {m["name"]: m for m in spec.load_spec()["per_layer"]}[SCORE_KERNEL]
    assert (m["moves"], m["source"], m["better"], m["unit"]) == (
        "fit_ms_p50", "program_counter", "higher", "launches")
    assert m["workloads"] == ["fit-n2000.o90-adaptive"]
    assert callable(spec.reader("metrics", SCORE_KERNEL))
