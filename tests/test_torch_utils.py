"""Port parity, the small utilities: ``utils/checks.py``, ``utils/flops.py``,
``utils/profiling.py``, ``bench/harness.py`` and ``bench/solvers.py``; and
``utils/graphs.may_leave_eager``, the port's one rule for leaving eager
PyTorch, which has no JAX counterpart.

The flops registry is data, equal to the JAX package's.  The operation count
of ``cost_analysis`` (the counter of ``bench/roofline.py``) is held to the
registry with the slack the JAX package's own test allows XLA's count
(``tests/test_utils.py``): between 0.5x and 8x the paper's count.  The
checks give the JAX package's messages on the same batches, and
``nonfinite_fraction`` its value exactly.  The harness returns the JAX
harness's fields.
"""

import contextlib
import dataclasses
import os
from types import SimpleNamespace

import jax.numpy as jnp
import pytest
import torch

from torch_parity import quads

import sks_tpu.bench.harness as jh
import sks_tpu.utils.checks as jc
import sks_tpu.utils.flops as jfl

import sks_tpu_torch.bench.harness as th
import sks_tpu_torch.utils.checks as tc
import sks_tpu_torch.utils.flops as tfl
from sks_tpu_torch.bench.solvers import REFERENCE_B_SWEEP, bench_solver
from sks_tpu_torch.ops import SOLVERS_H
from sks_tpu_torch.utils.graphs import may_leave_eager
from sks_tpu_torch.utils.profiling import (
    annotate,
    cost_analysis,
    device_trace,
    wall,
)

T = torch.from_numpy


def test_flops_registry_is_the_jax_packages():
    assert tfl.FLOPS == jfl.FLOPS
    for width in (2, 4, 8):
        assert tfl.bytes_per_hypothesis(width) == jfl.bytes_per_hypothesis(
            width)
        assert tfl.roofline_hps(3350.0, width) == jfl.roofline_hps(3350.0,
                                                                   width)
    assert tfl.bytes_per_hypothesis(4) == 100
    assert tfl.bytes_per_hypothesis(2) == 50
    # An H100 SXM's 3.35 TB/s over 100 B a hypothesis.
    assert tfl.roofline_hps(3350.0) == pytest.approx(3.35e10)


@pytest.mark.parametrize("name", ["aca", "sks"])
def test_counted_operations_against_the_registry(name):
    s, t = quads(0, 256)
    ca = cost_analysis(SOLVERS_H[name], T(s), T(t))
    per = ca["flops"] / 256
    assert tfl.FLOPS[name]["solve"] * 0.5 <= per <= tfl.FLOPS[name][
        "solve"] * 8, per
    # Inputs once (16 float32), outputs once (9 float32) a hypothesis.
    assert ca["bytes accessed"] == 256 * 100


def _degenerate(s):
    bad = s.copy()
    bad[:, 2] = 0.5 * (s[:, 0] + s[:, 1])  # collinear anchors
    bad[:, 3] = bad[:, 0]  # and a repeated point
    return bad


@pytest.mark.parametrize("name", ["aca", "sks", "rho_ge"])
def test_checked_solver_reports_as_jax(name):
    s, t = quads(1, 8)
    err, h = tc.checked_solver(name)(T(s), T(t))
    assert err is None and h.shape == (8, 3, 3)
    jerr, _ = jc.checked_solver(name)(jnp.asarray(s), jnp.asarray(t))
    jerr.throw()
    bad = _degenerate(s)
    err, _ = tc.checked_solver(name)(T(bad), T(t))
    jerr, _ = jc.checked_solver(name)(jnp.asarray(bad), jnp.asarray(t))
    assert err is not None and jerr.get() is not None
    assert err.get() in jerr.get(), (err.get(), jerr.get())
    with pytest.raises(ValueError, match="homography in batch"):
        err.throw()


def test_nonfinite_fraction_and_assert_finite():
    s, t = quads(2, 16)
    h = SOLVERS_H["aca"](T(s), T(t))
    frac = tc.nonfinite_fraction(h)
    assert frac.dim() == 0 and float(frac) == 0.0
    h[0, 0, 0] = float("nan")
    h[3, 2, 1] = float("inf")
    want = float(jc.nonfinite_fraction(jnp.asarray(h.numpy())))
    assert float(tc.nonfinite_fraction(h)) == want == 2 / 16
    x = torch.ones(4)
    assert tc.assert_finite(x) is x
    with pytest.raises(FloatingPointError, match="bad H"):
        tc.assert_finite(h, "bad H")


def test_device_trace_annotate_and_wall(tmp_path):
    s, t = (T(a) for a in quads(3, 64))
    with device_trace(str(tmp_path)) as prof:
        with annotate("sks/solve"):
            SOLVERS_H["aca"](s, t)
    names = {e.name for e in prof.events()}
    assert "sks/solve" in names
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))
    assert 0.0 < wall(SOLVERS_H["aca"], s, t, repeats=2) < 5.0


def test_time_fn_fields_as_the_jax_harness():
    assert [f.name for f in dataclasses.fields(th.BenchResult)] == [
        f.name for f in dataclasses.fields(jh.BenchResult)]
    s, t = (T(a) for a in quads(4, 32))
    res = th.time_fn(SOLVERS_H["aca"], s, t, budget_s=0.05, repeats=3)
    assert res.repeats == 3 and res.iters >= 100
    assert 0 < res.min_seconds <= res.seconds_per_call
    assert res.compile_seconds > 0
    assert res.throughput(32) == pytest.approx(32 / res.seconds_per_call)


@pytest.mark.parametrize("name", ["aca", "gpt_lu"])
def test_bench_solver_at_b10_on_the_cpu(name):
    res = bench_solver(name, 10, budget_s=0.05, device="cpu")
    assert isinstance(res, th.BenchResult) and res.seconds_per_call > 0
    assert REFERENCE_B_SWEEP[1] == 10 and REFERENCE_B_SWEEP[-1] == 1_000_000



@pytest.mark.parametrize(
    "case", ["card", "cpu", "requires_grad", "no_grad", "vmap", "grad"])
def test_one_rule_for_leaving_eager_pytorch(case):
    """``may_leave_eager``, which the tail kernels' routes and the graph
    replays take: only for a first tensor on the card, with no autograd
    graph to record and no torch.func transform active.  A namespace with
    ``is_cuda`` and ``requires_grad`` stands in for a CUDA tensor."""
    card = SimpleNamespace(is_cuda=True, requires_grad=False)
    needs_grad = SimpleNamespace(is_cuda=True, requires_grad=True)
    if case in ("vmap", "grad"):
        seen = []
        getattr(torch.func, case)(
            lambda x: seen.append(may_leave_eager(card)) or x.sum())(
                torch.zeros(2))
        assert seen == [False]
        return
    with torch.no_grad() if case == "no_grad" else contextlib.nullcontext():
        ok = may_leave_eager(torch.zeros(2) if case == "cpu" else card,
                             needs_grad if "grad" in case else card)
    assert ok == (case in ("card", "no_grad"))
