"""Profiling helpers: device traces, named ranges, counters, operation and
byte counts.

The counterpart of ``sks_tpu/utils/profiling.py``: ``device_trace`` and
``annotate`` wrap ``torch.profiler`` where the JAX package wraps
``jax.profiler``; ``wall`` times a call to its end (a ``synchronize`` on CUDA
tensors).  ``cost_analysis`` replaces XLA's compiled cost analysis, which has
no counterpart here, with what the port's bounds count
(``bench/roofline.py``): the arithmetic of one eager call, counted by a
``TorchDispatchMode``, and the bytes of its inputs read once and its outputs
written once.

``annotate`` (a named range) and ``count`` (a named counter) are the
program's one way into a trace.  Both act only while a profiler records;
otherwise each costs one check (``torch.autograd._profiler_enabled``), so
the hot path keeps them with tracing off.  Counters therefore cover exactly
the traced window, the window of the ranges: ``counters()`` reads them
after it, ``reset_counters()`` starts them again.
"""

from __future__ import annotations

import contextlib
import tempfile
import time

import torch
from torch.utils._pytree import tree_leaves

from sks_tpu_torch.bench.roofline import H100_FLOPS, count_ops

__all__ = ["device_trace", "annotate", "count", "counters", "reset_counters",
           "cost_analysis", "wall"]

_recording = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
#: name -> the values counted while a profiler recorded, summed on read.
_COUNTS: dict[str, list] = {}


@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """Trace the host and, where there is one, the CUDA device; on exit the
    trace is written to ``logdir`` (a new temporary directory by default)
    for TensorBoard.  Yields the profiler (``key_averages()``, ``events()``).
    The counters start again with the trace, so ``counters()`` after it
    reads this window alone."""
    logdir = logdir or tempfile.mkdtemp(prefix="sks_tpu_torch_trace_")
    reset_counters()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof


def annotate(name: str):
    """A named range for a host-side phase: ``record_function`` while a
    profiler records, else a null context."""
    if _recording():
        return torch.profiler.record_function(name)
    return _NULL


def count(name: str, value=1) -> None:
    """Add ``value`` to the counter ``name`` while a profiler records.

    ``value`` may be a device tensor: it is kept as it is and summed and
    read only by :func:`counters`, after the window, so a counter adds no
    host read, and with no profiler recording no work at all (pass a mask,
    not its sum).
    """
    if _recording():
        _COUNTS.setdefault(name, []).append(value)


def counters() -> dict:
    """Each counter's sum since the last :func:`reset_counters` (device
    values are read here, one at a time).

    :func:`device_trace` resets them as it starts; a caller that records
    with a profiler of its own calls :func:`reset_counters` before each
    window, or reads every window since the last reset.  Until then each
    counted device value stays alive.
    """
    return {name: sum(v.sum().item() if isinstance(v, torch.Tensor) else v
                      for v in values)
            for name, values in _COUNTS.items()}


def reset_counters() -> None:
    """Set every counter back to nothing."""
    _COUNTS.clear()


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def cost_analysis(fn, *args) -> dict:
    """Operations and bytes of ``fn(*args)``: ``{"flops": ..., "bytes
    accessed": ...}`` (XLA's key names), plus ``"other ops"``.

    ``flops`` is the floating-point arithmetic the eager call does (adds,
    multiplies, divisions, square roots, sums; ``bench.roofline.count_ops``);
    compares, selects and sign flips are ``other ops``.  ``bytes accessed``
    is every input tensor read once plus every output tensor written once.
    Run it on CPU tensors of a small size: the count scales with the batch.
    """
    out = []
    ops = count_ops(lambda *a: out.append(fn(*a)), *args)
    return {
        "flops": float(sum(ops.get(k, 0) for k in H100_FLOPS)),
        "other ops": float(ops.get("other", 0)),
        "bytes accessed": float(_nbytes(args) + _nbytes(out)),
    }


def _sync(result) -> None:
    if any(isinstance(x, torch.Tensor) and x.is_cuda
           for x in tree_leaves(result)):
        torch.cuda.synchronize()


def wall(fn, *args, repeats: int = 3) -> float:
    """Seconds of the fastest of ``repeats`` calls, each to its end (after
    one call that is not timed)."""
    _sync(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best
