"""Timing harness: warm-up apart, a calibrated loop, the median of batches.

The counterpart of ``sks_tpu/bench/harness.py``.  The first call is timed
alone (``compile_seconds``: on CUDA it includes building the kernels at
first use), a pilot batch sizes the loop to a time budget, and the median
of ``repeats`` batches is reported.  On CUDA tensors the batches are timed
in device time, with ``bench.table8.device_ms``: a spin kernel holds the
stream while the host enqueues a batch, and CUDA events bracket it, so the
host's launch overhead does not show; a batch is sized so that its enqueue
fits inside the spin.  On the CPU, ``time.perf_counter``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch
from torch.utils._pytree import tree_leaves

from sks_tpu_torch.bench.table8 import device_ms

__all__ = ["BenchResult", "time_fn"]

#: The host may take at most this long to enqueue a timed CUDA batch: half
#: of the ~25 ms that ``device_ms``'s spin kernel holds an H100's stream.
_ENQUEUE_BUDGET_S = 0.0125


@dataclass
class BenchResult:
    seconds_per_call: float  # median over repeat batches
    mean_seconds: float
    min_seconds: float
    iters: int
    repeats: int
    compile_seconds: float

    def throughput(self, items_per_call: int) -> float:
        return items_per_call / self.seconds_per_call


def _on_cuda(args) -> bool:
    return any(isinstance(x, torch.Tensor) and x.is_cuda
               for x in tree_leaves(args))


def time_fn(
    fn,
    *args,
    budget_s: float = 2.0,
    repeats: int = 5,
    max_iters: int = 100_000,
) -> BenchResult:
    """Time ``fn(*args)``: warm-up, calibration, then ``repeats`` batches of
    ``iters`` calls each; per-call time is the median batch's.

    The device is CUDA when any argument is a CUDA tensor.  There each batch
    is timed in device time (``device_ms``), and ``iters`` is also capped so
    that the host enqueues a batch within half of the spin kernel's hold.
    """
    cuda = _on_cuda(args)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    fn(*args)
    sync()
    compile_s = time.perf_counter() - t0

    pilot = 32
    if cuda:
        once = max(device_ms(lambda: fn(*args), pilot) * 1e-3, 1e-9)
        t0 = time.perf_counter()
        for _ in range(pilot):
            fn(*args)
        enqueue = (time.perf_counter() - t0) / pilot
        sync()
        cap = max(1, int(_ENQUEUE_BUDGET_S / max(enqueue, 1e-9)))
    else:
        t0 = time.perf_counter()
        for _ in range(pilot):
            fn(*args)
        once = max((time.perf_counter() - t0) / pilot, 1e-9)
        cap = max_iters
    iters = int(min(max_iters, cap, max(100, budget_s / repeats / once)))

    samples = []
    for _ in range(repeats):
        if cuda:
            samples.append(device_ms(lambda: fn(*args), iters) * 1e-3)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            samples.append((time.perf_counter() - t0) / iters)
    samples.sort()
    return BenchResult(
        seconds_per_call=samples[len(samples) // 2],
        mean_seconds=sum(samples) / len(samples),
        min_seconds=samples[0],
        iters=iters,
        repeats=repeats,
        compile_seconds=compile_s,
    )
