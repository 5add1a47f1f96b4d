"""Solver sweeps: each registered solver on ``(B, 4, 2)``, at the reference's
batch sizes.

The counterpart of ``sks_tpu/bench/solvers.py``: the latency of
``SOLVERS_H[name]`` (the eager op, as a user calls it on ``(B, 4, 2)``
points) at B in {1, 10, ..., 1M}, through ``bench.harness.time_fn``, on
random general-position quads drawn anew for each sweep.  It is not a second
Table 8: ``bench/table8.py`` times the hand-written kernels on their
``(8, B)`` layout beside their plain versions and the reference's times.
"""

from __future__ import annotations

import torch

from sks_tpu_torch.bench.harness import BenchResult, time_fn
from sks_tpu_torch.ops import SOLVERS_H
from sks_tpu_torch.utils.synth import random_quad_pairs

__all__ = ["bench_solver", "sweep", "REFERENCE_B_SWEEP"]

REFERENCE_B_SWEEP = (1, 10, 100, 1_000, 10_000, 100_000, 1_000_000)


def bench_solver(
    name: str,
    batch: int,
    dtype=torch.float32,
    seed: int = 0,
    budget_s: float = 2.0,
    device="cuda",
) -> BenchResult:
    """Time one solver at one batch size (the solve only, H materialized)."""
    g = torch.Generator(device=device).manual_seed(seed)
    src, tar = random_quad_pairs(g, batch, dtype)
    return time_fn(SOLVERS_H[name], src, tar, budget_s=budget_s)


def sweep(
    names=("aca", "sks", "rho_ge", "gpt_lu", "ho", "ndlt"),
    batches=REFERENCE_B_SWEEP,
    dtype=torch.float32,
    budget_s: float = 1.0,
    device="cuda",
):
    """The Table-8-shaped sweep of the eager solvers: {name: {B: BenchResult}}."""
    return {name: {b: bench_solver(name, b, dtype, budget_s=budget_s,
                                   device=device) for b in batches}
            for name in names}
