"""Per-pair random streams: one ``torch.Generator`` per fitted pair.

The counterpart of ``sks_tpu/utils/rng.py``, where batched fits derive
per-item keys as ``fold_in(key, offset + i)``.  Here pair i of a batch gets
its own generator, seeded from ``(seed, offset + i)``: a pair's minimal sets
then depend on the seed and its index alone, not on which other pairs share
its launch or in what order they draw.  Callers that need a second stream
from the same seed (loop-closure fits beside consecutive-pair fits) use
disjoint offset ranges; ``CLOSURE_STREAM_OFFSET`` marks the reserved block.
"""

from __future__ import annotations

import torch

__all__ = ["CLOSURE_STREAM_OFFSET", "pair_generators"]

#: Offset of the loop-closure stream in ``slam.odometry.vo_trajectory``;
#: consecutive pairs use [0, T-1), so T-1 must stay below this.
CLOSURE_STREAM_OFFSET = 10_000

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _stream_seed(seed: int, index: int) -> int:
    """The seed of stream ``index`` under ``seed``: a 63-bit mix of the two
    (distinct indices give unrelated seeds)."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (index & _MASK64)) >> 1


def pair_generators(generator_or_seed: torch.Generator | int | None, n: int,
                    offset: int = 0, device=None) -> list[torch.Generator]:
    """``n`` generators on ``device``: stream ``offset + i`` of the seed.

    Args:
      generator_or_seed: an int seed (None: 0), or a ``torch.Generator``
        whose ``initial_seed()`` is the seed (its own state is neither read
        nor advanced).
      n: number of pairs.
      offset: index of the first stream.
      device: where the generators draw (default: the given generator's
        device, else the CPU).
    """
    if isinstance(generator_or_seed, torch.Generator):
        seed = generator_or_seed.initial_seed()
        if device is None:
            device = generator_or_seed.device
    else:
        seed = int(generator_or_seed or 0)
    device = torch.device("cpu" if device is None else device)
    return [torch.Generator(device=device).manual_seed(
        _stream_seed(seed, offset + i)) for i in range(n)]
