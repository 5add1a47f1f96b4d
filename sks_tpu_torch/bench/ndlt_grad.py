"""How far the NDLT head's float32 gradient lies from its float64 one.

The NDLT head (``models.offsets_to_h(..., "ndlt")``) differentiates through
8 fixed sweeps of cyclic Jacobi on the DLT normal matrix of a rectangle and
its offset corners.  That matrix carries ties: its x and y blocks share
their diagonal, and the source block of a rectangle normalizes to nearly 4 I.
The float32 gradient of such a tie's rotation angle is rounding noise times
a large factor (``ops.linalg.jacobi_eigh``), so this script reads the whole
distribution of the error, not one batch's largest entry.

For ``batch`` rectangles drawn as the head tests draw them (origin in
[0, 64)^2, size in [32, 128)^2, offsets in [-16, 16)^2; ``exact`` snaps the
origin to integers and the size to 32 or 64, so that the corners normalize
to exactly +-1), the gradient of a random weighting of H to the offsets, in
float32 and in float64; per rectangle, the largest difference over the
largest float64 entry; the median, the 99th percentile and the largest of
these, and how many exceed 1e-4.

Run from the repository root (CPU by default; the numbers are accuracy, not
time):

    python -m sks_tpu_torch.bench.ndlt_grad [--batch 512] [--seed 11]
        [--exact] [--device cpu]
"""

from __future__ import annotations

import json

import numpy as np
import torch

from sks_tpu_torch.models import offsets_to_h

__all__ = ["gradient_tail"]


def gradient_tail(batch: int = 512, seed: int = 11, exact: bool = False,
                  device="cpu") -> dict:
    """The float32 NDLT head gradient's error against float64, per
    rectangle (see the module docstring)."""
    rng = np.random.default_rng(seed)
    origin = rng.uniform(0.0, 64.0, (batch, 2))
    size = rng.uniform(32.0, 128.0, (batch, 2))
    offsets = rng.uniform(-16.0, 16.0, (batch, 4, 2))
    weights = rng.normal(size=(batch, 3, 3))
    if exact:
        origin = np.floor(origin)
        size = 2.0 ** rng.integers(5, 7, (batch, 2))

    def grad(dtype):
        def t(x):
            return torch.tensor(x, dtype=dtype, device=device)

        o = t(offsets).requires_grad_()
        h = offsets_to_h(o, t(origin), t(size), "ndlt")
        torch.sum(h * t(weights)).backward()
        return o.grad.cpu().double().reshape(batch, -1)

    g64 = grad(torch.float64)
    err = ((grad(torch.float32) - g64).abs().amax(-1)
           / g64.abs().amax(-1)).numpy()
    return {"batch": batch, "seed": seed, "exact": exact,
            "median": float(np.median(err)),
            "p99": float(np.percentile(err, 99)), "max": float(err.max()),
            "over_1e-4": int((err > 1e-4).sum())}


def main(argv=None) -> None:
    """Console entry point: print the result as one JSON line."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--exact", action="store_true")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    print(json.dumps(gradient_tail(args.batch, args.seed, args.exact,
                                   args.device)))


if __name__ == "__main__":
    main()
