"""GPT-LU — 4-point homography via the 8x8 linear system (batched).

Port of ``sks_tpu/ops/gpt.py``: build ``A h = b`` with ``h = (h1..h8)`` and
``h9 = 1`` fixed (OpenCV's ``getPerspectiveTransform`` system), and solve by
Gauss-Jordan with partial pivoting.  Two formulations, as in the JAX package:
:func:`gpt_lu` (the registered solver: ``solve_unrolled(pivot=True)`` or
``torch.linalg.solve``) and :func:`gpt_core`, the straight-line component
form with bubble-pass pivoting that is the plain version of the CUDA kernel
``gpt_solve_soa`` and the specification of its body (``csrc/baselines.cu``).
"""

from __future__ import annotations

import torch
from torch import Tensor

from sks_tpu_torch.ops.linalg import solve_unrolled

__all__ = ["gpt_core", "gpt_lu", "build_gpt_system"]


def gpt_core(
    x0, y0, x1, y1, x2, y2, x3, y3,
    X0, Y0, X1, Y1, X2, Y2, X3, Y3,
):
    """Straight-line pivoted 8x8 Gauss-Jordan on scalar-like components.

    The 8x9 tableau is a list of component tensors and the elimination order
    is static.  Partial pivoting is a branch-free bubble pass: for each row r
    below k, swap rows k and r (columns k..8) where ``|t[r][k]| > |t[k][k]|``
    strictly, so a NaN never swaps and ties keep the upper row.

    Returns the 9 homography entries row-major, ``H[2,2] == 1``.
    """
    xs = (x0, x1, x2, x3)
    ys = (y0, y1, y2, y3)
    Xs = (X0, X1, X2, X3)
    Ys = (Y0, Y1, Y2, Y3)
    one = torch.ones_like(x0)
    zero = torch.zeros_like(x0)

    # Tableau rows [A | b]: x-constraints then y-constraints.
    t = [
        [xs[i], ys[i], one, zero, zero, zero, -xs[i] * Xs[i],
         -ys[i] * Xs[i], Xs[i]]
        for i in range(4)
    ] + [
        [zero, zero, zero, xs[i], ys[i], one, -xs[i] * Ys[i],
         -ys[i] * Ys[i], Ys[i]]
        for i in range(4)
    ]

    for k in range(8):
        # Columns < k are already eliminated (exact zeros), so swaps only
        # need columns k..8.
        for r in range(k + 1, 8):
            swap = torch.abs(t[r][k]) > torch.abs(t[k][k])
            for c in range(k, 9):
                a, b = t[k][c], t[r][c]
                t[k][c] = torch.where(swap, b, a)
                t[r][c] = torch.where(swap, a, b)
        inv = 1.0 / t[k][k]
        for c in range(k + 1, 9):
            t[k][c] = t[k][c] * inv
        t[k][k] = one
        for r in range(8):
            if r == k:
                continue
            f = t[r][k]
            for c in range(k + 1, 9):
                t[r][c] = t[r][c] - f * t[k][c]
            t[r][k] = zero

    return (t[0][8], t[1][8], t[2][8], t[3][8], t[4][8], t[5][8],
            t[6][8], t[7][8], one)


def build_gpt_system(src: Tensor, tar: Tensor):
    """The classic getPerspectiveTransform 8x8 system.

    Rows i in 0..3:   [x, y, 1, 0, 0, 0, -x X, -y X] . h = X
    Rows i in 4..7:   [0, 0, 0, x, y, 1, -x Y, -y Y] . h = Y
    """
    x, y = src[..., 0], src[..., 1]
    xp, yp = tar[..., 0], tar[..., 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    top = torch.stack([x, y, one, zero, zero, zero, -x * xp, -y * xp], dim=-1)
    bot = torch.stack([zero, zero, zero, x, y, one, -x * yp, -y * yp], dim=-1)
    a = torch.cat([top, bot], dim=-2)  # (..., 8, 8)
    b = torch.cat([xp, yp], dim=-1)  # (..., 8)
    return a, b


def gpt_lu(src: Tensor, tar: Tensor, method: str = "unrolled") -> Tensor:
    """4-point homography with ``H[2,2] == 1`` by construction.

    Args:
      src, tar: (..., 4, 2).
      method: 'unrolled' (branch-free pivoted Gauss-Jordan) or 'lax'
        (``torch.linalg.solve``, the counterpart of ``jnp.linalg.solve``).

    Returns:
      (..., 3, 3).
    """
    a, b = build_gpt_system(src, tar)
    if method == "unrolled":
        h8 = solve_unrolled(a, b, pivot=True)
    elif method == "lax":
        h8 = torch.linalg.solve(a, b[..., None])[..., 0]
    else:
        raise ValueError(f"unknown method {method!r}")
    one = torch.ones_like(h8[..., :1])
    h = torch.cat([h8, one], dim=-1)
    return h.reshape(*h.shape[:-1], 3, 3)
