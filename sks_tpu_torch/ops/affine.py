"""3-point affine transform solver (batched, division-free up to scale).

Port of ``sks_tpu/ops/affine.py``: with the per-plane affine frames
``A = [N - M, P - M]`` of ACA, the affine map taking ``M1,N1,P1`` to
``M2,N2,P2`` is, division-free,

    H = [[A2 adj(A1),  f1 M2 - A2 adj(A1) M1],
         [0, 0, f1]],          f1 = det A1
"""

from __future__ import annotations

import torch
from torch import Tensor

__all__ = ["affine_3pt_h", "affine_3pt", "affine_valid_mask"]


def affine_3pt_h(src: Tensor, tar: Tensor) -> Tensor:
    """Up-to-scale affine transform from 3 correspondences, division-free.

    Args:
      src: (..., 3, 2) source points [M1, N1, P1] (extra points ignored, so
        (..., 4, 2) minimal-solver layouts can be passed directly).
      tar: (..., 3, 2) target points [M2, N2, P2].

    Returns:
      (..., 3, 3) homogeneous affine matrix with last row ``[0, 0, det A1]``.
    """
    m1 = src[..., 0, :]
    e1 = src[..., 1, :] - m1
    f1v = src[..., 2, :] - m1
    m2 = tar[..., 0, :]
    e2 = tar[..., 1, :] - m2
    f2v = tar[..., 2, :] - m2

    f1 = e1[..., 0] * f1v[..., 1] - e1[..., 1] * f1v[..., 0]

    # A2 @ adj(A1): columns of A are the frame axes (e, f).
    # adj(A1) = [[f1y, -f1x], [-e1y, e1x]].
    t00 = e2[..., 0] * f1v[..., 1] - f2v[..., 0] * e1[..., 1]
    t01 = -e2[..., 0] * f1v[..., 0] + f2v[..., 0] * e1[..., 0]
    t10 = e2[..., 1] * f1v[..., 1] - f2v[..., 1] * e1[..., 1]
    t11 = -e2[..., 1] * f1v[..., 0] + f2v[..., 1] * e1[..., 0]

    t02 = f1 * m2[..., 0] - (t00 * m1[..., 0] + t01 * m1[..., 1])
    t12 = f1 * m2[..., 1] - (t10 * m1[..., 0] + t11 * m1[..., 1])

    zero = torch.zeros_like(f1)
    return torch.stack(
        [
            torch.stack([t00, t01, t02], dim=-1),
            torch.stack([t10, t11, t12], dim=-1),
            torch.stack([zero, zero, f1], dim=-1),
        ],
        dim=-2,
    )


def affine_3pt(src: Tensor, tar: Tensor) -> Tensor:
    """Affine transform normalized to ``H[2,2] == 1`` (exact affine last row)."""
    h = affine_3pt_h(src, tar)
    return h / h[..., 2:3, 2:3]


def affine_valid_mask(src: Tensor, eps: float | None = None) -> Tensor:
    """True where the 3 source points are not (numerically) collinear."""
    if eps is None:
        eps = 32 * torch.finfo(src.dtype).eps
    m = src[..., 0, :]
    e = src[..., 1, :] - m
    f = src[..., 2, :] - m
    det = e[..., 0] * f[..., 1] - e[..., 1] * f[..., 0]
    s = torch.maximum(e.abs().amax(-1), f.abs().amax(-1))
    return det.abs() > eps * s * s
