"""Homography action, residuals, and synthesis from camera geometry.

Port of ``sks_tpu/geom/homography.py``: the same functions on torch tensors.
"""

from __future__ import annotations

import torch
from torch import Tensor

__all__ = [
    "apply_homography",
    "reprojection_error",
    "symmetric_transfer_error",
    "homography_from_pose",
    "normalize_h",
    "inv_h",
]


def apply_homography(h: Tensor, pts: Tensor) -> Tensor:
    """Apply (..., 3, 3) homography to (..., N, 2) points -> (..., N, 2).

    Batch dims of ``h`` and ``pts`` broadcast.
    """
    x, y = pts[..., 0], pts[..., 1]
    hb = h[..., None, :, :]  # broadcast over N
    u = hb[..., 0, 0] * x + hb[..., 0, 1] * y + hb[..., 0, 2]
    v = hb[..., 1, 0] * x + hb[..., 1, 1] * y + hb[..., 1, 2]
    w = hb[..., 2, 0] * x + hb[..., 2, 1] * y + hb[..., 2, 2]
    inv = 1.0 / w
    return torch.stack([u * inv, v * inv], dim=-1)


def reprojection_error(h: Tensor, src: Tensor, tar: Tensor) -> Tensor:
    """Forward transfer error ||H(src) - tar|| per point: (..., N)."""
    d = apply_homography(h, src) - tar
    return torch.sqrt(torch.sum(d * d, dim=-1))


def symmetric_transfer_error(h: Tensor, src: Tensor, tar: Tensor) -> Tensor:
    """Squared symmetric transfer error per point: (..., N).

    ``||H(src) - tar||^2 + ||H^{-1}(tar) - src||^2``; the inverse is the
    adjugate (no division; the scale of a homography is free).
    """
    d1 = apply_homography(h, src) - tar
    d2 = apply_homography(inv_h(h), tar) - src
    return torch.sum(d1 * d1, dim=-1) + torch.sum(d2 * d2, dim=-1)


def inv_h(h: Tensor) -> Tensor:
    """Up-to-scale inverse of a homography: the adjugate (division-free)."""
    a, b, c = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    d, e, f = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    g, i, j = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]
    return torch.stack(
        [
            torch.stack([e * j - f * i, c * i - b * j, b * f - c * e], dim=-1),
            torch.stack([f * g - d * j, a * j - c * g, c * d - a * f], dim=-1),
            torch.stack([d * i - e * g, b * g - a * i, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )


def normalize_h(h: Tensor, mode: str = "last") -> Tensor:
    """Canonicalize the free scale of a homography.

    mode 'last': divide by H[2,2] (reference convention).
    mode 'fro':  unit Frobenius norm with positive H[2,2] — well-defined even
    for affine-limit homographies.
    """
    if mode == "last":
        return h / h[..., 2:3, 2:3]
    if mode == "fro":
        n = torch.sqrt(torch.sum(h * h, dim=(-2, -1), keepdim=True))
        s = torch.sign(h[..., 2:3, 2:3])
        s = torch.where(s == 0, torch.ones_like(s), s)
        return h / (n * s)
    raise ValueError(f"unknown mode {mode!r}")


def homography_from_pose(
    k1: Tensor, k2: Tensor, r: Tensor, t: Tensor, n: Tensor, d: Tensor
) -> Tensor:
    """Exact plane-induced homography between two cameras.

    For a world plane ``n . X = d`` seen by camera 1 (identity pose, intrinsics
    ``k1``) and camera 2 at ``(r, t)`` (intrinsics ``k2``):

        H = k2 (r + t n^T / d) k1^{-1}

    Args:
      k1, k2: (..., 3, 3) intrinsics.  r: (..., 3, 3).  t: (..., 3).
      n: (..., 3) unit plane normal (camera-1 frame).  d: (...,) plane depth.

    Returns:
      (..., 3, 3) homography mapping camera-1 pixels to camera-2 pixels.
    """
    outer = t[..., :, None] * n[..., None, :] / d[..., None, None]
    core = r + outer
    # inv_ex: no singularity check, so no host sync on a CUDA tensor.
    return k2 @ core @ torch.linalg.inv_ex(k1).inverse
