"""NDLT — normalized Direct Linear Transform homography (batched, N >= 4).

Port of the N-point path of ``sks_tpu/ops/ndlt.py``: Hartley-normalize both
point sets, accumulate the 9x9 normal matrix of the stacked DLT constraints,
take the smallest eigenvector with the fixed-sweep Jacobi solver, denormalize.
Optional per-point weights make padded point sets and IRLS reweighting work
without data-dependent shapes.  The straight-line minimal-set form
``ndlt_core`` comes with the port of its kernel (ROADMAP.md Queue B, K4).
"""

from __future__ import annotations

import torch
from torch import Tensor

from sks_tpu_torch.ops.linalg import jacobi_eigh, mm_highest as _mm

__all__ = ["ndlt", "ndlt_h"]


def _hartley(pts: Tensor, w: Tensor):
    """Anisotropic Hartley normalization (per-axis mean absolute deviation).

    Returns (normalized points, (cx, cy, sx, sy)) with x' = sx (x - cx) etc.
    ``pts`` (..., N, 2) and ``w`` (..., N) broadcast over leading dims.
    """
    wsum = torch.sum(w, dim=-1, keepdim=True)
    c = torch.sum(pts * w[..., None], dim=-2, keepdim=True) / wsum[..., None]
    d = pts - c
    dev = torch.sum(torch.abs(d) * w[..., None], dim=-2) / wsum
    s = 1.0 / torch.clamp(dev, min=torch.finfo(pts.dtype).tiny)
    return d * s[..., None, :], (c[..., 0, 0], c[..., 0, 1], s[..., 0], s[..., 1])


def _t_matrix(cx, cy, sx, sy):
    z = torch.zeros_like(cx)
    o = torch.ones_like(cx)
    return torch.stack(
        [
            torch.stack([sx, z, -sx * cx], dim=-1),
            torch.stack([z, sy, -sy * cy], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )


def _t_inv_matrix(cx, cy, sx, sy):
    z = torch.zeros_like(cx)
    o = torch.ones_like(cx)
    return torch.stack(
        [
            torch.stack([1.0 / sx, z, cx], dim=-1),
            torch.stack([z, 1.0 / sy, cy], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )


def ndlt_h(
    src: Tensor,
    tar: Tensor,
    weights: Tensor | None = None,
    eig_method: str = "jacobi",
) -> Tensor:
    """Up-to-scale NDLT homography.

    Args:
      src, tar: (..., N, 2) correspondences, N >= 4.
      weights: optional (..., N) nonnegative weights; zero drops a point.
        Leading dims of ``weights`` broadcast against the points, so one point
        set refits under a batch of weight sets.
      eig_method: 'jacobi' (branch-free fixed sweeps).

    Returns:
      (..., 3, 3) homography, unnormalized.
    """
    if eig_method != "jacobi":
        raise NotImplementedError(
            f"eig_method={eig_method!r} is not ported yet; the closed-form and "
            "inverse-iteration eigensolvers come with ndlt_core and K4 "
            "(ROADMAP.md Queue B)"
        )
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    sn, (cx1, cy1, sx1, sy1) = _hartley(src, weights)
    tn, (cx2, cy2, sx2, sy2) = _hartley(tar, weights)

    x, y = sn[..., 0], sn[..., 1]
    xp, yp = tn[..., 0], tn[..., 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    # Two constraint rows per point: the classic DLT stacking.
    rows_x = torch.stack(
        [x, y, one, zero, zero, zero, -xp * x, -xp * y, -xp], dim=-1
    )
    rows_y = torch.stack(
        [zero, zero, zero, x, y, one, -yp * x, -yp * y, -yp], dim=-1
    )
    a = torch.cat([rows_x, rows_y], dim=-2)  # (..., 2N, 9)
    w2 = torch.cat([weights, weights], dim=-1).expand(a.shape[:-1])
    ltl = torch.einsum("...np,...n,...nq->...pq", a, w2, a)

    _, v = jacobi_eigh(ltl)
    h = v[..., :, 0]
    hm = h.reshape(*h.shape[:-1], 3, 3)

    # Denormalize: H = T2^{-1} @ Hn @ T1 with T = [[sx,0,-sx cx],[0,sy,-sy cy],[0,0,1]].
    t1 = _t_matrix(cx1, cy1, sx1, sy1)
    t2inv = _t_inv_matrix(cx2, cy2, sx2, sy2)
    return _mm(_mm(t2inv, hm), t1)


def ndlt(
    src: Tensor,
    tar: Tensor,
    weights: Tensor | None = None,
    eig_method: str = "jacobi",
) -> Tensor:
    """NDLT homography normalized to ``H[2,2] == 1``."""
    h = ndlt_h(src, tar, weights, eig_method)
    return h / h[..., 2:3, 2:3]
