"""Fit requests: N matches on an image pair under a random plane homography.

The homography moves each of the image's four corners by a uniform draw in
``[-shift, shift]`` pixels on each axis (the common way to draw a random
plane homography of bounded range: it keeps the warped image overlapping the
original, as a stitching or tracking pair does).  Of the N matches, exactly
``round(N * outlier_share)`` are outliers, at random positions among the N:
source and target uniform over the image.  The others are inliers: the
source uniform over the image, the target its image under H plus Gaussian
noise of ``noise_px`` on each axis.  Every request of every seed has the same
sizes and the same outlier count; only the draws differ.

Everything is drawn in float64 on the generator's device, in a few large
calls, and returned in the configuration's dtype.
"""

from __future__ import annotations

import torch
from torch import Tensor


def corners(width: float, height: float, dtype=torch.float64,
            device=None) -> Tensor:
    return torch.tensor([[0.0, 0.0], [width, 0.0], [width, height],
                         [0.0, height]], dtype=dtype, device=device)


def homography_4pt(src: Tensor, tar: Tensor) -> Tensor:
    """The exact homographies (..., 3, 3), H[2, 2] = 1, taking the four
    points ``src`` (..., 4, 2) onto ``tar`` (..., 4, 2): the 8 x 8 DLT."""
    x, y = src[..., 0], src[..., 1]
    u, v = tar[..., 0], tar[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    rows_u = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    rows_v = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    a = torch.cat([rows_u, rows_v], dim=-2)
    b = torch.cat([u, v], dim=-1)
    h = torch.linalg.solve(a, b)
    return torch.cat([h, torch.ones_like(h[..., :1])], -1).reshape(
        *h.shape[:-1], 3, 3)


def apply_h(h: Tensor, pts: Tensor) -> Tensor:
    """(..., 3, 3) applied to (..., N, 2)."""
    hb = h[..., None, :, :]
    x, y = pts[..., 0], pts[..., 1]
    w = hb[..., 2, 0] * x + hb[..., 2, 1] * y + hb[..., 2, 2]
    return torch.stack([(hb[..., 0, 0] * x + hb[..., 0, 1] * y
                         + hb[..., 0, 2]) / w,
                        (hb[..., 1, 0] * x + hb[..., 1, 1] * y
                         + hb[..., 1, 2]) / w], dim=-1)


def fit_requests(generator: torch.Generator, count: int, config: dict,
                 outlier_share: float):
    """``count`` requests: (src (count, N, 2), tar (count, N, 2), H_true
    (count, 3, 3), is_outlier (count, N) bool), on the generator's device.

    ``config`` gives ``n_points``, ``image_wh``, ``corner_shift_px``,
    ``inlier_noise_px`` and ``dtype``.
    """
    dev = generator.device
    f64 = torch.float64
    n = int(config["n_points"])
    width, height = (float(v) for v in config["image_wh"])
    shift = float(config["corner_shift_px"])
    size = torch.tensor([width, height], dtype=f64, device=dev)

    def uniform(shape):
        return torch.rand(shape, generator=generator, dtype=f64, device=dev)

    quad = corners(width, height, device=dev)
    moved = quad + shift * (2.0 * uniform((count, 4, 2)) - 1.0)
    h_true = homography_4pt(quad.expand(count, 4, 2), moved)
    src = uniform((count, n, 2)) * size
    tar_in = apply_h(h_true, src) + float(config["inlier_noise_px"]) * (
        torch.randn((count, n, 2), generator=generator, dtype=f64,
                    device=dev))
    tar_out = uniform((count, n, 2)) * size
    rank = torch.argsort(uniform((count, n)), dim=-1)
    is_out = rank < round(n * outlier_share)
    tar = torch.where(is_out[..., None], tar_out, tar_in)
    dtype = getattr(torch, config["dtype"])
    return src.to(dtype), tar.to(dtype), h_true, is_out
