"""Normalized patch descriptors (batched, fixed shape).

Port of ``sks_tpu/features/descriptors.py`` with the gather sampler only.
The JAX package also has a one-hot matmul sampler for the TPU, where
irregular gathers serialize, and picks it there by default; the port leaves
it out (ROADMAP.md), so ``sampler='matmul'`` raises and 'auto' gathers.

Two tiers:

* :func:`patch_descriptors` — axis-aligned fixed-scale patches.
* :func:`oriented_patch_descriptors` — rotation-equivariant sampling: each
  keypoint gets an orientation (the ORB intensity centroid,
  :func:`keypoint_orientations`, or smoothed gradients,
  :func:`keypoint_orientations_gradient`) and an optional scale, and the
  sampling grid is rotated and scaled before the gather.

Images are (..., H, W) and keypoints (..., K, 2) [x, y], with the same
leading dims: a batch of frames is described at once.
"""

from __future__ import annotations

import torch
from torch import Tensor

__all__ = [
    "patch_descriptors",
    "oriented_patch_descriptors",
    "keypoint_orientations",
    "keypoint_orientations_gradient",
    "bilinear_sample",
]


def bilinear_sample(img: Tensor, xy: Tensor) -> Tensor:
    """Bilinear sample (..., H, W) images at (..., *S, 2) [x, y] locations.

    The leading dims of ``img`` are batch dims that ``xy`` starts with (none
    for one image); each image is sampled at its own points.  Returns
    ``xy.shape[:-1]``.
    """
    h, w = img.shape[-2:]
    flat = img.reshape(-1, h * w)
    pts = xy.reshape(flat.shape[0], -1, 2)
    x = torch.clamp(pts[..., 0], 0.0, w - 1.001)
    y = torch.clamp(pts[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.long()
    y0 = y0.long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)

    def at(yy, xx):
        return torch.gather(flat, -1, yy * w + xx)

    v00 = at(y0, x0)
    v01 = at(y0, x1)
    v10 = at(y1, x0)
    v11 = at(y1, x1)
    out = (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )
    return out.reshape(xy.shape[:-1])


def _bilinear_weights(coord: Tensor, size: int, dtype) -> Tensor:
    """One-hot bilinear weight rows: (N,) coords -> (N, size) with ``1-f`` at
    ``floor(c)`` and ``f`` at ``floor(c)+1`` (clamped like
    :func:`bilinear_sample`)."""
    c = torch.clamp(coord, 0.0, size - 1.001)
    c0 = torch.floor(c)
    f = (c - c0).to(dtype)
    c0 = c0.long()
    idx = torch.arange(size, device=coord.device)[None, :]
    return ((idx == c0[:, None]).to(dtype) * (1.0 - f[:, None])
            + (idx == c0[:, None] + 1).to(dtype) * f[:, None])


def _sample(img: Tensor, xy: Tensor, sampler: str) -> Tensor:
    """Bilinear sampling by gathers ('gather', or 'auto')."""
    if sampler == "matmul":
        raise ValueError(
            "sampler='matmul' (the one-hot matmul sampler of the TPU) is not "
            "part of the port; use 'gather' or 'auto'")
    if sampler not in ("gather", "auto"):
        raise ValueError(f"unknown sampler {sampler!r}")
    return bilinear_sample(img, xy)


def _grid(patch: int, stride: float, like: Tensor) -> Tensor:
    """(patch^2, 2) [x, y] offsets of a centered sampling grid."""
    half = (patch - 1) / 2.0
    g = (torch.arange(patch, dtype=like.dtype, device=like.device)
         - half) * stride
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    return torch.stack([gx, gy], dim=-1).reshape(-1, 2)


def _normalize(vals: Tensor) -> Tensor:
    """Zero-mean, unit-L2 rows."""
    vals = vals - vals.mean(dim=-1, keepdim=True)
    nrm = torch.sqrt(torch.sum(vals * vals, dim=-1, keepdim=True) + 1e-8)
    return vals / nrm


def patch_descriptors(img: Tensor, xy: Tensor, patch: int = 8,
                      stride: int = 2, sampler: str = "auto") -> Tensor:
    """Mean/variance-normalized intensity-patch descriptors.

    Args:
      img: (..., H, W) grayscale.
      xy: (..., K, 2) keypoint centers [x, y].
      patch: descriptor grid side (patch x patch samples).
      stride: pixel spacing of the sampling grid.

    Returns:
      (..., K, patch*patch) L2-normalized descriptors.
    """
    pts = xy[..., :, None, :] + _grid(patch, stride, img)  # (..., K, P^2, 2)
    return _normalize(_sample(img, pts, sampler))


def keypoint_orientations(
    img: Tensor, xy: Tensor, scale: Tensor | None = None,
    radius: float = 7.0, samples: int = 15,
) -> Tensor:
    """Dominant orientation per keypoint by the intensity centroid (ORB).

    theta = atan2(m01, m10) with moments over a disc around the keypoint,
    intensity taken relative to the disc mean.

    Args:
      img: (..., H, W) grayscale.  xy: (..., K, 2) centers.
      scale: optional (..., K) per-keypoint scale multiplying the radius.
      radius: disc radius in pixels at scale 1.
      samples: grid side of the disc sampling.

    Returns:
      (..., K) angles in radians.
    """
    g = torch.linspace(-1.0, 1.0, samples, dtype=img.dtype, device=img.device)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    inside = (gx * gx + gy * gy) <= 1.0
    offs = torch.stack([gx, gy], dim=-1).reshape(-1, 2)  # (S^2, 2)
    w = inside.reshape(-1).to(img.dtype)
    r = radius if scale is None else radius * scale[..., :, None, None]
    pts = xy[..., :, None, :] + offs * r
    vals = bilinear_sample(img, pts)  # (..., K, S^2)
    mu = torch.sum(vals * w, dim=-1, keepdim=True) / torch.sum(w)
    vc = (vals - mu) * w
    m10 = torch.sum(vc * offs[:, 0], dim=-1)
    m01 = torch.sum(vc * offs[:, 1], dim=-1)
    return torch.atan2(m01, m10)


def keypoint_orientations_gradient(
    img: Tensor, xy: Tensor, scale: Tensor | None = None, sigma: float = 4.0,
) -> Tensor:
    """Dominant orientation from Gaussian-smoothed image gradients.

    ``theta = atan2(Gy_s, Gx_s)`` with ``G_s`` the sigma-smoothed Sobel
    gradients, sampled once per keypoint.  ``scale`` is accepted for the
    JAX package's signature; as there, the fixed-sigma maps serve every
    scale.

    Returns:
      (..., K) angles in radians.
    """
    from sks_tpu_torch.features.harris import _gauss_taps, _sep_filter

    sob_s = (0.125, 0.25, 0.125)
    sob_d = (-1.0, 0.0, 1.0)
    gx = _sep_filter(img, sob_s, sob_d)
    gy = _sep_filter(img, sob_d, sob_s)
    g = _gauss_taps(sigma, int(2 * sigma + 0.5))
    gxs = _sep_filter(gx, g, g)
    gys = _sep_filter(gy, g, g)
    vx = bilinear_sample(gxs, xy)
    vy = bilinear_sample(gys, xy)
    return torch.atan2(vy, vx)


def oriented_patch_descriptors(
    img: Tensor,
    xy: Tensor,
    theta: Tensor | None = None,
    scale: Tensor | None = None,
    patch: int = 8,
    stride: float = 2.0,
    orientation: str = "centroid",
    sampler: str = "auto",
):
    """Rotation/scale-equivariant normalized patch descriptors.

    The sampling grid is rotated by each keypoint's orientation (computed
    when not supplied: 'centroid' or 'gradient') and scaled by its detection
    scale.

    Args:
      img: (..., H, W) grayscale.
      xy: (..., K, 2) centers.  theta: optional (..., K) orientations.
      scale: optional (..., K) per-keypoint scales (1.0 = base octave).
      patch: descriptor grid side.  stride: base grid spacing in pixels.
      sampler: 'gather' or 'auto' (both gather; 'matmul' raises).

    Returns:
      ((..., K, patch*patch) L2-normalized descriptors, (..., K) theta used).
    """
    if theta is None:
        if orientation == "gradient":
            theta = keypoint_orientations_gradient(img, xy, scale)
        else:
            theta = keypoint_orientations(img, xy, scale)
    offs = _grid(patch, stride, img)  # (P^2, 2)
    c, s = torch.cos(theta), torch.sin(theta)
    # Per-keypoint rotation of the grid: [c -s; s c] @ off.
    ox = c[..., None] * offs[:, 0] - s[..., None] * offs[:, 1]
    oy = s[..., None] * offs[:, 0] + c[..., None] * offs[:, 1]
    rot = torch.stack([ox, oy], dim=-1)  # (..., K, P^2, 2)
    if scale is not None:
        rot = rot * scale[..., None, None]
    pts = xy[..., :, None, :] + rot
    return _normalize(_sample(img, pts, sampler)), theta
