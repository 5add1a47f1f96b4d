"""Harris corner detection as separable filters (batched, static top-K).

Port of ``sks_tpu/features/harris.py``.  :func:`detect_corners` is
single-scale; :func:`detect_corners_pyramid` runs the same detector over an
average-pooled octave pyramid and returns scale-annotated keypoints for the
oriented descriptors (``descriptors.oriented_patch_descriptors``).  Every
function takes images of shape (..., H, W): leading dims are a batch of
frames, detected at once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor

__all__ = ["harris_response", "detect_corners", "detect_corners_pyramid",
           "subpixel_refine"]


def _filter1d(img: Tensor, taps, axis: int) -> Tensor:
    """'Same' 1-D correlation along ``axis`` (-2 or -1) by zero-padded
    shifted sums: the JAX package's form, a left fold over the nonzero
    taps (static Python floats)."""
    r = len(taps) // 2
    x = F.pad(img, (r, r) if axis == -1 else (0, 0, r, r))
    n = img.shape[axis]
    out = None
    for i, t in enumerate(taps):
        if t == 0.0:
            continue
        term = t * x.narrow(axis, i, n)
        out = term if out is None else out + term
    return out


def _sep_filter(img: Tensor, taps_h, taps_w) -> Tensor:
    """Separable 2-D filter: 1-D taps along H then W (zero-padded 'same')."""
    return _filter1d(_filter1d(img, taps_h, -2), taps_w, -1)


def _gauss_taps(sigma: float, radius: int):
    g = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-radius, radius + 1)]
    s = sum(g)
    return [v / s for v in g]


def harris_response(img: Tensor, k: float = 0.04, sigma: float = 1.5) -> Tensor:
    """Harris corner response of (..., H, W) grayscale images.

    Sobel = [1,2,1]^T (x) [-1,0,1] / 8; the structure tensor is smoothed with
    a separable Gaussian (radius 3).
    """
    ix = _sep_filter(img, (0.125, 0.25, 0.125), (-1.0, 0.0, 1.0))
    iy = _sep_filter(img, (-1.0, 0.0, 1.0), (0.125, 0.25, 0.125))
    g = _gauss_taps(sigma, 3)
    sxx = _sep_filter(ix * ix, g, g)
    syy = _sep_filter(iy * iy, g, g)
    sxy = _sep_filter(ix * iy, g, g)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def subpixel_refine(resp: Tensor, yy: Tensor, xx: Tensor
                    ) -> tuple[Tensor, Tensor]:
    """Sub-pixel corner localization by a 3x3 quadratic fit of the response.

    Fits ``r(d) = r0 + g.d + d'Hd/2`` to the 3x3 neighborhood of each integer
    maximum (central differences) and moves the corner to ``d* = -H^{-1} g``
    when the fit is a genuine maximum (``det H > 0``, ``tr H < 0``) that
    lands within 0.75 px per axis (clamped to +-0.5); otherwise the integer
    location is kept.

    Args:
      resp: (..., H, W) Harris response.
      yy/xx: (..., K) integer corner coordinates.

    Returns:
      (yf, xf): (..., K) refined coordinates.
    """
    h, w = resp.shape[-2:]
    # Clamp so the 3x3 stencil is always in bounds (padded slots may carry
    # any index; real corners are >= border >= 1 from the edge).
    yc = torch.clamp(yy, 1, h - 2)
    xc = torch.clamp(xx, 1, w - 2)
    flat = resp.flatten(-2)

    def at(dy, dx):
        return torch.gather(flat, -1, (yc + dy) * w + (xc + dx))

    r0 = at(0, 0)
    gx = 0.5 * (at(0, 1) - at(0, -1))
    gy = 0.5 * (at(1, 0) - at(-1, 0))
    hxx = at(0, 1) - 2.0 * r0 + at(0, -1)
    hyy = at(1, 0) - 2.0 * r0 + at(-1, 0)
    hxy = 0.25 * (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1))
    det = hxx * hyy - hxy * hxy
    # d* = -H^{-1} g (2x2 adjugate solve).
    safe = torch.where(det.abs() > 1e-20, det, torch.ones_like(det))
    ox = -(hyy * gx - hxy * gy) / safe
    oy = -(hxx * gy - hxy * gx) / safe
    good = ((det > 0) & (hxx + hyy < 0) & (ox.abs() <= 0.75)
            & (oy.abs() <= 0.75))
    zero = torch.zeros_like(ox)
    ox = torch.where(good, torch.clamp(ox, -0.5, 0.5), zero)
    oy = torch.where(good, torch.clamp(oy, -0.5, 0.5), zero)
    return yc.to(resp.dtype) + oy, xc.to(resp.dtype) + ox


def _top_k(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The k largest entries of the last dim and their indices, the lower
    index first among ties, as ``jax.lax.top_k`` orders them (a stable
    descending sort: deterministic on every device)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def detect_corners(
    img: Tensor,
    num_corners: int = 512,
    nms_radius: int = 4,
    border: int = 16,
    k: float = 0.04,
    subpixel: bool = True,
):
    """Top-K Harris corners with non-max suppression (fixed output shape).

    Args:
      img: (..., H, W) grayscale.
      num_corners: static K; weaker slots are padded and masked out.
      subpixel: refine each maximum with :func:`subpixel_refine` (default).

    Returns:
      (xy (..., K, 2) [x, y], score (..., K), valid (..., K) bool).
    """
    h, w = img.shape[-2:]
    resp = harris_response(img, k)
    # NMS: keep local maxima over a (2r+1)^2 window ('SAME', -inf padding).
    win = 2 * nms_radius + 1
    pooled = F.max_pool2d(resp.reshape(-1, 1, h, w), win, stride=1,
                          padding=nms_radius).reshape(resp.shape)
    is_max = resp >= pooled
    # Suppress borders (descriptor support must fit).
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inside = ((ys >= border) & (ys < h - border)
              & (xs >= border) & (xs < w - border))
    resp_sup = torch.where(is_max & inside, resp,
                           torch.full_like(resp, -torch.inf))

    score, idx = _top_k(resp_sup.flatten(-2), num_corners)
    yi = idx // w
    xi = idx % w
    if subpixel:
        yy, xx = subpixel_refine(resp, yi, xi)
    else:
        yy, xx = yi.to(img.dtype), xi.to(img.dtype)
    valid = torch.isfinite(score) & (score > 0)
    return torch.stack([xx, yy], dim=-1), score, valid


def _downsample2(img: Tensor) -> Tensor:
    """2x average-pool (truncates odd edges)."""
    h, w = img.shape[-2:]
    h2, w2 = h // 2, w // 2
    x = img[..., : h2 * 2, : w2 * 2]
    x = x.reshape(*x.shape[:-2], h2, 2, w2, 2)
    return x.mean(dim=(-3, -1))


def detect_corners_pyramid(
    img: Tensor,
    num_corners: int = 512,
    num_octaves: int = 3,
    nms_radius: int = 4,
    border: int = 16,
    k: float = 0.04,
    subpixel: bool = True,
):
    """Top-K Harris corners over an octave pyramid (fixed output shape).

    Per octave the image is 2x average-pooled and the single-scale detector
    runs unchanged; responses are compared globally and the winners carry
    their octave's scale.  With ``subpixel`` every octave's maxima are refined
    in the pooled grid before upscaling.

    Returns:
      (xy (..., K, 2) full-resolution [x, y], score (..., K), valid (..., K)
       bool, scale (..., K) — 2**octave).
    """
    per = num_corners  # detect K per octave, then global top-K
    xys, scores, valids, scales = [], [], [], []
    level = img
    for o in range(num_octaves):
        xy, sc, va = detect_corners(level, per, nms_radius, border, k,
                                    subpixel)
        f = float(2 ** o)
        xys.append(xy * f + (f - 1) / 2.0)  # pooled-pixel center offset
        scores.append(torch.where(va, sc, torch.full_like(sc, -torch.inf)))
        valids.append(va)
        scales.append(torch.full_like(sc, f))
        if o + 1 < num_octaves:
            level = _downsample2(level)
    score, idx = _top_k(torch.cat(scores, dim=-1), num_corners)
    xy = torch.gather(torch.cat(xys, dim=-2), -2,
                      idx[..., None].expand(*idx.shape, 2))
    valid = torch.gather(torch.cat(valids, dim=-1), -1, idx) \
        & torch.isfinite(score)
    scale = torch.gather(torch.cat(scales, dim=-1), -1, idx)
    return xy, score, valid, scale
