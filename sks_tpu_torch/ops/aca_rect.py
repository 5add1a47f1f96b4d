"""ACA-rect — rectangle-to-quadrilateral homography (batched).

Port of ``sks_tpu/ops/aca_rect.py``: the specialization of ACA to a source
quad that is an axis-aligned rectangle, i.e. the "4-point offsets"
parameterization of deep homography networks.  With source corners
``M=(x0,y0), N=(x0+w,y0), P=(x0,y0+h), Q=(x0+w,y0+h)`` the division-free core
depends on the *target* frame only,

    c + e = -gamma,   d + e = -delta,   c = delta - f2,  d = gamma - f2,
    e = f2 - gamma - delta

with ``(gamma, delta) = adj(A2)(Q2-M2)`` and ``f2 = det A2``, and the
source-side factor is the up-to-scale axis rescaling
``[[h, 0, -x0 h], [0, w, -y0 w], [0, 0, w h]]`` (derivation in that module's
docstring).  Pure elementwise tensor arithmetic, in the JAX module's operation
order, so the two agree up to the multiply-add contraction of XLA.
"""

from __future__ import annotations

import torch
from torch import Tensor

__all__ = [
    "aca_rect_h",
    "aca_rect",
    "aca_square_h",
    "aca_square",
    "aca_qr_h",
    "aca_qr",
    "rect_corners",
]


def _stack3(rows) -> Tensor:
    """A 3x3 of broadcastable (...) tensors -> (..., 3, 3)."""
    flat = torch.broadcast_tensors(*(v for r in rows for v in r))
    return torch.stack(flat, dim=-1).reshape(*flat[0].shape, 3, 3)


def rect_corners(origin: Tensor, size: Tensor) -> Tensor:
    """Corners [M, N, P, Q] of the axis-aligned rect at ``origin`` with ``size``.

    origin: (..., 2) = (x0, y0); size: (..., 2) = (w, h).
    Returns (..., 4, 2) in the solver's [M, N, P, Q] order
    (M=top-left, N=top-right, P=bottom-left, Q=bottom-right in image coords).
    """
    x0, y0 = origin[..., 0], origin[..., 1]
    w, h = size[..., 0], size[..., 1]
    flat = torch.broadcast_tensors(x0, y0, x0 + w, y0, x0, y0 + h, x0 + w,
                                   y0 + h)
    return torch.stack(flat, dim=-1).reshape(*flat[0].shape, 4, 2)


def _target_mid(tar: Tensor):
    """Target-side factor ``H_mid = H_A2^{-1} @ H_C`` of the rect family.

    Shared by every source-rectangle specialization — the rect/square/QR
    variants differ only in the (trivial) source-side factor.  Returns the six
    upper entries of H_mid plus its last row ``(c, d, e)``.
    """
    m2 = tar[..., 0, :]
    e2 = tar[..., 1, :] - m2
    f2v = tar[..., 2, :] - m2
    g2 = tar[..., 3, :] - m2
    e2x, e2y = e2[..., 0], e2[..., 1]
    f2x, f2y = f2v[..., 0], f2v[..., 1]
    g2x, g2y = g2[..., 0], g2[..., 1]
    f2 = e2x * f2y - e2y * f2x
    gamma = f2y * g2x - f2x * g2y
    delta = -e2y * g2x + e2x * g2y

    c = delta - f2
    d = gamma - f2
    e = f2 - gamma - delta
    ce = -gamma
    de = -delta

    m2x, m2y = m2[..., 0], m2[..., 1]
    t00 = e2x * ce + m2x * c
    t01 = f2x * de + m2x * d
    t02 = m2x * e
    t10 = e2y * ce + m2y * c
    t11 = f2y * de + m2y * d
    t12 = m2y * e
    return t00, t01, t02, t10, t11, t12, c, d, e


def aca_rect_h(tar: Tensor, origin: Tensor, size: Tensor) -> Tensor:
    """Up-to-scale homography from an axis-aligned rect to a quadrilateral.

    Args:
      tar: (..., 4, 2) target points corresponding to :func:`rect_corners` order.
      origin: (..., 2) rect top-left (x0, y0).  Broadcasts against ``tar``.
      size: (..., 2) rect (width, height).

    Returns:
      (..., 3, 3) homography, unnormalized.
    """
    t00, t01, t02, t10, t11, t12, c, d, e = _target_mid(tar)

    # Right factor: [[h, 0, -x0 h], [0, w, -y0 w], [0, 0, w h]] (up to scale).
    x0, y0 = origin[..., 0], origin[..., 1]
    w, h = size[..., 0], size[..., 1]
    wh = w * h

    h00 = t00 * h
    h01 = t01 * w
    h02 = -(t00 * x0 * h + t01 * y0 * w) + t02 * wh
    h10 = t10 * h
    h11 = t11 * w
    h12 = -(t10 * x0 * h + t11 * y0 * w) + t12 * wh
    h20 = c * h
    h21 = d * w
    h22 = -(c * x0 * h + d * y0 * w) + e * wh
    return _stack3([[h00, h01, h02], [h10, h11, h12], [h20, h21, h22]])


def aca_rect(tar: Tensor, origin: Tensor, size: Tensor) -> Tensor:
    """Rect-to-quad homography normalized to ``H[2,2] == 1``.

    Deep-homography pipelines can skip this normalization entirely — use
    :func:`aca_rect_h` there.
    """
    hm = aca_rect_h(tar, origin, size)
    return hm / hm[..., 2:3, 2:3]


def aca_square_h(tar: Tensor, origin: Tensor, side: Tensor) -> Tensor:
    """Up-to-scale homography from an axis-aligned *square* to a quadrilateral.

    The square case of :func:`aca_rect_h`: with ``w == h == side`` the
    per-column width/height rescale collapses to one common factor that
    cancels up to scale, leaving only the translation terms.

    Args:
      tar: (..., 4, 2) target points in :func:`rect_corners` order.
      origin: (..., 2) square top-left (x0, y0).
      side: (...,) square side length.

    Returns:
      (..., 3, 3) homography, unnormalized.
    """
    t00, t01, t02, t10, t11, t12, c, d, e = _target_mid(tar)
    x0, y0 = origin[..., 0], origin[..., 1]
    s = side

    h02 = -(t00 * x0 + t01 * y0) + t02 * s
    h12 = -(t10 * x0 + t11 * y0) + t12 * s
    h22 = -(c * x0 + d * y0) + e * s
    return _stack3([[t00, t01, h02], [t10, t11, h12], [c, d, h22]])


def aca_square(tar: Tensor, origin: Tensor, side: Tensor) -> Tensor:
    """Square-to-quad homography normalized to ``H[2,2] == 1``."""
    hm = aca_square_h(tar, origin, side)
    return hm / hm[..., 2:3, 2:3]


def aca_qr_h(tar: Tensor) -> Tensor:
    """Up-to-scale homography from the *unit square at the origin* to a quad.

    The QR-code-detection case: source corners ``(0,0),(1,0),(0,1),(1,1)``
    make the whole source-side factor the identity, so the homography is the
    bare target factor ``H_A2^{-1} @ H_C`` — detector corner order maps
    straight through :func:`rect_corners` order [M, N, P, Q].

    Args:
      tar: (..., 4, 2) detected corner positions.

    Returns:
      (..., 3, 3) homography, unnormalized.
    """
    t00, t01, t02, t10, t11, t12, c, d, e = _target_mid(tar)
    return _stack3([[t00, t01, t02], [t10, t11, t12], [c, d, e]])


def aca_qr(tar: Tensor) -> Tensor:
    """Unit-square-to-quad homography normalized to ``H[2,2] == 1``."""
    hm = aca_qr_h(tar)
    return hm / hm[..., 2:3, 2:3]
