"""ACA — Affine-Core-Affine 4-point homography (batched, division-free up to scale).

Port of ``sks_tpu/ops/aca.py``; the derivation lives in that module's
docstring.  :func:`aca_core` is written once: it is the eager op, the plain
version of the CUDA kernel ``aca_solve_soa`` (``sks_tpu_torch.kernels.aca_cuda``)
and the specification of that kernel's body (``csrc/aca.cu`` follows it line by
line, in the same operation order).

Degeneracies (exposed as masks, never branched on):
  * ``f1 == 0`` / ``f2 == 0``  — three collinear anchors in either plane;
  * ``H[2,2] == 0``            — the exact homography is affine (the
    up-to-scale result is still valid).
"""

from __future__ import annotations

import torch
from torch import Tensor

__all__ = ["aca_core", "aca_h", "aca", "aca_valid_mask"]


def aca_core(
    m1x, m1y, n1x, n1y, p1x, p1y, q1x, q1y,
    m2x, m2y, n2x, n2y, p2x, p2y, q2x, q2y,
):
    """Straight-line division-free ACA on scalar-like components.

    Works on any broadcastable tensor components.  Returns the 9 homography
    entries row-major, up to scale.
    """
    # Source affine frame: axes E1 = N1-M1, F1 = P1-M1; adj(A1) @ (Q1-M1).
    e1x = n1x - m1x
    e1y = n1y - m1y
    f1x = p1x - m1x
    f1y = p1y - m1y
    g1x = q1x - m1x
    g1y = q1y - m1y
    f1 = e1x * f1y - e1y * f1x
    alpha = f1y * g1x - f1x * g1y
    beta = e1x * g1y - e1y * g1x

    # Target affine frame, symmetric.
    e2x = n2x - m2x
    e2y = n2y - m2y
    f2x = p2x - m2x
    f2y = p2y - m2y
    g2x = q2x - m2x
    g2y = q2y - m2y
    f2 = e2x * f2y - e2y * f2x
    gamma = f2y * g2x - f2x * g2y
    delta = e2x * g2y - e2y * g2x

    # 2-DOF core, division-free.
    c = beta * (gamma * (f1 - beta) - alpha * (f2 - delta))
    d = alpha * (delta * (f1 - alpha) - beta * (f2 - gamma))
    e = alpha * beta * (f2 - gamma - delta)
    ce = c + e
    de = d + e

    # H_mid = H_A2^{-1} @ H_C with H_A2^{-1} = [[E2 F2 M2],[0 0 1]].
    t00 = e2x * ce + m2x * c
    t01 = f2x * de + m2x * d
    t02 = m2x * e
    t10 = e2y * ce + m2y * c
    t11 = f2y * de + m2y * d
    t12 = m2y * e

    # H = H_mid @ [[adj(A1), -adj(A1) m1],[0,0,f1]]  (up to scale).
    a00, a01 = f1y, -f1x
    a10, a11 = -e1y, e1x
    a02 = -(a00 * m1x + a01 * m1y)
    a12 = -(a10 * m1x + a11 * m1y)

    h00 = t00 * a00 + t01 * a10
    h01 = t00 * a01 + t01 * a11
    h02 = t00 * a02 + t01 * a12 + t02 * f1
    h10 = t10 * a00 + t11 * a10
    h11 = t10 * a01 + t11 * a11
    h12 = t10 * a02 + t11 * a12 + t12 * f1
    h20 = c * a00 + d * a10
    h21 = c * a01 + d * a11
    h22 = c * a02 + d * a12 + e * f1
    return h00, h01, h02, h10, h11, h12, h20, h21, h22


def _components(pts: Tensor):
    p = pts.reshape(*pts.shape[:-2], 8)
    return tuple(p[..., i] for i in range(8))


def aca_h(src: Tensor, tar: Tensor) -> Tensor:
    """Up-to-scale ACA homography, division-free.

    Args:
      src: (..., 4, 2) source points [M1, N1, P1, Q1].
      tar: (..., 4, 2) target points [M2, N2, P2, Q2].

    Returns:
      (..., 3, 3) homography with ``H @ [src_i; 1] ∝ [tar_i; 1]``, *not*
      normalized (H[2,2] is arbitrary).  Leading batch dims broadcast.
    """
    h = aca_core(*_components(src), *_components(tar))
    return torch.stack(h, dim=-1).reshape(*h[0].shape, 3, 3)


def aca(src: Tensor, tar: Tensor) -> Tensor:
    """ACA homography normalized to ``H[2,2] == 1`` (non-finite where affine)."""
    h = aca_h(src, tar)
    return h / h[..., 2:3, 2:3]


def aca_valid_mask(src: Tensor, tar: Tensor, eps: float | None = None) -> Tensor:
    """True where the 4-point configuration is non-degenerate for ACA.

    Degenerate iff the first three points of either plane are (numerically)
    collinear: |det A| <= eps * scale^2, with scale the frame magnitude.
    ``eps`` defaults to 32 machine epsilons of the input dtype.
    """
    if eps is None:
        eps = 32 * torch.finfo(src.dtype).eps

    def det_and_scale(pts):
        m = pts[..., 0, :]
        e = pts[..., 1, :] - m
        f = pts[..., 2, :] - m
        det = e[..., 0] * f[..., 1] - e[..., 1] * f[..., 0]
        s = torch.maximum(e.abs().amax(-1), f.abs().amax(-1))
        return det, s

    f1, s1 = det_and_scale(src)
    f2, s2 = det_and_scale(tar)
    return (f1.abs() > eps * s1 * s1) & (f2.abs() > eps * s2 * s2)
