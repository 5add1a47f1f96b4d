"""SKS — Similarity-Kernel-Similarity 4-point homography (batched).

Port of ``sks_tpu/ops/sks.py``; the derivation (similarities taking the
anchors M, N to (-1, 0) and (1, 0), the 4-DOF kernel between them, and its
symmetric 2x2 solve) lives in that module's docstring.  :func:`sks_core` is
written once: it is the eager op, the plain version of the CUDA kernel
``sks_solve_soa`` (``sks_tpu_torch.kernels.sks_cuda``) and the specification
of that kernel's body (``csrc/sks.cu`` follows it line by line, in the same
operation order: ``a * (1/d)`` and ``a / d`` are different roundings, and
SKS uses both).

Degeneracies (masked by :func:`sks_valid_mask`, divided through blindly by
the core, as in the reference):
  * ``M == N`` on either plane (``|w| = 0``);
  * ``P`` or ``Q`` on the line ``MN`` of either plane;
  * the 2x2 kernel determinant ``(ps-rq)^2 - (s-q)^2 = 0``.
"""

from __future__ import annotations

import torch
from torch import Tensor

__all__ = ["sks_core", "sks_h", "sks", "sks_valid_mask"]


def sks_core(
    m1x, m1y, n1x, n1y, p1x, p1y, q1x, q1y,
    m2x, m2y, n2x, n2y, p2x, p2y, q2x, q2y,
):
    """Straight-line SKS on scalar-like components.

    Returns the 9 homography entries row-major, up to scale; 5 reciprocals
    or divisions per hypothesis.
    """
    # Similarity-canonical coordinates of P, Q on each plane.
    w1x = 0.5 * (n1x - m1x)
    w1y = 0.5 * (n1y - m1y)
    o1x = 0.5 * (n1x + m1x)
    o1y = 0.5 * (n1y + m1y)
    inv1 = 1.0 / (w1x * w1x + w1y * w1y)
    p1dx = p1x - o1x
    p1dy = p1y - o1y
    q1dx = q1x - o1x
    q1dy = q1y - o1y
    p = (w1x * p1dx + w1y * p1dy) * inv1
    q = (-w1y * p1dx + w1x * p1dy) * inv1
    r = (w1x * q1dx + w1y * q1dy) * inv1
    s = (-w1y * q1dx + w1x * q1dy) * inv1

    w2x = 0.5 * (n2x - m2x)
    w2y = 0.5 * (n2y - m2y)
    o2x = 0.5 * (n2x + m2x)
    o2y = 0.5 * (n2y + m2y)
    inv2 = 1.0 / (w2x * w2x + w2y * w2y)
    p2dx = p2x - o2x
    p2dy = p2y - o2y
    q2dx = q2x - o2x
    q2dy = q2y - o2y
    p2 = (w2x * p2dx + w2y * p2dy) * inv2
    q2 = (-w2y * p2dx + w2x * p2dy) * inv2
    r2 = (w2x * q2dx + w2y * q2dy) * inv2
    s2 = (-w2y * q2dx + w2x * q2dy) * inv2

    # 4-DOF kernel fixing (+-1, 0): symmetric 2x2 solve.
    k1 = q / q2
    k3 = p2 * k1
    k2 = s / s2
    k4 = r2 * k2
    g = p * s - r * q
    h_ = s - q
    inv_det = 1.0 / (g * g - h_ * h_)
    rhs_a = k3 * s - k4 * q
    rhs_u = k1 * s - k2 * q
    a = (g * rhs_a - h_ * rhs_u) * inv_det
    u = (g * rhs_u - h_ * rhs_a) * inv_det
    inv_q = 1.0 / q
    v = (k1 - a - u * p) * inv_q
    b = (k3 - a * p - u) * inv_q

    # H_L = H_S2^{-1} @ H_K.
    l00 = w2x * a + o2x * u
    l01 = w2x * b - w2y + o2x * v
    l02 = w2x * u + o2x * a
    l10 = w2y * a + o2y * u
    l11 = w2y * b + w2x + o2y * v
    l12 = w2y * u + o2y * a

    # H = H_L @ H_S1h (up to scale).
    t0 = -(w1x * o1x + w1y * o1y)
    t1 = w1y * o1x - w1x * o1y
    wsq1 = w1x * w1x + w1y * w1y

    h00 = l00 * w1x - l01 * w1y
    h01 = l00 * w1y + l01 * w1x
    h02 = l00 * t0 + l01 * t1 + l02 * wsq1
    h10 = l10 * w1x - l11 * w1y
    h11 = l10 * w1y + l11 * w1x
    h12 = l10 * t0 + l11 * t1 + l12 * wsq1
    h20 = u * w1x - v * w1y
    h21 = u * w1y + v * w1x
    h22 = u * t0 + v * t1 + a * wsq1
    return h00, h01, h02, h10, h11, h12, h20, h21, h22


def _canon(pts: Tensor):
    """Similarity-canonical coordinates of P and Q given anchors M, N.

    pts: (..., 4, 2) ordered [M, N, P, Q].
    Returns (w, o, p, q) with w = (N-M)/2, o = (M+N)/2 and p, q the canonical
    (post-similarity) coordinates of P and Q, each (..., 2).
    """
    m, n = pts[..., 0, :], pts[..., 1, :]
    w = 0.5 * (n - m)
    o = 0.5 * (n + m)
    wsq = w[..., 0] * w[..., 0] + w[..., 1] * w[..., 1]
    inv = 1.0 / wsq

    def rot(x):
        d = x - o
        return torch.stack(
            [
                (w[..., 0] * d[..., 0] + w[..., 1] * d[..., 1]) * inv,
                (-w[..., 1] * d[..., 0] + w[..., 0] * d[..., 1]) * inv,
            ],
            dim=-1,
        )

    return w, o, rot(pts[..., 2, :]), rot(pts[..., 3, :])


def _components(pts: Tensor):
    p = pts.reshape(*pts.shape[:-2], 8)
    return tuple(p[..., i] for i in range(8))


def sks_h(src: Tensor, tar: Tensor) -> Tensor:
    """Up-to-scale SKS homography.

    Args:
      src: (..., 4, 2) source points [M1, N1, P1, Q1].
      tar: (..., 4, 2) target points [M2, N2, P2, Q2].

    Returns:
      (..., 3, 3) homography, unnormalized; batch dims broadcast.
    """
    h = sks_core(*_components(src), *_components(tar))
    return torch.stack(h, dim=-1).reshape(*h[0].shape, 3, 3)


def sks(src: Tensor, tar: Tensor) -> Tensor:
    """SKS homography normalized to ``H[2,2] == 1``."""
    h = sks_h(src, tar)
    return h / h[..., 2:3, 2:3]


def sks_valid_mask(src: Tensor, tar: Tensor, eps: float | None = None) -> Tensor:
    """True where the configuration avoids every SKS degeneracy (module doc).

    Canonical coordinates are scale-free, so thresholds compare against
    ``eps`` directly; defaults to 32 machine epsilons of the input dtype.
    """
    if eps is None:
        eps = 32 * torch.finfo(src.dtype).eps
    w1, _, p1, q1 = _canon(src)
    w2, _, p2, q2 = _canon(tar)
    wsq1 = (w1 * w1).sum(-1)
    wsq2 = (w2 * w2).sum(-1)
    ok = (wsq1 > eps) & (wsq2 > eps)
    for y in (p1[..., 1], q1[..., 1], p2[..., 1], q2[..., 1]):
        ok = ok & (torch.abs(y) > eps)
    p, q = p1[..., 0], p1[..., 1]
    r, s = q1[..., 0], q1[..., 1]
    g = p * s - r * q
    h = s - q
    ok = ok & (torch.abs(g * g - h * h) > eps)
    return ok
