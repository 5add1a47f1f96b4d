"""Interpretable decomposition factors for SKS and ACA.

Port of ``sks_tpu/ops/factors.py``.  The homography is produced as an
explicit product of geometrically meaningful factors,

    H = H_S2^{-1} . H_K . H_S1          (SKS)
    H = H_A2^{-1} . H_C . H_A1          (ACA)

where the similarity/affine factors depend only on the anchor points of one
plane each, and the middle factor carries the projective DOFs (4 for the SKS
kernel, 2 for the ACA core): first-class batched ops, so users can inspect,
regularize or parameterize the factors directly (e.g. a network predicting
the 4 kernel parameters instead of 8 corner offsets).
:func:`sks_kernel_chain` expands ``H_K`` into the hyperbolic-similarity form
``H_E . H_T . H_G . H_E``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from sks_tpu_torch.ops.sks import _canon

__all__ = [
    "SKSFactors",
    "ACAFactors",
    "sks_factors",
    "aca_factors",
    "sks_kernel_chain",
]


def _mat3(rows, shape, dtype):
    """Stack a 3x3 of broadcastable (...) tensors into (..., 3, 3)."""
    flat = [v.to(dtype).broadcast_to(shape) for r in rows for v in r]
    return torch.stack(flat, dim=-1).reshape(*shape, 3, 3)


class SKSFactors(NamedTuple):
    """``H ∝ h_s2_inv @ h_k @ h_s1`` with 4-DOF kernel params ``(a, b, u, v)``.

    * ``h_s1`` — plane-1 similarity taking anchors ``M1 -> (-1,0)``,
      ``N1 -> (1,0)`` (exact, normalized last entry 1).
    * ``h_k`` — the kernel ``[[a, b, u], [0, 1, 0], [u, v, a]]`` fixing
      ``(±1, 0)``; its four entries are the projective DOFs.
    * ``h_s2_inv`` — inverse plane-2 similarity, ``(±1,0) -> M2, N2``.
    """

    h_s1: Tensor
    h_k: Tensor
    h_s2_inv: Tensor
    params: Tensor  # (..., 4) = (a, b, u, v)

    def reconstruct(self) -> Tensor:
        """H (normalized to H[2,2] = 1) from the factors."""
        h = self.h_s2_inv @ self.h_k @ self.h_s1
        return h / h[..., 2:3, 2:3]


class ACAFactors(NamedTuple):
    """``H ∝ h_a2_inv @ h_c @ h_a1`` with 2-DOF core params ``(c, d, e)`` up to scale.

    * ``h_a1`` — plane-1 affine frame inverse (homogeneous, scaled by
      ``det A1``: division-free), mapping ``M1,N1,P1`` to the canonical
      simplex ``(0,0),(1,0),(0,1)``.
    * ``h_c`` — the core ``[[c+e, 0, 0], [0, d+e, 0], [c, d, e]]`` fixing the
      simplex; ``(c : d : e)`` are the 2 projective DOFs in homogeneous form.
    * ``h_a2_inv`` — plane-2 affine frame, simplex ``-> M2, N2, P2``.
    """

    h_a1: Tensor
    h_c: Tensor
    h_a2_inv: Tensor
    params: Tensor  # (..., 3) = (c, d, e), up to common scale

    def reconstruct(self) -> Tensor:
        """H (normalized to H[2,2] = 1) from the factors."""
        h = self.h_a2_inv @ self.h_c @ self.h_a1
        return h / h[..., 2:3, 2:3]


def sks_factors(src: Tensor, tar: Tensor) -> SKSFactors:
    """Explicit SKS factors of the 4-point homography.

    Args:
      src, tar: (..., 4, 2) correspondences ordered [M, N, P, Q].

    Returns:
      :class:`SKSFactors`; ``reconstruct()`` equals
      :func:`sks_tpu_torch.ops.sks`.
    """
    dtype, device = src.dtype, src.device
    w1, o1, p1c, q1c = _canon(src)
    w2, o2, p2c, q2c = _canon(tar)
    shape = torch.broadcast_shapes(w1.shape[:-1], w2.shape[:-1])
    zero = torch.zeros(shape, dtype=dtype, device=device)
    one = torch.ones(shape, dtype=dtype, device=device)

    # H_S1 = (1/|w1|^2) [[Rw1, -Rw1 o1],[0, |w1|^2]]; normalize last entry 1.
    wsq1 = (w1 * w1).sum(-1)
    inv1 = 1.0 / wsq1
    w1x, w1y = w1[..., 0], w1[..., 1]
    t0 = -(w1x * o1[..., 0] + w1y * o1[..., 1]) * inv1
    t1 = (w1y * o1[..., 0] - w1x * o1[..., 1]) * inv1
    h_s1 = _mat3(
        [
            [w1x * inv1, w1y * inv1, t0],
            [-w1y * inv1, w1x * inv1, t1],
            [zero, zero, one],
        ],
        shape,
        dtype,
    )

    # H_S2^{-1} = [[Rw2^T, o2],[0, 1]] — exact, division-free.
    w2x, w2y = w2[..., 0], w2[..., 1]
    h_s2_inv = _mat3(
        [
            [w2x, -w2y, o2[..., 0]],
            [w2y, w2x, o2[..., 1]],
            [zero, zero, one],
        ],
        shape,
        dtype,
    )

    # Kernel parameters: same linear system as sks_core (see ops/sks.py).
    p, q = p1c[..., 0], p1c[..., 1]
    r, s = q1c[..., 0], q1c[..., 1]
    k1 = q / p2c[..., 1]
    k3 = p2c[..., 0] * k1
    k2 = s / q2c[..., 1]
    k4 = q2c[..., 0] * k2
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

    h_k = _mat3(
        [[a, b, u], [zero, one, zero], [u, v, a]],
        shape,
        dtype,
    )
    params = torch.stack(torch.broadcast_tensors(a, b, u, v), dim=-1)
    return SKSFactors(h_s1, h_k, h_s2_inv, params)


def aca_factors(src: Tensor, tar: Tensor) -> ACAFactors:
    """Explicit ACA factors of the 4-point homography.

    Args:
      src, tar: (..., 4, 2) correspondences ordered [M, N, P, Q].

    Returns:
      :class:`ACAFactors`; ``reconstruct()`` equals
      :func:`sks_tpu_torch.ops.aca`.  All three factors are division-free
      polynomials of the inputs (``h_a1`` is scaled by ``det A1``; ``h_c`` by
      a positive power of the frame determinants — scales cancel in the
      up-to-scale product).
    """
    dtype, device = src.dtype, src.device

    def frame(pts):
        m = pts[..., 0, :]
        e = pts[..., 1, :] - m
        f = pts[..., 2, :] - m
        g = pts[..., 3, :] - m
        det = e[..., 0] * f[..., 1] - e[..., 1] * f[..., 0]
        alpha = f[..., 1] * g[..., 0] - f[..., 0] * g[..., 1]
        beta = e[..., 0] * g[..., 1] - e[..., 1] * g[..., 0]
        return m, e, f, det, alpha, beta

    m1, e1, f1v, f1, alpha, beta = frame(src)
    m2, e2, f2v, f2, gamma, delta = frame(tar)
    shape = torch.broadcast_shapes(f1.shape, f2.shape)
    zero = torch.zeros(shape, dtype=dtype, device=device)
    one = torch.ones(shape, dtype=dtype, device=device)

    # H_A1 = [[adj(A1), -adj(A1) m1],[0, 0, det A1]] (division-free).
    a00, a01 = f1v[..., 1], -f1v[..., 0]
    a10, a11 = -e1[..., 1], e1[..., 0]
    a02 = -(a00 * m1[..., 0] + a01 * m1[..., 1])
    a12 = -(a10 * m1[..., 0] + a11 * m1[..., 1])
    h_a1 = _mat3(
        [[a00, a01, a02], [a10, a11, a12], [zero, zero, f1]],
        shape,
        dtype,
    )

    # H_A2^{-1} = [[E2, F2, M2],[0, 0, 1]].
    h_a2_inv = _mat3(
        [
            [e2[..., 0], f2v[..., 0], m2[..., 0]],
            [e2[..., 1], f2v[..., 1], m2[..., 1]],
            [zero, zero, one],
        ],
        shape,
        dtype,
    )

    # Core params, division-free (see ops/aca.py derivation).
    c = beta * (gamma * (f1 - beta) - alpha * (f2 - delta))
    d = alpha * (delta * (f1 - alpha) - beta * (f2 - gamma))
    e = alpha * beta * (f2 - gamma - delta)
    h_c = _mat3(
        [[c + e, zero, zero], [zero, d + e, zero], [c, d, e]],
        shape,
        dtype,
    )
    params = torch.stack(torch.broadcast_tensors(c, d, e), dim=-1)
    return ACAFactors(h_a1, h_c, h_a2_inv, params)


def sks_kernel_chain(params: Tensor):
    """Expand kernel params into the hyperbolic-similarity chain.

    Conjugated by the axis swap ``H_E = [[1,0,0],[0,0,1],[0,1,0]]`` (exchange
    the y and w axes), the kernel becomes an *affine* map of the (x, w) plane,

        H_E . H_K . H_E = [[a, u, b],
                           [u, a, v],
                           [0, 0, 1]]

    i.e. a translation ``H_T`` by ``(b, v)`` composed with the hyperbolic
    similarity ``H_G = [[a, u, 0], [u, a, 0], [0, 0, 1]]`` (the hyperbolic
    analogue of a rotation-scale: ``a ~ cosh``, ``u ~ sinh`` up to a common
    scale).  This function returns that exact 4-factor split — division-free,
    valid for all parameter values.

    Args:
      params: (..., 4) kernel parameters (a, b, u, v) from :func:`sks_factors`.

    Returns:
      Tuple of four (..., 3, 3) tensors ``(h_e, h_t, h_g, h_e)`` with
      ``h_e @ h_t @ h_g @ h_e == H_K`` exactly.
    """
    a, b, u, v = (params[..., i] for i in range(4))
    dtype = params.dtype
    shape = a.shape
    zero = torch.zeros(shape, dtype=dtype, device=params.device)
    one = torch.ones(shape, dtype=dtype, device=params.device)

    h_e = _mat3(
        [[one, zero, zero], [zero, zero, one], [zero, one, zero]],
        shape,
        dtype,
    )
    h_t = _mat3(
        [[one, zero, b], [zero, one, v], [zero, zero, one]],
        shape,
        dtype,
    )
    h_g = _mat3(
        [[a, u, zero], [u, a, zero], [zero, zero, one]],
        shape,
        dtype,
    )
    return h_e, h_t, h_g, h_e
