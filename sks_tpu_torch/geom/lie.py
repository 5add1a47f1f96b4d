"""Batched Lie-group utilities: SO(3), SE(3), SL(3) exp/log.

Port of ``sks_tpu/geom/lie.py``: the same functions on torch tensors.  Every
map is branch-free (Taylor-switched by ``torch.where``), so it batches over
leading dims, differentiates under ``torch.func`` and never reads a value
back to the host.
"""

from __future__ import annotations

import torch
from torch import Tensor

__all__ = [
    "mm_small",
    "hat3",
    "so3_exp",
    "so3_log",
    "se3_exp",
    "se3_log",
    "sl3_exp",
    "sl3_basis",
    "expm3",
    "logm3_near_identity",
]

_EPS = 1e-8


def mm_small(a: Tensor, b: Tensor) -> Tensor:
    """Batched small-matrix product as a broadcast multiply and sum.

    The JAX package writes its 3x3 / 4x4 geometry products this way to keep
    them off the TPU's matrix unit; here it keeps the same summation and the
    same broadcasting of leading dims.
    """
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def hat3(w: Tensor) -> Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], dim=-1),
            torch.stack([z, o, -x], dim=-1),
            torch.stack([-y, x, o], dim=-1),
        ],
        dim=-2,
    )


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def so3_exp(w: Tensor) -> Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation.

    Gradient-safe at w = 0 by the double-where pattern: the untaken generic
    branch is evaluated at theta^2 = 1, so its value and its derivative stay
    finite.
    """
    th2 = torch.sum(w * w, dim=-1)
    gen = th2 > _EPS
    th2_f = torch.where(gen, th2, torch.ones_like(th2))
    th = torch.sqrt(th2_f)
    a = torch.where(gen, torch.sin(th) / th, 1.0 - th2 / 6.0)
    b = torch.where(gen, (1.0 - torch.cos(th)) / th2_f, 0.5 - th2 / 24.0)
    k = hat3(w)
    return (_eye(3, w) + a[..., None, None] * k
            + b[..., None, None] * mm_small(k, k))


def so3_log(r: Tensor) -> Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle (|w| < pi).

    Gradient-safe at theta -> 0: the generic branch takes arccos of a clipped
    cosine, and the small-angle branch expresses its factor through |v|^2.
    """
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    v = torch.stack(
        [
            r[..., 2, 1] - r[..., 1, 2],
            r[..., 0, 2] - r[..., 2, 0],
            r[..., 1, 0] - r[..., 0, 1],
        ],
        dim=-1,
    )
    lim = 1.0 - 1e-6
    cos_c = torch.clamp(cos, -lim, lim)
    th_c = torch.arccos(cos_c)
    sin_c = torch.sqrt(1.0 - cos_c * cos_c)
    fac_gen = th_c / (2.0 * sin_c)
    s2 = 0.25 * torch.sum(v * v, dim=-1)  # sin^2(theta)
    fac_small = 0.5 + s2 / 12.0  # theta ~ sin for small angles
    small = cos > 1.0 - 1e-5
    fac = torch.where(small, fac_small, fac_gen)
    w_generic = fac[..., None] * v
    # Near pi: |v| -> 0; recover the axis from the diagonal of (R + I)/2.
    near_pi = cos < -1.0 + 1e-6
    d = torch.stack([r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]], dim=-1)
    axis2 = torch.clamp((d + 1.0) * 0.5, min=0.0)
    axis = torch.sqrt(axis2 + _EPS * _EPS)
    axis = axis * torch.where(v >= 0, 1.0, -1.0).to(r.dtype)
    nrm = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    w_pi = th_c[..., None] * axis / torch.clamp(nrm, min=_EPS)
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _bottom_row(like: Tensor, batch) -> Tensor:
    """(*batch, 1, 4) rows [0, 0, 0, 1], made on the device (no host copy)."""
    row = _eye(4, like)[3]
    return row.expand(*batch, 1, 4)


def se3_exp(xi: Tensor) -> Tensor:
    """(..., 6) twist [v, w] -> (..., 4, 4) rigid transform."""
    v, w = xi[..., :3], xi[..., 3:]
    r = so3_exp(w)
    th2 = torch.sum(w * w, dim=-1)
    gen = th2 > _EPS
    th2_f = torch.where(gen, th2, torch.ones_like(th2))
    th = torch.sqrt(th2_f)
    b = torch.where(gen, (1.0 - torch.cos(th)) / th2_f, 0.5 - th2 / 24.0)
    c = torch.where(gen, (th - torch.sin(th)) / (th2_f * th),
                    torch.full_like(th2, 1.0 / 6.0))
    k = hat3(w)
    jl = (_eye(3, xi) + b[..., None, None] * k
          + c[..., None, None] * mm_small(k, k))
    t = torch.sum(jl * v[..., None, :], dim=-1)
    top = torch.cat([r, t[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(xi, top.shape[:-2])], dim=-2)


def se3_log(g: Tensor) -> Tensor:
    """(..., 4, 4) -> (..., 6) twist [v, w]."""
    r = g[..., :3, :3]
    t = g[..., :3, 3]
    w = so3_log(r)
    th2 = torch.sum(w * w, dim=-1)
    k = hat3(w)
    # J_l^{-1} = I - k/2 + (1/th^2 - (1+cos th)/(2 th sin th)) k^2, with the
    # double-where of so3_exp.
    gen = th2 > 1e-8
    th2_safe = torch.where(gen, th2, torch.ones_like(th2))
    th_safe = torch.sqrt(th2_safe)
    coef = torch.where(
        gen,
        1.0 / th2_safe
        - (1.0 + torch.cos(th_safe)) / (2.0 * th_safe * torch.sin(th_safe)),
        1.0 / 12.0 + th2 / 720.0,
    )
    jli = _eye(3, g) - 0.5 * k + coef[..., None, None] * mm_small(k, k)
    v = torch.sum(jli * t[..., None, :], dim=-1)
    return torch.cat([v, w], dim=-1)


def sl3_basis(dtype=torch.float32, device=None) -> Tensor:
    """The 8 generators of sl(3) (traceless 3x3), the homography tangent space.

    Ordering: [tx, ty, rot, scale, shear1, shear2, proj_x, proj_y].
    """
    g = torch.zeros((8, 3, 3), dtype=dtype, device=device)
    g[0, 0, 2] = 1.0  # tx
    g[1, 1, 2] = 1.0  # ty
    g[2, 0, 1], g[2, 1, 0] = -1.0, 1.0  # rotation
    g[3, 0, 0], g[3, 1, 1], g[3, 2, 2] = 1.0, 1.0, -2.0  # scale
    g[4, 0, 0], g[4, 1, 1] = 1.0, -1.0  # shear (stretch)
    g[5, 0, 1], g[5, 1, 0] = 1.0, 1.0  # shear (skew)
    g[6, 2, 0] = 1.0  # projective x
    g[7, 2, 1] = 1.0  # projective y
    return g


def expm3(a: Tensor, terms: int = 12) -> Tensor:
    """Matrix exponential of a (..., 3, 3) matrix (fixed-term Taylor with
    scaling-and-squaring; branch-free).  For sl(3) coordinate vectors use
    :func:`sl3_exp`."""
    s = 4
    a = a / (2.0**s)
    out = _eye(3, a).expand(a.shape)
    term = out
    for k in range(1, terms):
        term = mm_small(term, a) / k
        out = out + term
    for _ in range(s):
        out = mm_small(out, out)
    return out


def logm3_near_identity(a: Tensor, terms: int = 10) -> Tensor:
    """Matrix log of a (..., 3, 3) matrix near the identity.

    Inverse scaling-and-squaring and the Mercator series: 2 matrix square
    roots by the linearized Newton step ``Y <- Y + (A - Y^2)/2`` (3 steps
    each, convergent for ||A - I|| < 1), then
    ``log(I + X) = X - X^2/2 + ...``.  Accurate to float32 roundoff for the
    sub-percent deviations the symmetric ESM composition produces; not a
    general matrix log.
    """
    eye = _eye(3, a)
    s = 2
    for _ in range(s):
        y = eye.expand(a.shape)
        for _ in range(3):
            y = y + 0.5 * (a - mm_small(y, y))
        a = y
    x = a - eye
    out = torch.zeros_like(a)
    p = x
    for k in range(1, terms + 1):
        out = out + ((-1.0) ** (k + 1) / k) * p
        p = mm_small(p, x)
    return out * (2.0**s)


def sl3_exp(x: Tensor, terms: int = 12) -> Tensor:
    """(..., 8) sl(3) coords -> (..., 3, 3) unit-determinant homography.

    Matrix exponential by fixed-term Taylor with scaling-and-squaring (4
    squarings; ||A|| is O(1) for tracking updates).
    """
    basis = sl3_basis(x.dtype, x.device)
    a = torch.sum(x[..., :, None, None] * basis, dim=-3)
    return expm3(a, terms)
