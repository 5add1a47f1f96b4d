"""HO — Harker-O'Leary homography estimation (batched, N >= 4).

Port of ``sks_tpu/ops/ho.py`` (the derivation is in that module's
docstring): after isotropic normalization the first six homography entries
are eliminated in closed form, leaving a 3x3 normal matrix whose smallest
eigenvector gives ``(h7, h8, h9)``.

Two formulations, as in the JAX package: :func:`ho_h`, the N-point weighted
matrix form with the closed-form 3x3 eigensolver (the registered solver),
and :func:`ho_core`, the straight-line minimal-set form.
``ho_core(eig_method='jacobi')`` is the plain version of the CUDA kernel
``ho_solve_soa`` and the specification of its body (``csrc/baselines.cuh``).
The JAX package's double-float branch becomes native fp64:
``ho_core(eig_method='invit64')``, the plain version of the HO instance of K5
(``fp64_solve_soa``) and its body's specification.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from sks_tpu_torch.ops.linalg import (
    invit_smallest_col_core,
    jacobi_smallest_col_core,
    mm_highest as _mm,
    smallest_eigvec3_core,
    smallest_eigvec_sym,
)

__all__ = ["ho", "ho_core", "ho_h"]


def ho_core(
    x0, y0, x1, y1, x2, y2, x3, y3,
    X0, Y0, X1, Y1, X2, Y2, X3, Y3,
    eig_method: str = "closed3",
):
    """Straight-line minimal-set (N=4) Harker-O'Leary on components.

    Isotropic normalization, closed-form elimination of (h1..h6), smallest
    3x3 eigenvector for (h7, h8, h9), back-substitution, denormalization:
    the math of :func:`ho_h` for 4 unweighted points.  Returns the 9
    homography entries row-major, up to scale.

    ``eig_method``: 'closed3' (trigonometric closed form), 'jacobi' (10
    fixed sweeps of component Jacobi; the K4 kernel's form) or 'invit64',
    the float64 branch: the JAX package's double-float branch in native
    fp64 (the K5 kernel's form).  It floors the scale by adding the float32
    ``tiny`` instead of taking the max, seeds with 4 float32 Jacobi sweeps
    on the 3x3 rounded to float32 (``Tensor.float()``) and widened back, and
    runs inverse iteration shifted by ``2^-40 trace`` with 2 solves.  Feed
    it float64 components.
    """
    if eig_method not in ("closed3", "jacobi", "invit64"):
        raise ValueError(f"unknown eig_method {eig_method!r}")
    invit64 = eig_method == "invit64"
    dtype, device = x0.dtype, x0.device
    # A tensor, not a Python float: ``float / tensor`` is a reciprocal and a
    # product in PyTorch (two roundings), ``tensor / tensor`` one division.
    sqrt2 = torch.full((), math.sqrt(2.0), dtype=dtype, device=device)
    tiny = torch.finfo(torch.float32 if invit64 else dtype).tiny
    quarter = 0.25

    def floor_tiny(v):
        if invit64:
            return torch.where(v > tiny, v, v + tiny)
        # clamp propagates NaN, as jnp.maximum does.
        return torch.clamp(v, min=tiny)

    def iso(xs, ys):
        cx = (xs[0] + xs[1] + xs[2] + xs[3]) * quarter
        cy = (ys[0] + ys[1] + ys[2] + ys[3]) * quarter
        dx = [x - cx for x in xs]
        dy = [y - cy for y in ys]
        mean = (
            sum(torch.sqrt(dx[i] * dx[i] + dy[i] * dy[i]) for i in range(4))
            * quarter
        )
        s = sqrt2 / floor_tiny(mean)
        return [d * s for d in dx], [d * s for d in dy], cx, cy, s

    sx, sy, cx1, cy1, s1 = iso((x0, x1, x2, x3), (y0, y1, y2, y3))
    tx, ty, cx2, cy2, s2 = iso((X0, X1, X2, X3), (Y0, Y1, Y2, Y3))

    # G = C^T C with C = [x y 1] (4x3); symmetric, 6 components.
    g00 = sum(sx[i] * sx[i] for i in range(4))
    g01 = sum(sx[i] * sy[i] for i in range(4))
    g02 = sum(sx[i] for i in range(4))
    g11 = sum(sy[i] * sy[i] for i in range(4))
    g12 = sum(sy[i] for i in range(4))
    g22 = torch.full_like(g02, 4.0)

    # G^{-1} via adjugate.
    ca = g11 * g22 - g12 * g12
    cb = g02 * g12 - g01 * g22
    cc = g01 * g12 - g02 * g11
    cd = g00 * g22 - g02 * g02
    ce = g01 * g02 - g00 * g12
    cf = g00 * g11 - g01 * g01
    det = g00 * ca + g01 * cb + g02 * cc
    dinv = 1.0 / det
    gi = (
        (ca * dinv, cb * dinv, cc * dinv),
        (cb * dinv, cd * dinv, ce * dinv),
        (cc * dinv, ce * dinv, cf * dinv),
    )

    def reduced(vals):
        """Residual rows R = (P - I) diag(vals) C and M = C^T diag(vals) C."""
        m = [[None] * 3 for _ in range(3)]
        m[0][0] = sum(vals[i] * sx[i] * sx[i] for i in range(4))
        m[0][1] = m[1][0] = sum(vals[i] * sx[i] * sy[i] for i in range(4))
        m[0][2] = m[2][0] = sum(vals[i] * sx[i] for i in range(4))
        m[1][1] = sum(vals[i] * sy[i] * sy[i] for i in range(4))
        m[1][2] = m[2][1] = sum(vals[i] * sy[i] for i in range(4))
        m[2][2] = sum(vals[i] for i in range(4))
        # K = G^{-1} M (3x3).
        k = [
            [sum(gi[r][j] * m[j][c] for j in range(3)) for c in range(3)]
            for r in range(3)
        ]
        # Row i of R: c_i @ K - vals_i * c_i with c_i = (x_i, y_i, 1).
        rows = []
        for i in range(4):
            proj = [sx[i] * k[0][c] + sy[i] * k[1][c] + k[2][c]
                    for c in range(3)]
            rows.append((proj[0] - vals[i] * sx[i],
                         proj[1] - vals[i] * sy[i],
                         proj[2] - vals[i]))
        return rows, m

    rx, mx = reduced(tx)
    ry, my = reduced(ty)

    # D^T D, symmetric 3x3 accumulated over the 8 residual rows.
    d00 = sum(r[0] * r[0] for r in rx) + sum(r[0] * r[0] for r in ry)
    d01 = sum(r[0] * r[1] for r in rx) + sum(r[0] * r[1] for r in ry)
    d02 = sum(r[0] * r[2] for r in rx) + sum(r[0] * r[2] for r in ry)
    d11 = sum(r[1] * r[1] for r in rx) + sum(r[1] * r[1] for r in ry)
    d12 = sum(r[1] * r[2] for r in rx) + sum(r[1] * r[2] for r in ry)
    d22 = sum(r[2] * r[2] for r in rx) + sum(r[2] * r[2] for r in ry)
    dmat = [[d00, d01, d02], [d01, d11, d12], [d02, d12, d22]]
    if eig_method == "jacobi":
        gvec = jacobi_smallest_col_core(dmat, sweeps=10)
    elif invit64:
        seed = jacobi_smallest_col_core(
            [[e.float() for e in row] for row in dmat], sweeps=4)
        gvec = invit_smallest_col_core(dmat, [v.to(dtype) for v in seed],
                                       shift_rel=2.0 ** -40, solves=2)
    else:
        gvec = smallest_eigvec3_core(d00, d01, d02, d11, d12, d22)

    def back(m):
        w = [sum(m[r][j] * gvec[j] for j in range(3)) for r in range(3)]
        return [sum(gi[r][j] * w[j] for j in range(3)) for r in range(3)]

    u = back(mx)
    v = back(my)
    hn = (u[0], u[1], u[2], v[0], v[1], v[2], gvec[0], gvec[1], gvec[2])

    # Denormalize: H = T2^{-1} Hn T1, isotropic T's.
    rows_t1 = []
    for r in range(3):
        h0, h1, h2 = hn[3 * r], hn[3 * r + 1], hn[3 * r + 2]
        rows_t1.append((h0 * s1, h1 * s1, h2 - s1 * (h0 * cx1 + h1 * cy1)))
    inv_s2 = 1.0 / s2
    out0 = tuple(rows_t1[0][c] * inv_s2 + cx2 * rows_t1[2][c] for c in range(3))
    out1 = tuple(rows_t1[1][c] * inv_s2 + cy2 * rows_t1[2][c] for c in range(3))
    return (*out0, *out1, *rows_t1[2])


def _iso_norm(pts: Tensor, w: Tensor):
    """Isotropic normalization: zero centroid, mean distance sqrt(2)."""
    wsum = torch.sum(w, dim=-1, keepdim=True)
    c = torch.sum(pts * w[..., None], dim=-2, keepdim=True) / wsum[..., None]
    d = pts - c
    dist = torch.sqrt(torch.sum(d * d, dim=-1))
    mean = torch.sum(dist * w, dim=-1, keepdim=True) / wsum
    sqrt2 = torch.full((), math.sqrt(2.0), dtype=pts.dtype, device=pts.device)
    s = sqrt2 / torch.clamp(mean, min=torch.finfo(pts.dtype).tiny)
    return d * s[..., None], (c[..., 0, 0], c[..., 0, 1], s[..., 0])


def _inv3_sym(g: Tensor) -> Tensor:
    """Closed-form inverse of symmetric 3x3 via adjugate."""
    a, b, c = g[..., 0, 0], g[..., 0, 1], g[..., 0, 2]
    d, e = g[..., 1, 1], g[..., 1, 2]
    f = g[..., 2, 2]
    ca = d * f - e * e
    cb = c * e - b * f
    cc = b * e - c * d
    cd = a * f - c * c
    ce = b * c - a * e
    cf = a * d - b * b
    det = a * ca + b * cb + c * cc
    inv = 1.0 / det
    return (
        torch.stack(
            [
                torch.stack([ca, cb, cc], dim=-1),
                torch.stack([cb, cd, ce], dim=-1),
                torch.stack([cc, ce, cf], dim=-1),
            ],
            dim=-2,
        )
        * inv[..., None, None]
    )


def ho_h(src: Tensor, tar: Tensor, weights: Tensor | None = None) -> Tensor:
    """Up-to-scale Harker-O'Leary homography.

    Args:
      src, tar: (..., N, 2), N >= 4.
      weights: optional (..., N); zero drops a point.

    Returns:
      (..., 3, 3) homography, unnormalized.
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    sn, (cx1, cy1, s1) = _iso_norm(src, weights)
    tn, (cx2, cy2, s2) = _iso_norm(tar, weights)

    x, y = sn[..., 0], sn[..., 1]
    xp, yp = tn[..., 0], tn[..., 1]
    one = torch.ones_like(x)
    cw = torch.stack([x, y, one], dim=-1)
    c = cw * weights[..., None]  # weighted C

    g3 = torch.einsum("...ni,...nj->...ij", c, cw)  # C^T W C
    ginv = _inv3_sym(g3)

    def reduced(vals):
        # R = C Ginv C^T W diag(vals) C - diag(vals) C, without forming P.
        dc = vals[..., None] * cw
        ctwd = torch.einsum("...ni,...nj->...ij", c, dc)
        proj = torch.einsum("...ni,...ij,...jk->...nk", cw, ginv, ctwd)
        return proj - dc, ctwd

    rx, mx = reduced(xp)
    ry, my = reduced(yp)
    dtd = (torch.einsum("...ni,...n,...nj->...ij", rx, weights, rx)
           + torch.einsum("...ni,...n,...nj->...ij", ry, weights, ry))
    g = smallest_eigvec_sym(dtd, method="closed3")

    u = torch.einsum("...ij,...jk,...k->...i", ginv, mx, g)
    v = torch.einsum("...ij,...jk,...k->...i", ginv, my, g)
    hm = torch.stack([u, v, g], dim=-2)

    # Denormalize with the isotropic T's.
    z = torch.zeros_like(s1)
    o = torch.ones_like(s1)
    t1 = torch.stack(
        [
            torch.stack([s1, z, -s1 * cx1], dim=-1),
            torch.stack([z, s1, -s1 * cy1], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )
    t2inv = torch.stack(
        [
            torch.stack([1.0 / s2, z, cx2], dim=-1),
            torch.stack([z, 1.0 / s2, cy2], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )
    return _mm(_mm(t2inv, hm), t1)


def ho(src: Tensor, tar: Tensor, weights: Tensor | None = None) -> Tensor:
    """HO homography normalized to ``H[2,2] == 1``."""
    h = ho_h(src, tar, weights)
    return h / h[..., 2:3, 2:3]
