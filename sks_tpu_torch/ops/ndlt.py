"""NDLT — normalized Direct Linear Transform homography (batched, N >= 4).

Port of ``sks_tpu/ops/ndlt.py``: Hartley-normalize both point sets,
accumulate the 9x9 normal matrix of the stacked DLT constraints, take its
smallest eigenvector, denormalize.

Two formulations, as in the JAX package: :func:`ndlt_h`, the N-point
weighted matrix form (optional per-point weights make padded point sets and
IRLS reweighting work without data-dependent shapes), and :func:`ndlt_core`,
the straight-line minimal-set form.  ``ndlt_core(eig='invit')`` is the plain
version of the CUDA kernel ``ndlt_solve_soa`` and the specification of its
body (``csrc/baselines.cuh``).  The JAX package's double-float branch becomes
native fp64: ``ndlt_core(eig='invit64')``, the plain version of the NDLT
instance of K5 (``fp64_solve_soa``) and its body's specification.
"""

from __future__ import annotations

import torch
from torch import Tensor

from sks_tpu_torch.ops.linalg import (
    invit_smallest_col_core,
    jacobi_smallest_col_core,
    mm_highest as _mm,
    smallest_eigvec_sym,
)

__all__ = ["ndlt", "ndlt_core", "ndlt_h"]


def ndlt_core(
    x0, y0, x1, y1, x2, y2, x3, y3,
    X0, Y0, X1, Y1, X2, Y2, X3, Y3,
    sweeps: int = 6,
    eig: str = "jacobi",
):
    """Straight-line minimal-set (N=4) NDLT on components.

    Exploits the DLT normal matrix's block structure: with per-point
    ``p = (x, y, 1)`` and constraint rows ``[p, 0, -X'p]``, ``[0, p, -Y'p]``,

        LtL = [[S1, 0, Sx], [0, S1, Sy], [Sx, Sy, Sd]]

    where each 3x3 block is a weighted sum of ``p p^T`` with weights
    ``1, -X', -Y', X'^2 + Y'^2``: 24 scalar sums.  The smallest eigenvector
    comes from ``sweeps`` sweeps of component Jacobi (``eig='jacobi'``) or
    from shifted inverse iteration seeded by 3 Jacobi sweeps
    (``eig='invit'``, the K4 kernel's form).  Returns 9 entries row-major,
    up to scale.

    ``eig='invit64'`` is the float64 branch, the JAX package's double-float
    branch in native fp64 (the K5 kernel's form): the scale floor adds
    ``tiny`` instead of taking the max, the seed is 3 float32 Jacobi sweeps
    on the normal matrix rounded to float32 (``Tensor.float()``) and widened
    back, and the inverse iteration shifts by ``2^-40 trace`` and runs 2
    solves.  Feed it float64 components.
    """
    if eig not in ("jacobi", "invit", "invit64"):
        raise ValueError(f"unknown eig {eig!r}")
    quarter = 0.25
    # Hartley scales divide by the mean |dev|, which is >= a pixel for any
    # non-coincident quad; the f32-tiny floor only guards all-equal points.
    tiny = torch.finfo(torch.float32).tiny

    def floor(dev):
        if eig == "invit64":
            return torch.where(dev > tiny, dev, dev + tiny)
        # clamp propagates NaN, as jnp.maximum does.
        return torch.clamp(dev, min=tiny)

    def hartley(xs, ys):
        cx = (xs[0] + xs[1] + xs[2] + xs[3]) * quarter
        cy = (ys[0] + ys[1] + ys[2] + ys[3]) * quarter
        dx = [x - cx for x in xs]
        dy = [y - cy for y in ys]
        devx = (torch.abs(dx[0]) + torch.abs(dx[1]) + torch.abs(dx[2])
                + torch.abs(dx[3])) * quarter
        devy = (torch.abs(dy[0]) + torch.abs(dy[1]) + torch.abs(dy[2])
                + torch.abs(dy[3])) * quarter
        sx = 1.0 / floor(devx)
        sy = 1.0 / floor(devy)
        return ([d * sx for d in dx], [d * sy for d in dy], cx, cy, sx, sy)

    nx, ny, cx1, cy1, sx1, sy1 = hartley((x0, x1, x2, x3), (y0, y1, y2, y3))
    tx, ty, cx2, cy2, sx2, sy2 = hartley((X0, X1, X2, X3), (Y0, Y1, Y2, Y3))

    def wsum_ppt(w):
        """Weighted sums of the 6 unique p p^T entries over the 4 points."""
        return (
            sum(w[i] * nx[i] * nx[i] for i in range(4)),  # xx
            sum(w[i] * nx[i] * ny[i] for i in range(4)),  # xy
            sum(w[i] * nx[i] for i in range(4)),          # x
            sum(w[i] * ny[i] * ny[i] for i in range(4)),  # yy
            sum(w[i] * ny[i] for i in range(4)),          # y
            sum(w[i] for i in range(4)),                  # 1
        )

    ones = [torch.ones_like(x0)] * 4
    z = torch.zeros_like(x0)
    s1 = wsum_ppt(ones)
    sx_ = wsum_ppt([-t for t in tx])
    sy_ = wsum_ppt([-t for t in ty])
    sd = wsum_ppt([tx[i] * tx[i] + ty[i] * ty[i] for i in range(4)])

    def block(e):
        xx, xy, x, yy, y, o = e
        return [[xx, xy, x], [xy, yy, y], [x, y, o]]

    zb = [[z] * 3 for _ in range(3)]
    b1, bx, by, bd = block(s1), block(sx_), block(sy_), block(sd)
    ltl = [
        [*b1[r], *zb[r], *bx[r]] for r in range(3)
    ] + [
        [*zb[r], *b1[r], *by[r]] for r in range(3)
    ] + [
        [*bx[r], *by[r], *bd[r]] for r in range(3)
    ]

    if eig == "invit":
        h = invit_smallest_col_core(ltl)
    elif eig == "invit64":
        seed = jacobi_smallest_col_core(
            [[e.float() for e in row] for row in ltl], sweeps=3)
        h = invit_smallest_col_core(ltl, [v.to(x0.dtype) for v in seed],
                                    shift_rel=2.0 ** -40, solves=2)
    else:
        h = jacobi_smallest_col_core(ltl, sweeps=sweeps)

    # Denormalize: H = T2^{-1} Hn T1 (anisotropic Hartley T's).
    rows_t1 = []
    for r in range(3):
        h0, h1, h2 = h[3 * r], h[3 * r + 1], h[3 * r + 2]
        rows_t1.append(
            (h0 * sx1, h1 * sy1, h2 - h0 * sx1 * cx1 - h1 * sy1 * cy1)
        )
    inv_sx2 = 1.0 / sx2
    inv_sy2 = 1.0 / sy2
    out0 = tuple(rows_t1[0][c] * inv_sx2 + cx2 * rows_t1[2][c]
                 for c in range(3))
    out1 = tuple(rows_t1[1][c] * inv_sy2 + cy2 * rows_t1[2][c]
                 for c in range(3))
    return (*out0, *out1, *rows_t1[2])


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
      eig_method: 'jacobi' (default, branch-free fixed sweeps) or another
        method of :func:`sks_tpu_torch.ops.linalg.smallest_eigvec_sym`
        ('eigh': ``torch.linalg.eigh``).

    Returns:
      (..., 3, 3) homography, unnormalized.
    """
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

    h = smallest_eigvec_sym(ltl, method=eig_method)
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
