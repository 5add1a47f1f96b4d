"""Point-sharded N-point solvers: NDLT and HO over a mesh axis.

Port of ``sks_tpu/parallel/sharded_refine.py``.  The points of one large
refinement problem split across the ranks: each rank accumulates partial
normalization statistics and partial normal matrices over its block of
points, and a few small reductions (the stats, then the 9x9 / 3x3 normal
blocks, and for HO the reduced 3x3 ``DᵀD``) give every rank the same
solution.  The math of :func:`sks_tpu_torch.ops.ndlt.ndlt_h` and
:func:`sks_tpu_torch.ops.ho.ho_h`, weighted, in the points' dtype; a zero
weight pads a ragged block.  The eigenvector of both comes from the port's
:func:`sks_tpu_torch.ops.linalg.jacobi_eigh`, as in the JAX package's
sharded forms.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from sks_tpu_torch.ops.ho import _inv3_sym
from sks_tpu_torch.ops.linalg import jacobi_eigh, mm_highest as _mm
from sks_tpu_torch.ops.ndlt import _t_inv_matrix, _t_matrix
from sks_tpu_torch.parallel.mesh import Mesh, psum

__all__ = ["sharded_ndlt_h", "sharded_ho_h"]


def _point_block(mesh: Mesh, axis, src, tar, weights):
    """This rank's block of the (N, 2) points and (N,) weights, on the
    mesh's device; N is padded with zero weights to a multiple of the axis
    size."""
    src = torch.as_tensor(src, device=mesh.device)
    tar = torch.as_tensor(tar, device=mesh.device, dtype=src.dtype)
    w = (torch.ones(src.shape[:-1], dtype=src.dtype, device=mesh.device)
         if weights is None
         else torch.as_tensor(weights, device=mesh.device, dtype=src.dtype))
    pad = -src.shape[0] % mesh.size(axis)
    if pad:
        zeros = torch.zeros((pad, 2), dtype=src.dtype, device=src.device)
        src, tar = torch.cat([src, zeros]), torch.cat([tar, zeros])
        w = torch.cat([w, zeros[:, 0]])
    blk = mesh.block(src.shape[0], axis)
    return src[blk], tar[blk], w[blk]


def sharded_ndlt_h(mesh: Mesh, src: Tensor, tar: Tensor,
                   weights: Tensor | None = None, axis="pts") -> Tensor:
    """NDLT of (N, 2) correspondences whose points split over
    ``mesh[axis]``.

    Every rank passes the whole (replicated) point set and gets the same
    (3, 3) up-to-scale homography, the single-device
    :func:`sks_tpu_torch.ops.ndlt.ndlt_h` up to the order of the sums.
    """
    src, tar, w = _point_block(mesh, axis, src, tar, weights)
    # Round 1: the weighted means, then the mean absolute deviations.
    wsum, s1, s2 = psum(mesh, axis, torch.sum(w), torch.sum(src * w[:, None], 0),
                        torch.sum(tar * w[:, None], 0))
    c1, c2 = s1 / wsum, s2 / wsum
    d1, d2 = src - c1, tar - c2
    a1, a2 = psum(mesh, axis, torch.sum(torch.abs(d1) * w[:, None], 0),
                  torch.sum(torch.abs(d2) * w[:, None], 0))
    tiny = torch.finfo(src.dtype).tiny
    sc1 = 1.0 / torch.clamp(a1 / wsum, min=tiny)
    sc2 = 1.0 / torch.clamp(a2 / wsum, min=tiny)
    sn, tn = d1 * sc1, d2 * sc2

    # Round 2: the 9x9 normal matrix, a sum over points (81 floats).
    x, y = sn[:, 0], sn[:, 1]
    xp, yp = tn[:, 0], tn[:, 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    rows_x = torch.stack([x, y, one, zero, zero, zero, -xp * x, -xp * y, -xp],
                         -1)
    rows_y = torch.stack([zero, zero, zero, x, y, one, -yp * x, -yp * y, -yp],
                         -1)
    a = torch.cat([rows_x, rows_y], 0)
    w2 = torch.cat([w, w], 0)
    ltl = psum(mesh, axis, torch.einsum("np,n,nq->pq", a, w2, a))

    _, v = jacobi_eigh(ltl)
    hm = v[:, 0].reshape(3, 3)
    t1 = _t_matrix(c1[0], c1[1], sc1[0], sc1[1])
    t2i = _t_inv_matrix(c2[0], c2[1], sc2[0], sc2[1])
    return _mm(_mm(t2i, hm), t1)


def sharded_ho_h(mesh: Mesh, src: Tensor, tar: Tensor,
                 weights: Tensor | None = None, axis="pts") -> Tensor:
    """Harker-O'Leary of (N, 2) correspondences whose points split over
    ``mesh[axis]``.

    Reductions: the isotropic stats; the 3x3 blocks ``G = Cᵀ W C`` and
    ``M = Cᵀ W diag(vals) C``; then the reduced 3x3 ``DᵀD``, whose rows need
    the global ``G⁻¹ M``.  Returns the same (3, 3) on every rank, the
    single-device :func:`sks_tpu_torch.ops.ho.ho_h` up to the order of the
    sums and its eigensolver (Jacobi here, the closed form there).
    """
    src, tar, w = _point_block(mesh, axis, src, tar, weights)
    tiny = torch.finfo(src.dtype).tiny
    wsum, s1, s2 = psum(mesh, axis, torch.sum(w), torch.sum(src * w[:, None], 0),
                        torch.sum(tar * w[:, None], 0))
    c1, c2 = s1 / wsum, s2 / wsum
    d1, d2 = src - c1, tar - c2
    m1, m2 = psum(mesh, axis,
                  torch.sum(torch.sqrt(torch.sum(d1 * d1, -1)) * w),
                  torch.sum(torch.sqrt(torch.sum(d2 * d2, -1)) * w))
    sqrt2 = torch.full((), math.sqrt(2.0), dtype=src.dtype, device=src.device)
    sc1 = sqrt2 / torch.clamp(m1 / wsum, min=tiny)
    sc2 = sqrt2 / torch.clamp(m2 / wsum, min=tiny)
    sn, tn = d1 * sc1, d2 * sc2

    x, y = sn[:, 0], sn[:, 1]
    xp, yp = tn[:, 0], tn[:, 1]
    cw = torch.stack([x, y, torch.ones_like(x)], -1)  # C rows
    c = cw * w[:, None]  # weighted C
    g3, mx, my = psum(mesh, axis, torch.einsum("ni,nj->ij", c, cw),
                      torch.einsum("ni,nj->ij", c, xp[:, None] * cw),
                      torch.einsum("ni,nj->ij", c, yp[:, None] * cw))
    ginv = _inv3_sym(g3)

    def partial_dtd(vals, m):
        r = cw @ _mm(ginv, m) - vals[:, None] * cw
        return torch.einsum("ni,n,nj->ij", r, w, r)

    dtd = psum(mesh, axis, partial_dtd(xp, mx) + partial_dtd(yp, my))
    _, v = jacobi_eigh(dtd)
    g = v[:, 0]
    u = _mm(ginv, _mm(mx, g[:, None]))[:, 0]
    vv = _mm(ginv, _mm(my, g[:, None]))[:, 0]
    hm = torch.stack([u, vv, g], 0)
    t1 = _t_matrix(c1[0], c1[1], sc1, sc1)
    t2i = _t_inv_matrix(c2[0], c2[1], sc2, sc2)
    return _mm(_mm(t2i, hm), t1)
