"""Homography -> relative pose recovery (batched Faugeras-Lustman decomposition).

Port of ``sks_tpu/geom/pose.py``.  With ``Hn = K2^{-1} H K1`` and SVD
``Hn = U diag(d1,d2,d3) V^T`` (``d1 >= d2 >= d3``, scale fixed by ``d2 = 1``),
the Faugeras-Lustman closed form yields four candidate ``(R', t', n')`` in the
SVD frame (sign choices ``e1, e3 = +-1``):

    aux1 = sqrt((d1^2-d2^2)/(d1^2-d3^2)),  aux3 = sqrt((d2^2-d3^2)/(d1^2-d3^2))
    n' = (e1 aux1, 0, e3 aux3)
    sin t = e1 e3 sqrt((d1^2-d2^2)(d2^2-d3^2)) / ((d1+d3) d2)
    cos t = (d2^2 + d1 d3) / ((d1+d3) d2)
    R' = R_y(t),  t' = (d1-d3) (e1 aux1, 0, -e3 aux3)

mapped back by ``R = s U R' V^T``, ``t = U t'``, ``n = V n'``
(``s = det U det V``, which absorbs a sign flip of any eigenvector column).
The SVD comes from a symmetric eigendecomposition of ``Hn^T Hn`` with
``U = Hn V diag(1/d)``; the physical candidate is picked by cheirality.

Everything is batched over leading dims and free of host synchronisation: the
3 x 3 eigendecomposition is the port's fixed-sweep Jacobi
(``ops.linalg.jacobi_eigh``), because ``torch.linalg.eigh`` checks its error
codes on the host, and determinants and the intrinsics' inverse are the 3 x 3
closed forms.
"""

from __future__ import annotations

import torch
from torch import Tensor

from sks_tpu_torch.ops.linalg import jacobi_eigh
from sks_tpu_torch.ops.linalg import mm_highest as _mm

__all__ = ["decompose_homography", "select_pose", "recover_pose"]


def _sym_eig_desc(a: Tensor):
    """Batched symmetric eig, eigenvalues descending."""
    w, v = jacobi_eigh(a)  # ascending
    return w.flip(-1), v.flip(-1)


def _det3(m: Tensor) -> Tensor:
    """(..., 3, 3) -> (...,) determinant by cofactors along the first row."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def _inv3(m: Tensor) -> Tensor:
    """(..., 3, 3) inverse by the adjugate over the determinant."""
    from sks_tpu_torch.geom.homography import inv_h

    return inv_h(m) / _det3(m)[..., None, None]


def decompose_homography(hn: Tensor):
    """All four Faugeras candidates of a *calibrated* homography.

    Args:
      hn: (..., 3, 3) calibrated homography (``K2^{-1} H K1``), any scale.

    Returns:
      dict with 'r' (..., 4, 3, 3), 't' (..., 4, 3) (scale = translation/d),
      'n' (..., 4, 3) plane normals in camera-1 frame, and 'degenerate'
      (...,) bool — True where H is (near) a pure rotation (d1 ~ d2 ~ d3), in
      which case t ~ 0 and n is meaningless.
    """
    w, v = _sym_eig_desc(_mm(hn.transpose(-1, -2), hn))
    w = torch.clamp(w, min=0.0)
    d = torch.sqrt(w)
    d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2]
    # Scale to d2 = 1.
    inv_d2 = 1.0 / d2
    hs = hn * inv_d2[..., None, None]
    d1n = d1 * inv_d2
    d3n = d3 * inv_d2

    col = torch.where(d > 0, d2[..., None] / d, torch.zeros_like(d))
    u = _mm(hs, v) * col[..., None, :]
    s = _det3(u) * _det3(v)

    denom = torch.clamp(d1n * d1n - d3n * d3n, min=1e-12)
    aux1 = torch.sqrt(torch.clamp(d1n * d1n - 1.0, min=0.0) / denom)
    aux3 = torch.sqrt(torch.clamp(1.0 - d3n * d3n, min=0.0) / denom)
    dsum = torch.clamp(d1n + d3n, min=1e-12)
    sin_t = torch.sqrt(
        torch.clamp(d1n * d1n - 1.0, min=0.0)
        * torch.clamp(1.0 - d3n * d3n, min=0.0)
    ) / dsum
    cos_t = (1.0 + d1n * d3n) / dsum

    # The sign choices (e1, e3) of the four candidates: (+,+), (+,-), (-,+),
    # (-,-), made on the device.
    k = torch.arange(4, device=hn.device)
    e1 = (1 - 2 * (k // 2)).to(hn.dtype)
    e3 = (1 - 2 * (k % 2)).to(hn.dtype)

    def bc(x):  # (...,) -> (..., 1)
        return x[..., None]

    st = bc(sin_t) * e1 * e3
    ct = bc(cos_t).expand(st.shape)
    zero = torch.zeros_like(st)
    one = torch.ones_like(st)
    # R'(theta) about y: rows.
    rp = torch.stack(
        [
            torch.stack([ct, zero, -st], dim=-1),
            torch.stack([zero, one, zero], dim=-1),
            torch.stack([st, zero, ct], dim=-1),
        ],
        dim=-2,
    )  # (..., 4, 3, 3)
    np_ = torch.stack([bc(aux1) * e1, zero, bc(aux3) * e3], dim=-1)
    tp = (bc(d1n) - bc(d3n))[..., None] * torch.stack(
        [bc(aux1) * e1, zero, -bc(aux3) * e3], dim=-1
    )

    uu = u[..., None, :, :]
    vv = v[..., None, :, :]
    r = s[..., None, None, None] * _mm(_mm(uu, rp), vv.transpose(-1, -2))
    t = torch.einsum("...ij,...kj->...ki", u, tp)
    n = torch.einsum("...ij,...kj->...ki", v, np_)
    # Canonicalize: plane normal towards camera 1 (n_z > 0 convention).
    flip = torch.where(n[..., 2:3] < 0, -1.0, 1.0).to(hn.dtype)
    n = n * flip
    t = t * flip

    degenerate = (d1n - d3n) < 1e-6
    return {"r": r, "t": t, "n": n, "degenerate": degenerate}


def select_pose(cands: dict, pts1n: Tensor, pts2n: Tensor,
                normal_prior: Tensor | None = None):
    """Pick the physical candidate by cheirality (positive depths).

    A single homography generically admits two cheirality-consistent
    interpretations; ``normal_prior`` — an approximate plane normal in the
    camera-1 frame — adds a tie-breaking bonus of ``0.1 * (n . prior)`` to
    each candidate.

    Args:
      cands: output of :func:`decompose_homography`.
      pts1n, pts2n: (..., N, 2) correspondences in *normalized camera*
        coordinates (K^{-1} applied).
      normal_prior: optional (..., 3) unit vector.

    Returns:
      (r (...,3,3), t (...,3), n (...,3), score (...,)) — score is the
      fraction of points passing cheirality for the winner (prior bonus
      excluded).
    """
    r, t, n = cands["r"], cands["t"], cands["n"]
    m1 = torch.cat([pts1n, torch.ones_like(pts1n[..., :1])], dim=-1)

    # Cheirality. With the n_z > 0 canonicalization and plane depth d = 1,
    # the camera-1 point on the plane along ray m1 is X1 = m1 / (n . m1):
    #   depth-1 positivity:  n . m1 > 0
    #   depth-2 positivity:  z2 = [R X1 + t]_z > 0
    ndotm = torch.einsum("...kj,...nj->...kn", n, m1)  # (..., 4, N)
    vis1 = ndotm > 0
    rx = torch.einsum("...kij,...nj->...kni", r, m1)  # (..., 4, N, 3)
    safe = torch.where(ndotm == 0, torch.full_like(ndotm, 1e-12), ndotm)
    z2 = rx[..., 2] / safe + t[..., None, 2]
    vis2 = z2 > 0
    good = (vis1 & vis2).to(r.dtype).mean(dim=-1)  # (..., 4)
    ranking = good
    if normal_prior is not None:
        bonus = torch.einsum("...kj,...j->...k", n, normal_prior)
        ranking = ranking + 0.1 * bonus
    best = torch.argmax(ranking, dim=-1)  # the first maximum, as jnp.argmax

    r_b = torch.gather(
        r, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3)
    ).squeeze(-3)
    t_b = torch.gather(t, -2, best[..., None, None].expand(*best.shape, 1, 3)
                       ).squeeze(-2)
    n_b = torch.gather(n, -2, best[..., None, None].expand(*best.shape, 1, 3)
                       ).squeeze(-2)
    score = torch.gather(good, -1, best[..., None]).squeeze(-1)
    return r_b, t_b, n_b, score


def recover_pose(h: Tensor, k1: Tensor, k2: Tensor, pts1: Tensor,
                 pts2: Tensor, normal_prior: Tensor | None = None):
    """End-to-end: pixel homography + intrinsics -> (R, t/d, n, score)."""
    k1i = _inv3(k1)
    k2i = _inv3(k2)
    hn = _mm(_mm(k2i, h), k1)
    cands = decompose_homography(hn)

    def norm_pts(pts, ki):
        m = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
        mn = torch.einsum("...ij,...nj->...ni", ki, m)
        return mn[..., :2] / mn[..., 2:3]

    return select_pose(
        cands, norm_pts(pts1, k1i), norm_pts(pts2, k2i), normal_prior
    )
