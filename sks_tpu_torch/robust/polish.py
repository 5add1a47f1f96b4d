"""Final geometric polish: annealed-threshold Levenberg-Marquardt on inliers.

Port of ``sks_tpu/robust/polish.py``.  The selected RANSAC model is
re-polished at a shrinking inlier threshold (1.0x, 0.7x, 0.5x of the user
threshold), each level re-deriving its consensus from the current model and
running weighted Gauss-Newton/LM on the forward reprojection error.  Fixed
iteration counts and ``torch.where`` accept/reject: no host synchronisation.
On float32 CUDA tensors the whole annealed polish is one launch of the kernel
``kernels.polish_cuda.anneal_polish``.
"""

from __future__ import annotations

import torch
from torch import Tensor

from sks_tpu_torch.kernels import polish_cuda
from sks_tpu_torch.ops.ndlt import _hartley, _t_inv_matrix, _t_matrix
from sks_tpu_torch.utils import graphs
from sks_tpu_torch.utils.profiling import count

__all__ = ["gn_refine_h", "anneal_polish"]


def _forward_normal_eqs(h: Tensor, src: Tensor, tar: Tensor, w: Tensor):
    """Weighted GN normal equations of the forward reprojection residual.

    Residual r_i = H(src_i) - tar_i (inhomogeneous, 2-vector); parameters are
    the 8 entries h00..h21 with h22 fixed at 1.

    Returns (A (8, 8), g (8,), cost ()) with A = J^T W J, g = J^T W r.
    """
    x, y = src[..., 0], src[..., 1]
    px = h[0, 0] * x + h[0, 1] * y + h[0, 2]
    py = h[1, 0] * x + h[1, 1] * y + h[1, 2]
    pz = h[2, 0] * x + h[2, 1] * y + h[2, 2]
    iz = 1.0 / pz
    rx = px * iz - tar[..., 0]
    ry = py * iz - tar[..., 1]
    # d(px/pz)/dtheta rows: [x/z, y/z, 1/z, 0, 0, 0, -px x/z^2, -px y/z^2]
    # d(py/pz)/dtheta rows: [0, 0, 0, x/z, y/z, 1/z, -py x/z^2, -py y/z^2]
    z0 = torch.zeros_like(x)
    jx = torch.stack(
        [x * iz, y * iz, iz, z0, z0, z0,
         -px * x * iz * iz, -px * y * iz * iz], dim=-1
    )  # (N, 8)
    jy = torch.stack(
        [z0, z0, z0, x * iz, y * iz, iz,
         -py * x * iz * iz, -py * y * iz * iz], dim=-1
    )
    a_mat = (
        torch.einsum("ni,nj->ij", w[:, None] * jx, jx)
        + torch.einsum("ni,nj->ij", w[:, None] * jy, jy)
    )
    g = (
        torch.einsum("ni,n->i", jx, w * rx)
        + torch.einsum("ni,n->i", jy, w * ry)
    )
    cost = torch.sum(w * (rx * rx + ry * ry))
    return a_mat, g, cost


def _apply_delta(h: Tensor, d: Tensor) -> Tensor:
    dh = torch.cat([d, torch.zeros((1,), dtype=d.dtype, device=d.device)])
    return h + dh.reshape(3, 3)


def gn_refine_h(h0: Tensor, src: Tensor, tar: Tensor, weights: Tensor,
                iters: int = 8) -> Tensor:
    """Weighted forward-reprojection Levenberg-Marquardt on one homography.

    Minimizes ``sum_i w_i |H(src_i) - tar_i|^2`` over the 8-parameter chart
    h22 = 1, with diagonal LM damping and branch-free accept/reject (a step
    that does not reduce the cost is discarded and the damping raised).
    Points are Hartley-normalized first so the float32 normal equations stay
    well-conditioned at pixel coordinates.

    Args:
      h0: (3, 3) initial model (any scale, finite).
      src, tar: (N, 2) correspondences.
      weights: (N,) nonnegative weights (0 excludes a point).
      iters: LM iterations.

    Returns:
      (3, 3) refined H; ``h0`` if the result is non-finite.
    """
    dt = src.dtype
    w = torch.clamp(weights.to(dt), min=0.0)
    sn, p1 = _hartley(src, w)
    tn, p2 = _hartley(tar, w)
    t1 = _t_matrix(*p1)
    t2 = _t_matrix(*p2)
    t2i = _t_inv_matrix(*p2)
    hn = t2 @ h0 @ _t_inv_matrix(*p1)
    hn = hn / hn[2, 2]
    eye = torch.eye(8, dtype=dt, device=src.device)
    lam = torch.full((), 1e-3, dtype=dt, device=src.device)

    for _ in range(iters):
        a_mat, g, cost = _forward_normal_eqs(hn, sn, tn, w)
        damped = a_mat + lam * torch.diag(torch.diag(a_mat)) + 1e-12 * eye
        # solve_ex: no singularity check, so no host sync; a singular system
        # gives non-finite steps, which the accept test rejects.
        d = torch.linalg.solve_ex(damped, -g).result
        h_new = _apply_delta(hn, d)
        _, _, cost_new = _forward_normal_eqs(h_new, sn, tn, w)
        ok = (torch.isfinite(cost_new) & (cost_new < cost)
              & torch.isfinite(h_new).all())
        hn = torch.where(ok, h_new, hn)
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-8), lam * 10.0)
    h_out = t2i @ hn @ t1
    return torch.where(torch.isfinite(h_out).all(), h_out, h0)


def anneal_polish(
    h: Tensor,
    src: Tensor,
    tar: Tensor,
    threshold: float,
    point_mask: Tensor | None = None,
    levels: tuple = (1.0, 0.7, 0.5),
    iters: int = 8,
) -> Tensor:
    """Annealed-threshold geometric polish of a selected RANSAC model.

    For each level ``m`` in ``levels``: re-derive the consensus of the current
    model at ``r2 < 2 (m * threshold)^2`` (``m * threshold`` per direction of
    the symmetric transfer error) and LM it on that set (:func:`gn_refine_h`).
    A level whose consensus falls under 8 points or under 25% of the first
    level's mass is skipped (branch-free).

    Float32 inputs that may leave eager PyTorch
    (``utils.graphs.may_leave_eager``: on the card, no gradient to record,
    no torch.func transform) run in one launch of the kernel
    ``kernels.polish_cuda.anneal_polish`` (counted by
    ``ransac.polish_kernel``); everything else runs
    :func:`_anneal_polish_eager`.
    """
    if (graphs.may_leave_eager(src, tar, h)
            and h.dtype == src.dtype == tar.dtype == torch.float32):
        count("ransac.polish_kernel")
        return polish_cuda.anneal_polish(h, src, tar, threshold, point_mask,
                                         levels, iters)
    return _anneal_polish_eager(h, src, tar, threshold, point_mask, levels,
                                iters)


def _anneal_polish_eager(h, src, tar, threshold, point_mask, levels, iters):
    """:func:`anneal_polish` in eager operations."""
    from sks_tpu_torch.robust.ransac import _residual2

    dt = src.dtype
    thr = torch.full((), threshold, dtype=dt, device=src.device)

    def consensus_mass(h, mult):
        r2 = _residual2(h[None], src, tar)[0]
        t2 = 2.0 * (torch.full_like(thr, mult) * thr) ** 2
        m = r2 < t2
        if point_mask is not None:
            m = m & point_mask
        w = m.to(dt)
        return w, torch.sum(w)

    _, n0 = consensus_mass(h, levels[0])
    n0 = torch.clamp(n0, min=1.0)

    for mult in levels:
        w, mass = consensus_mass(h, mult)
        ok = (mass >= 8.0) & (mass >= 0.25 * n0)
        h_new = gn_refine_h(h, src, tar, w, iters=iters)
        h = torch.where(ok & torch.isfinite(h_new).all(), h_new, h)
    return h
