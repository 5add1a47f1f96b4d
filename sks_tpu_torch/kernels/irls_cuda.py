"""Hopper CUDA kernel for the IRLS refit of RANSAC's top-K candidates.

``irls_refine`` (``csrc/irls.cu::irls_refine_kernel``)
  Replaces no TPU kernel: the JAX package leaves
  ``sks_tpu/robust/ransac.py::_irls_refine`` to XLA, which fuses it.  The
  eager refit (``robust/ransac.py::_irls_refine_eager``) cannot be fused:
  each round's weighted NDLT and 9 x 9 Jacobi is ~12,100 launches of tiny
  operations, so the refit held the host for ~80% of a fit while the card
  idled.  This kernel runs every round for every candidate in one launch.
  What bounds it is a latency chain, not bytes or flops: a round's
  eigenvector is 288 dependent rotations of a 9 x 9 matrix, and the rounds
  follow one another.  Design: one block of 256 threads per candidate (the
  K chains run side by side), the block's warps share the three passes over
  the points, one warp runs the rotations; sums in a fixed order without
  atomics, so a call gives the same bits every time.

Its plain version, :func:`irls_refine_plain`, is its specification: the same
rounds written the kernel's way (the 24 block sums of ``ndlt_core``'s
normal matrix, ``linalg.jacobi_smallest_col_core``, the denormalization as
explicit 3-term dot products), in broadcast PyTorch.  It differs from the
kernel by the order of the sums over points only, and from the eager refit
by that and the order of the normal matrix's and the 3 x 3 products' sums.
"""

from __future__ import annotations

import torch
from torch import Tensor

from sks_tpu_torch.geom.homography import apply_homography, inv_h
from sks_tpu_torch.kernels._soa import LAUNCHES, check_launch, device_kind
from sks_tpu_torch.ops.linalg import jacobi_smallest_col_core

__all__ = ["irls_refine", "irls_refine_plain"]

_TINY = torch.finfo(torch.float32).tiny
_SWEEPS = 8  # linalg.jacobi_eigh's default, which ndlt_h runs


def _scale(iters: int, t: int) -> float:
    """The GNC schedule: 2^(iters-2-t) capped to [1, 4] (e.g. 4, 2, 1, 1)."""
    return min(max(2.0 ** (iters - 2 - t), 1.0), 4.0)


def _check(h0, src, tar, point_mask, iters, magsac_k, sigma_max):
    """Raise on what the kernel does not take: float32 points (N, 2) and
    candidates (..., 3, 3) on one device, an (N,) mask, iters >= 0, and a
    sigma_max with magsac_k."""
    for name, x in (("h0", h0), ("src", src), ("tar", tar)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {x.dtype}")
        if x.device != src.device:
            raise ValueError(f"{name} on {x.device} but src on {src.device}")
    if src.dim() != 2 or src.shape[-1] != 2 or tar.shape != src.shape:
        raise ValueError(f"src and tar must both be (N, 2); got "
                         f"{tuple(src.shape)} and {tuple(tar.shape)}")
    if h0.dim() < 2 or tuple(h0.shape[-2:]) != (3, 3):
        raise ValueError(f"h0 must be (..., 3, 3); got {tuple(h0.shape)}")
    if point_mask is not None and (tuple(point_mask.shape) != src.shape[:1]
                                   or point_mask.device != src.device):
        raise ValueError(f"point_mask must be ({src.shape[0]},) on "
                         f"{src.device}; got {tuple(point_mask.shape)} on "
                         f"{point_mask.device}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0; got {iters}")
    if magsac_k is not None and sigma_max is None:
        raise ValueError("MAGSAC++ weights need sigma_max")


def _ppt(om, nx, ny):
    """The 6 weighted sums of p p^T over the points, p = (x, y, 1):
    ``ndlt_core``'s ``wsum_ppt`` (xx, xy, x, yy, y, 1)."""
    wx, wy = om * nx, om * ny
    return [torch.sum(v, dim=-1)
            for v in (wx * nx, wx * ny, wx, wy * ny, wy, om)]


def irls_refine_plain(h0: Tensor, src: Tensor, tar: Tensor, iters: int,
                      threshold: float, point_mask: Tensor | None = None,
                      *, magsac_k: float | None = None,
                      sigma_max: float | None = None) -> Tensor:
    """The kernel's plain version (arguments and result as
    :func:`irls_refine`)."""
    _check(h0, src, tar, point_mask, iters, magsac_k, sigma_max)

    def f32(v):
        return torch.full((), v, dtype=torch.float32, device=src.device)

    h = h0.reshape(-1, 3, 3)
    x, y, xp, yp = src[:, 0], src[:, 1], tar[:, 0], tar[:, 1]
    pm = None if point_mask is None else point_mask.to(torch.float32)
    for t in range(iters):
        scale = _scale(iters, t)
        # The symmetric transfer error through the adjugate, (K, N).
        d1 = apply_homography(h, src) - tar
        d2 = apply_homography(inv_h(h), tar) - src
        r2 = torch.sum(d1 * d1, dim=-1) + torch.sum(d2 * d2, dim=-1)
        if magsac_k is None:
            thr = f32(threshold) * scale
            w = (r2 < thr * thr).to(torch.float32)
        else:
            ks = f32(magsac_k) * (f32(sigma_max) * scale)
            g = torch.clamp(1.0 - torch.sqrt(torch.clamp(r2, min=0.0)) / ks,
                            0.0, 1.0)
            w = torch.where(torch.isfinite(r2), g * g, torch.zeros_like(g))
        if pm is not None:
            w = w * pm
        wsum = torch.sum(w, dim=-1)
        cx1, cy1, cx2, cy2 = (torch.sum(v * w, dim=-1) / wsum
                              for v in (x, y, xp, yp))
        sx1, sy1, sx2, sy2 = (
            1.0 / torch.clamp(torch.sum(torch.abs(v - c[:, None]) * w, dim=-1)
                              / wsum, min=_TINY)
            for v, c in ((x, cx1), (y, cy1), (xp, cx2), (yp, cy2)))
        nx, ny, tx, ty = ((v - c[:, None]) * sc[:, None] for v, c, sc in (
            (x, cx1, sx1), (y, cy1, sy1), (xp, cx2, sx2), (yp, cy2, sy2)))
        s1, sx, sy, sd = (_ppt(om, nx, ny) for om in (
            w, w * -tx, w * -ty, w * (tx * tx + ty * ty)))

        def block(e):
            xx, xy, x_, yy, y_, o = e
            return [[xx, xy, x_], [xy, yy, y_], [x_, y_, o]]

        z = torch.zeros_like(wsum)
        zb = [[z] * 3 for _ in range(3)]
        b1, bx, by, bd = block(s1), block(sx), block(sy), block(sd)
        ltl = ([[*b1[r], *zb[r], *bx[r]] for r in range(3)]
               + [[*zb[r], *b1[r], *by[r]] for r in range(3)]
               + [[*bx[r], *by[r], *bd[r]] for r in range(3)])
        hn = jacobi_smallest_col_core(ltl, sweeps=_SWEEPS)
        # H = T2^-1 Hn T1 (ndlt._t_inv_matrix, ndlt._t_matrix), T2^-1 Hn
        # first; each entry a 3-term dot product summed left to right.
        one = torch.ones_like(wsum)
        t2inv = [[1.0 / sx2, z, cx2], [z, 1.0 / sy2, cy2], [z, z, one]]
        t1 = [[sx1, z, -sx1 * cx1], [z, sy1, -sy1 * cy1], [z, z, one]]
        hm = [hn[0:3], hn[3:6], hn[6:9]]
        mid = [[t2inv[r][0] * hm[0][c] + t2inv[r][1] * hm[1][c]
                + t2inv[r][2] * hm[2][c] for c in range(3)] for r in range(3)]
        h_new = [mid[r][0] * t1[0][c] + mid[r][1] * t1[1][c]
                 + mid[r][2] * t1[2][c] for r in range(3) for c in range(3)]
        h_new = torch.stack(h_new, dim=-1).reshape(-1, 3, 3)
        ok = torch.isfinite(h_new).flatten(1).all(1) & (wsum >= 4)
        h = torch.where(ok[:, None, None], h_new, h)
    return h.reshape(h0.shape)


def irls_refine(h0: Tensor, src: Tensor, tar: Tensor, iters: int,
                threshold: float, point_mask: Tensor | None = None, *,
                magsac_k: float | None = None,
                sigma_max: float | None = None) -> Tensor:
    """``iters`` rounds of the annealed IRLS NDLT refit of every candidate
    (``robust.ransac._irls_refine``), in one launch of the kernel on CUDA
    tensors; the plain version on CPU tensors.

    Args:
      h0: (..., 3, 3) float32 candidates, refitted independently.
      src, tar: (N, 2) float32 correspondences.
      iters: rounds; round t scales the threshold by 2^(iters-2-t) capped
        to [1, 4].
      threshold: inlier threshold in pixels: hard weights
        ``r2 < (threshold * scale)^2`` on the symmetric transfer error.
      point_mask: optional (N,) validity (any dtype; multiplies the weights).
      magsac_k, sigma_max: with ``magsac_k``, MAGSAC++ weights
        ``(1 - r / (magsac_k * sigma_max * scale))^2`` in place of the hard
        ones (``robust.ransac.magsac_weights``).

    Returns:
      (..., 3, 3) float32: each refit, or the previous model where a round's
      refit is non-finite or has under 4 points of weight mass.
    """
    _check(h0, src, tar, point_mask, iters, magsac_k, sigma_max)
    if device_kind(src) == "cpu":
        return irls_refine_plain(h0, src, tar, iters, threshold, point_mask,
                                 magsac_k=magsac_k, sigma_max=sigma_max)
    from sks_tpu_torch.kernels._build import load_library

    h0c = h0.contiguous()
    out = torch.empty_like(h0c)
    k = h0c.numel() // 9
    if k == 0:
        return out
    src, tar = src.contiguous(), tar.contiguous()
    pm = None if point_mask is None else (
        point_mask.to(torch.float32).contiguous())
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = load_library().sks_irls_refine_f32(
            h0c.data_ptr(), src.data_ptr(), tar.data_ptr(),
            None if pm is None else pm.data_ptr(), out.data_ptr(), k,
            src.shape[0], iters, float(threshold), int(magsac_k is not None),
            float(sigma_max or 0.0), float(magsac_k or 0.0), stream)
    check_launch(err, "irls_refine")
    LAUNCHES["irls_refine"] += 1
    return out
