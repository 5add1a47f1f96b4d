"""Hopper CUDA kernel for the annealed LM polish of a selected RANSAC model.

``anneal_polish`` (``csrc/polish.cu::anneal_polish_kernel``)
  Replaces no TPU kernel: the JAX package leaves
  ``sks_tpu/robust/polish.py::anneal_polish`` (its LM body ``gn_refine_h``)
  to XLA, which fuses it.  The eager polish
  (``robust/polish.py::_anneal_polish_eager``) cannot be fused: its 3 levels
  of 8 LM steps are ~4,400 launches of tiny operations, the host's time of
  almost the whole per-pair tail while the card idles.  This kernel runs the
  whole polish in one launch.  What bounds it is a chain of dependent steps,
  not bytes or flops: per level a consensus pass, two Hartley passes, one
  pass of normal equations and 8 steps of (8 x 8 solve, pass), at most 33
  block reductions and 24 solves for the default levels.  Design: one block
  of 256 threads shares every pass over the points; each thread runs the
  same solve on the reduced sums, so the LM's state never leaves its
  registers; a step's one pass at the new model sums its system and its
  cost together (the eager loop's second pass); sums in a fixed order
  without atomics, so a call gives the same bits every time.

Its plain version, :func:`anneal_polish_plain`, is its specification: the
same levels and steps written the kernel's way (the 30 sums of a pass, the
fused step, the LU with LAPACK's pivot rule, the 3 x 3 products as explicit
3-term dot products), in broadcast PyTorch.  It differs from the kernel by
the order of the sums over points only, and from the eager polish by that,
the order of the normal equations' and the 3 x 3 products' sums, and the
LU's arithmetic.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from sks_tpu_torch.geom.homography import apply_homography, inv_h
from sks_tpu_torch.kernels._soa import LAUNCHES, check_launch, device_kind
from sks_tpu_torch.ops.ndlt import _hartley, _t_inv_matrix, _t_matrix

__all__ = ["anneal_polish", "anneal_polish_plain"]

_MAX_LEVELS = 8  # csrc/polish.cu's kMaxLevels

# The 8 x 8 normal matrix from the 30 sums of a pass (csrc/polish.cu's
# note): the index of entry (i, j) into the sums, 30 for the zero block.
_QQ = ((0, 1, 2), (1, 3, 4), (2, 4, 5))


def _entry(i: int, j: int) -> int:
    i, j = min(i, j), max(i, j)
    if j < 3:
        return _QQ[i][j]
    if i < 3 and j < 6:
        return 30
    if j < 6:
        return _QQ[i - 3][j - 3]
    if i < 3:
        return 6 + 2 * i + (j - 6)
    if i < 6:
        return 12 + 2 * (i - 3) + (j - 6)
    return 18 + (i - 6) + (j - 6)


_A_INDEX = torch.tensor([_entry(i, j) for i in range(8) for j in range(8)])


def _check(h, src, tar, point_mask, levels, iters):
    """Raise on what the kernel does not take: a float32 (3, 3) model, float32
    (N, 2) points on its device, an (N,) bool mask there, 1 to 8 levels and
    iters >= 0."""
    for name, x in (("h", h), ("src", src), ("tar", tar)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {x.dtype}")
        if x.device != src.device:
            raise ValueError(f"{name} on {x.device} but src on {src.device}")
    if src.dim() != 2 or src.shape[-1] != 2 or tar.shape != src.shape:
        raise ValueError(f"src and tar must both be (N, 2); got "
                         f"{tuple(src.shape)} and {tuple(tar.shape)}")
    if tuple(h.shape) != (3, 3):
        raise ValueError(f"h must be (3, 3); got {tuple(h.shape)}")
    if point_mask is not None:
        if point_mask.dtype != torch.bool:
            raise TypeError(f"point_mask must be bool; got {point_mask.dtype}")
        if (tuple(point_mask.shape) != src.shape[:1]
                or point_mask.device != src.device):
            raise ValueError(f"point_mask must be ({src.shape[0]},) on "
                             f"{src.device}; got {tuple(point_mask.shape)} on "
                             f"{point_mask.device}")
    if not 1 <= len(levels) <= _MAX_LEVELS:
        raise ValueError(f"1 to {_MAX_LEVELS} levels; got {len(levels)}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0; got {iters}")


def _mul3(a: Tensor, b: Tensor) -> Tensor:
    """a @ b for 3 x 3 matrices, each entry a 3-term dot product summed left
    to right."""
    p = a[:, :, None] * b[None, :, :]
    return p[:, 0] + p[:, 1] + p[:, 2]


def _system(h: Tensor, sn: Tensor, tn: Tensor, w: Tensor) -> Tensor:
    """The 30 sums of one LM pass at ``h`` over the normalized points, (30,)."""
    x, y = sn[:, 0], sn[:, 1]
    px = h[0, 0] * x + h[0, 1] * y + h[0, 2]
    py = h[1, 0] * x + h[1, 1] * y + h[1, 2]
    pz = h[2, 0] * x + h[2, 1] * y + h[2, 2]
    iz = 1.0 / pz
    rx = px * iz - tn[:, 0]
    ry = py * iz - tn[:, 1]
    q = (x * iz, y * iz, iz)
    ex, fx = -px * x * iz * iz, -px * y * iz * iz
    ey, fy = -py * x * iz * iz, -py * y * iz * iz
    wq = [w * v for v in q]
    wex, wfx, wey, wfy = w * ex, w * fx, w * ey, w * fy
    wrx, wry = w * rx, w * ry
    terms = [wq[0] * q[0], wq[0] * q[1], wq[0] * q[2], wq[1] * q[1],
             wq[1] * q[2], wq[2] * q[2]]
    terms += [t for i in range(3) for t in (wq[i] * ex, wq[i] * fx)]
    terms += [t for i in range(3) for t in (wq[i] * ey, wq[i] * fy)]
    terms += [wex * ex + wey * ey, wex * fx + wey * fy, wfx * fx + wfy * fy]
    terms += [v * wrx for v in q] + [v * wry for v in q]
    terms += [ex * wrx + ey * wry, fx * wrx + fy * wry,
              w * (rx * rx + ry * ry)]
    return torch.stack(terms).sum(dim=-1)


def _solve(s: Tensor, lam: Tensor) -> Tensor:
    """solve(A + lam diag(A) + 1e-12 I, -g) from the sums ``s`` by LU with
    partial pivoting, the kernel's: the pivot of column k is the first row
    r >= k of largest |a_rk| (strict >, so a NaN past row k is never taken),
    rows k and p swap, each row below subtracts a_rk / a_kk times row k, then
    back substitution, each row's sum left to right.  Returns (8,)."""
    a = torch.cat([s, s.new_zeros(1)])[_A_INDEX.to(s.device)].reshape(8, 8)
    diag = torch.diagonal(a)
    eye = torch.eye(8, dtype=torch.bool, device=s.device)
    a = torch.where(eye, torch.diag_embed((diag + lam * diag) + 1e-12), a)
    m = torch.cat([a, -s[21:29, None]], dim=1)
    rows = torch.arange(8, device=s.device)
    for k in range(8):
        col = torch.abs(m[k:, k])
        p, best = torch.zeros_like(rows[0]), col[0]
        for r in range(1, 8 - k):
            take = col[r] > best
            best = torch.where(take, col[r], best)
            p = torch.where(take, r, p)
        p = p + k
        m = m[torch.where(rows == k, p, torch.where(rows == p, k, rows))]
        lk = m[k + 1:, k] / m[k, k]
        m = torch.cat([m[:k + 1], torch.cat(
            [m[k + 1:, :k + 1], m[k + 1:, k + 1:] - lk[:, None] * m[k, k + 1:]],
            dim=1)])
    d = [None] * 8
    for i in range(7, -1, -1):
        t = m[i, 8]
        for j in range(i + 1, 8):
            t = t - m[i, j] * d[j]
        d[i] = t / m[i, i]
    return torch.stack(d)


def _lm(h: Tensor, src: Tensor, tar: Tensor, w: Tensor, iters: int) -> Tensor:
    """``robust.polish.gn_refine_h`` the kernel's way: one pass a step."""
    sn, p1 = _hartley(src, w)
    tn, p2 = _hartley(tar, w)
    hn = _mul3(_mul3(_t_matrix(*p2), h), _t_inv_matrix(*p1))
    hn = hn / hn[2, 2]
    lam = torch.full((), 1e-3, dtype=torch.float32, device=src.device)
    s = _system(hn, sn, tn, w)
    for _ in range(iters):
        d = _solve(s, lam)
        h_new = hn + torch.cat([d, d.new_zeros(1)]).reshape(3, 3)
        s_new = _system(h_new, sn, tn, w)
        ok = (torch.isfinite(s_new[-1]) & (s_new[-1] < s[-1])
              & torch.isfinite(h_new).all())
        hn = torch.where(ok, h_new, hn)
        s = torch.where(ok, s_new, s)
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-8), lam * 10.0)
    h_out = _mul3(_mul3(_t_inv_matrix(*p2), hn), _t_matrix(*p1))
    return torch.where(torch.isfinite(h_out).all(), h_out, h)


def anneal_polish_plain(h: Tensor, src: Tensor, tar: Tensor,
                        threshold: float, point_mask: Tensor | None,
                        levels: tuple, iters: int) -> Tensor:
    """The kernel's plain version (arguments and result as
    :func:`anneal_polish`)."""
    _check(h, src, tar, point_mask, levels, iters)
    thr = torch.full((), threshold, dtype=torch.float32, device=src.device)
    n0 = None
    for mult in levels:
        d1 = apply_homography(h, src) - tar
        d2 = apply_homography(inv_h(h), tar) - src
        r2 = torch.sum(d1 * d1, dim=-1) + torch.sum(d2 * d2, dim=-1)
        m = r2 < 2.0 * (torch.full_like(thr, mult) * thr) ** 2
        if point_mask is not None:
            m = m & point_mask
        w = m.to(torch.float32)
        mass = torch.sum(w)
        if n0 is None:
            n0 = torch.clamp(mass, min=1.0)
        ok = (mass >= 8.0) & (mass >= 0.25 * n0)
        h_new = _lm(h, src, tar, w, iters)
        h = torch.where(ok & torch.isfinite(h_new).all(), h_new, h)
    return h


def anneal_polish(h: Tensor, src: Tensor, tar: Tensor, threshold: float,
                  point_mask: Tensor | None, levels: tuple,
                  iters: int) -> Tensor:
    """The annealed LM polish of one model (``robust.polish.anneal_polish``)
    in one launch of the kernel on CUDA tensors; the plain version on CPU
    tensors.

    Args:
      h: (3, 3) float32 model (any scale).
      src, tar: (N, 2) float32 correspondences.
      threshold: inlier threshold in pixels; level m's consensus is
        ``r2 < 2 (m threshold)^2`` on the symmetric transfer error.
      point_mask: optional (N,) bool validity.
      levels: 1 to 8 threshold multipliers, in order.
      iters: LM steps a level.

    Returns:
      (3, 3) float32: the polished model, or ``h`` where every level was
      skipped (consensus under 8 points or 25% of the first level's) or its
      refit non-finite.
    """
    _check(h, src, tar, point_mask, levels, iters)
    if device_kind(src) == "cpu":
        return anneal_polish_plain(h, src, tar, threshold, point_mask, levels,
                                   iters)
    from sks_tpu_torch.kernels._build import load_library

    hc = h.contiguous()
    src, tar = src.contiguous(), tar.contiguous()
    pm = None if point_mask is None else point_mask.contiguous()
    out = torch.empty_like(hc)
    wbuf = torch.empty(src.shape[0], dtype=torch.uint8, device=src.device)
    mults = (ctypes.c_float * len(levels))(*levels)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = load_library().sks_anneal_polish_f32(
            hc.data_ptr(), src.data_ptr(), tar.data_ptr(),
            None if pm is None else pm.data_ptr(), wbuf.data_ptr(),
            out.data_ptr(), src.shape[0], float(threshold), mults,
            len(levels), iters, stream)
    check_launch(err, "anneal_polish")
    LAUNCHES["anneal_polish"] += 1
    return out
