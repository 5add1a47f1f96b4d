"""Hopper CUDA kernel for the scoring of a chunk of solved hypotheses.

``score_h`` (``csrc/score.cu::score_h_kernel``)
  Replaces no TPU kernel: the JAX package leaves
  ``sks_tpu/robust/ransac.py::score_hypotheses`` to XLA, which fuses its
  (B, N) passes.  Eager PyTorch cannot: in the adaptive loop's eager chunks
  (``robust/ransac.py::_eval_chunk_eager``), up to 131,072 hypotheses
  against 2,000 points, each of its ~25 operations wrote or read a (B, N)
  tensor (1.05 GB in float32), so the scoring was most of a chunk's device
  time and all of its memory.  This kernel scores every H of a chunk in one
  launch and writes only the (B,) scores.  Bound by float32 instruction
  rate, as K2's scoring (``kernels/aca_cuda.py``): per (hypothesis, point)
  pair 2 IEEE divisions and ~40 separately rounded flops, against 20 B of
  shared point data.  So the design is K2's: a block of 32 hypotheses (a
  lane each, H and its adjugate in registers) by 8 warps that take
  different slices of the points, staged in shared memory and read as
  broadcasts, four points a step; point chunks on a second grid axis only
  where B alone does not fill the card (``aca_cuda.score_grid``); sums in a
  fixed order without atomics, so the same call gives the same bits every
  time.

Its plain version, :func:`score_h_plain`, is its specification: the gains of
``score_hypotheses`` written the kernel's way (each gated on its comparison,
the mask as a weight), in broadcast PyTorch.  The kernel differs from it,
and from ``score_hypotheses``, by the order of the sum over points only:
'inliers' counts not at all.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from sks_tpu_torch.geom.homography import symmetric_transfer_error
from sks_tpu_torch.kernels._soa import LAUNCHES, check_launch, device_kind

__all__ = ["SCORINGS", "score_h", "score_h_plain"]

#: The scorings the kernel takes, by their code in ``csrc/score.cu``.
SCORINGS = {"inliers": 0, "msac": 1, "magsac": 2}


def _check(h, src, tar, point_mask, scoring, sigma_max, magsac_k):
    """Raise on what the kernel does not take: float32 hypotheses (B, 3, 3)
    and points (N, 2) on one device, an (N,) mask there, a scoring of
    ``SCORINGS``, and ``sigma_max`` and ``magsac_k`` for 'magsac'."""
    for name, x in (("h", h), ("src", src), ("tar", tar)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {x.dtype}")
        if x.device != src.device:
            raise ValueError(f"{name} on {x.device} but src on {src.device}")
    if src.dim() != 2 or src.shape[-1] != 2 or tar.shape != src.shape:
        raise ValueError(f"src and tar must both be (N, 2); got "
                         f"{tuple(src.shape)} and {tuple(tar.shape)}")
    if h.dim() != 3 or tuple(h.shape[-2:]) != (3, 3):
        raise ValueError(f"h must be (B, 3, 3); got {tuple(h.shape)}")
    if point_mask is not None and (tuple(point_mask.shape) != src.shape[:1]
                                   or point_mask.device != src.device):
        raise ValueError(f"point_mask must be ({src.shape[0]},) on "
                         f"{src.device}; got {tuple(point_mask.shape)} on "
                         f"{point_mask.device}")
    if scoring not in SCORINGS:
        raise ValueError(f"scoring must be one of {tuple(SCORINGS)}, got "
                         f"{scoring!r}")
    if scoring == "magsac" and (sigma_max is None or magsac_k is None):
        raise ValueError("MAGSAC++ scores need sigma_max and magsac_k")


def _constants(threshold, scoring, sigma_max, magsac_k):
    """(t2, ks, gate) rounded to float32 as ``score_hypotheses``' 0-d
    tensors are: ``threshold^2``; ``magsac_k * sigma_max`` (a float32
    product of the two rounded); ``4 ks^2``, past which a MAGSAC++ weight
    is 0 in any rounding."""
    f32 = np.float32
    t2 = f32(threshold * threshold)
    if scoring != "magsac":
        return float(t2), 0.0, 0.0
    ks = f32(magsac_k) * f32(sigma_max)
    return float(t2), float(ks), float(f32(4.0) * ks * ks)


def score_h_plain(h: Tensor, src: Tensor, tar: Tensor, threshold: float,
                  point_mask: Tensor | None = None, scoring: str = "inliers",
                  *, sigma_max: float | None = None,
                  magsac_k: float | None = None) -> Tensor:
    """The kernel's plain version (arguments and result as
    :func:`score_h`)."""
    _check(h, src, tar, point_mask, scoring, sigma_max, magsac_k)
    t2, ks, gate = (torch.full((), v, dtype=torch.float32, device=src.device)
                    for v in _constants(threshold, scoring, sigma_max,
                                        magsac_k))
    r2 = symmetric_transfer_error(h, src, tar)  # (B, N)
    zero = torch.zeros((), dtype=torch.float32, device=src.device)
    if scoring == "inliers":
        g = (r2 < t2).to(torch.float32)
    elif scoring == "msac":
        g = torch.where(r2 < t2, torch.clamp(1.0 - r2 / t2, min=0.0), zero)
    else:
        v = torch.clamp(1.0 - torch.sqrt(r2) / ks, min=0.0)
        g = torch.where(r2 < gate, v * v, zero)
    if point_mask is not None:
        g = g * point_mask.to(torch.float32)
    finite = torch.isfinite(h).flatten(-2).all(-1)
    return torch.where(finite, torch.sum(g, dim=-1), -torch.ones_like(zero))


def score_h(h: Tensor, src: Tensor, tar: Tensor, threshold: float,
            point_mask: Tensor | None = None, scoring: str = "inliers", *,
            sigma_max: float | None = None,
            magsac_k: float | None = None) -> Tensor:
    """``robust.ransac.score_hypotheses``' scores of B hypotheses, in one
    launch of the kernel on CUDA tensors; the plain version on CPU tensors.

    Args:
      h: (B, 3, 3) float32 hypotheses (any scale).
      src, tar: (N, 2) float32 correspondences.
      threshold: inlier threshold in pixels (symmetric transfer).
      point_mask: optional (N,) validity (bool, or 0/1).
      scoring: 'inliers' counts ``r2 < threshold^2``; 'msac' sums
        ``max(1 - r2 / threshold^2, 0)``; 'magsac' sums
        ``clamp(1 - sqrt(r2) / (magsac_k * sigma_max), 0, 1)^2``.
      sigma_max, magsac_k: MAGSAC++'s noise scale and radius factor.

    Returns:
      (B,) float32 scores, -1 where H has a non-finite entry.  On CUDA the
      sum over points runs in a fixed order set by (B, N) alone: bit-equal
      from call to call, equal to ``score_hypotheses`` for 'inliers', and
      within the rounding of another summation order otherwise.
    """
    _check(h, src, tar, point_mask, scoring, sigma_max, magsac_k)
    if device_kind(src) == "cpu":
        return score_h_plain(h, src, tar, threshold, point_mask, scoring,
                             sigma_max=sigma_max, magsac_k=magsac_k)
    from sks_tpu_torch.kernels._build import load_library
    from sks_tpu_torch.kernels.aca_cuda import score_grid

    b, n = h.shape[0], src.shape[0]
    out = torch.empty(b, dtype=torch.float32, device=src.device)
    if b == 0:
        return out
    hc, src, tar = h.contiguous(), src.contiguous(), tar.contiguous()
    pm = None if point_mask is None else (
        point_mask.to(torch.float32).contiguous())
    _, chunks, chunk_points = score_grid(1, b, n)
    scratch = out if chunks == 1 else torch.empty(
        (chunks, b), dtype=torch.float32, device=src.device)
    t2, ks, gate = _constants(threshold, scoring, sigma_max, magsac_k)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = load_library().sks_score_h_f32(
            hc.data_ptr(), src.data_ptr(), tar.data_ptr(),
            None if pm is None else pm.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, n, chunks, chunk_points, SCORINGS[scoring],
            t2, ks, gate, stream)
    check_launch(err, "score_h")
    LAUNCHES["score_h"] += 1
    return out
