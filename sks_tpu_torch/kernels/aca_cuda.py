"""Hopper CUDA kernels for ACA: batched solve (K1) and fused solve+score (K2).

Each kernel sits beside its plain PyTorch version.  A wrapper runs the plain
version only for tensors on the CPU; for a CUDA tensor it launches the kernel
or raises.  ``LAUNCHES`` (shared by every kernel, ``kernels._soa``) counts
kernel launches (plain runs are not counted), so a run can show that its path
went through the kernels.

K1 ``aca_solve_soa`` (``csrc/aca.cu::AcaCore`` in ``soa.cuh::solve_soa_kernel``)
  Replaces ``sks_tpu/kernels/aca_pallas.py::aca_solve_soa`` (body
  ``_solve_kernel``).  Bound by device-memory bytes: 16 values in and 9 out
  per hypothesis (100 B in float32, 50 B in bfloat16 storage) for 97 flops.
  Design: one thread per hypothesis on the component-major ``(8, B)`` layout,
  so each of the 25 accesses is fully coalesced; bfloat16 storage halves the
  bytes while the arithmetic stays float32.

K2 ``aca_solve_score_soa`` (``csrc/aca.cu::aca_solve_score_kernel``)
  Replaces ``sks_tpu/kernels/aca_pallas.py::aca_solve_score_soa`` (body
  ``_solve_score_kernel``) and the ``jax.vmap`` over pairs that the JAX
  pipeline wraps around it.  Bound by float32 instruction rate: per
  (hypothesis, point) pair, 2 IEEE divisions and ~38 separately rounded
  flops, while almost no bytes move.  So the design is warps in flight and
  independent work per warp.  A launch covers (hypothesis block, point
  chunk, pair): the TPU kernel's sequential point-block grid axis becomes
  parallel chunks and its vmap becomes a grid axis.  A block is 32
  hypotheses (the lanes of a warp, which read one staged point from shared
  memory as a broadcast) by 8 warps that take different slices of the
  chunk's points; every thread recomputes the 97-flop solve for its slice
  and runs its point loop four points at a time.  :func:`score_grid` picks
  the chunk count from the shapes: 2,048 hypotheses against 2,000 points
  launch 7 chunks, 448 blocks of 8 warps (27 warps on each of an H100's 132
  SMs); 65,536 hypotheses launch a single chunk.  Sums run in a fixed order
  (points in a slice, slices through shared memory, chunks through a scratch
  tensor): no atomics, so the same call gives the same bits every time; and
  the order does not depend on the number of pairs, so a launch over P pairs
  gives each pair the bits that a launch of its own gives it.

Layout: the TPU's ``(8, M, 128)`` lane-tiled SoA becomes plain ``(8, B)``
(component k of hypothesis i at ``[k, i]``), with no padding of B.
"""

from __future__ import annotations

import torch
from torch import Tensor

from sks_tpu_torch.kernels._soa import (
    LAUNCHES,
    check_launch,
    check_storage,
    device_kind,
    from_soa_h,
    solve_soa,
    solve_soa_plain,
    to_soa,
)
from sks_tpu_torch.ops.aca import aca_core

__all__ = [
    "LAUNCHES",
    "aca_solve_soa",
    "aca_solve_soa_plain",
    "aca_solve_score_soa",
    "aca_solve_score_soa_plain",
    "aca_h_cuda",
    "score_grid",
    "to_soa",
    "from_soa_h",
]

_SCORING = {"inliers": 0, "msac": 1, "magsac": 2}


def aca_solve_soa_plain(src: Tensor, tar: Tensor) -> Tensor:
    """Plain version of K1: :func:`aca_core` on the 8 component rows, in f32."""
    return solve_soa_plain(aca_core, src, tar)


def aca_solve_soa(src: Tensor, tar: Tensor) -> Tensor:
    """Batched division-free ACA on component-major minimal sets (K1).

    Args:
      src, tar: (8, B) contiguous, float32 or bfloat16 (see :func:`to_soa`).

    Returns:
      (9, B) up-to-scale homographies in the input dtype, computed in f32.
    """
    return solve_soa("aca_solve", aca_core, src, tar)


def aca_h_cuda(src: Tensor, tar: Tensor) -> Tensor:
    """(B, 4, 2) convenience wrapper of K1: AoS -> SoA -> solve -> AoS.

    The counterpart of ``sks_tpu.kernels.aca_pallas.aca_h_pallas``; the layout
    shuffle costs one extra round trip through device memory.
    """
    return from_soa_h(aca_solve_soa(to_soa(src), to_soa(tar)))


#: What :func:`score_grid` assumes of the card and of the kernel
#: (``csrc/aca.cu``): an H100's SMs, a block of 32 hypotheses by 8 warps.
_SMS = 132
_SCORE_LANES = 32
_SCORE_SLICES = 8
#: Blocks per SM to aim for when B alone does not reach them: three rounds of
#: the 4 blocks an SM holds at the kernel's 64 registers, so that the last
#: round's ragged end is a small share of the launch.
_BLOCKS_PER_SM = 12
#: Fewest points a warp's slice should hold, so that the solve each thread
#: recomputes (~125 flops) stays noise beside its point loop.
_MIN_SLICE = 32
_MAX_GRID_Y = 65535


def score_grid(pairs: int, b: int, n: int) -> tuple[int, int, int]:
    """The K2 launch for ``pairs`` x ``b`` hypotheses against ``n`` points:
    ``(hypothesis blocks, chunks, chunk_points)``, which are grid x, grid y
    and the points per chunk (grid z is ``pairs``; a count over 65,535 is
    refused by the launch).

    Chunk c scores points ``[c * chunk_points, min(n, (c + 1) *
    chunk_points))``: the chunks are non-empty and disjoint and cover every
    point once.  A chunk is added only while one pair's blocks are fewer
    than ``_BLOCKS_PER_SM`` per SM and every warp keeps ``_MIN_SLICE``
    points.  ``pairs`` takes no part in the choice: the chunks fix the order
    in which a score is summed, and a pair must get the same bits from a
    launch of its own and from a launch it shares (a batched fit equals the
    single fits in every scoring).  Pairs only multiply the blocks.
    """
    hyp_blocks = -(-b // _SCORE_LANES)
    fill = -(-_BLOCKS_PER_SM * _SMS // max(1, hyp_blocks))
    chunks = max(1, min(fill, n // (_SCORE_SLICES * _MIN_SLICE), _MAX_GRID_Y))
    chunk_points = max(1, -(-n // chunks))
    return hyp_blocks, max(1, -(-n // chunk_points)), chunk_points


def _score_inputs(src, tar, pts, point_weights, scoring):
    """Check K2's arguments: (8, B), (4, N) and (N,), or all three with one
    leading pair axis P.  Returns the weights (ones where None)."""
    if src.dim() not in (2, 3):
        raise ValueError("src and tar must be (8, B) or (P, 8, B); got "
                         f"{tuple(src.shape)}")
    lead = tuple(src.shape[:-2])
    if src.shape[-2] != 8 or src.shape != tar.shape:
        raise ValueError(
            f"src and tar must both be {(*lead, 8, 'B')}; got "
            f"{tuple(src.shape)} and {tuple(tar.shape)}")
    check_storage(src, tar)
    if scoring not in _SCORING:
        raise ValueError(f"scoring must be one of {tuple(_SCORING)}, got "
                         f"{scoring!r}")
    if pts.dim() != len(lead) + 2 or tuple(pts.shape[:-1]) != (*lead, 4):
        raise ValueError(f"pts must be {(*lead, 4, 'N')}; got "
                         f"{tuple(pts.shape)}")
    n = pts.shape[-1]
    if point_weights is None:
        point_weights = torch.ones((*lead, n), dtype=torch.float32,
                                   device=pts.device)
    if tuple(point_weights.shape) != (*lead, n):
        raise ValueError(f"point_weights must be {(*lead, n)}; got "
                         f"{tuple(point_weights.shape)}")
    for name, x in (("pts", pts), ("point_weights", point_weights)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {x.dtype}")
        if x.device != src.device:
            raise ValueError(f"{name} on {x.device} but src on {src.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return point_weights


def aca_solve_score_soa_plain(src: Tensor, tar: Tensor, pts: Tensor,
                              threshold: float, point_weights: Tensor,
                              scoring: str) -> Tensor:
    """Plain version of K2: broadcast (..., B, N) arithmetic in the kernel's
    order, with or without the leading pair axis.

    Follows the kernel's own forward and reverse transfer, with
    ``finite = (w != 0) & (wr != 0)`` (not ``score_hypotheses``'s rule).
    """
    s = [src[..., k, :].float() for k in range(8)]
    t = [tar[..., k, :].float() for k in range(8)]
    h00, h01, h02, h10, h11, h12, h20, h21, h22 = (
        v[..., None] for v in aca_core(*s, *t)
    )
    i00 = h11 * h22 - h12 * h21
    i01 = h02 * h21 - h01 * h22
    i02 = h01 * h12 - h02 * h11
    i10 = h12 * h20 - h10 * h22
    i11 = h00 * h22 - h02 * h20
    i12 = h02 * h10 - h00 * h12
    i20 = h10 * h21 - h11 * h20
    i21 = h01 * h20 - h00 * h21
    i22 = h00 * h11 - h01 * h10

    x, y, xp, yp = (pts[..., k, None, :] for k in range(4))
    t2 = torch.full((), threshold, dtype=torch.float32, device=pts.device)
    w = h20 * x + h21 * y + h22
    inv_w = 1.0 / w
    dx = (h00 * x + h01 * y + h02) * inv_w - xp
    dy = (h10 * x + h11 * y + h12) * inv_w - yp
    r2 = dx * dx + dy * dy
    wr = i20 * xp + i21 * yp + i22
    inv_wr = 1.0 / wr
    dxr = (i00 * xp + i01 * yp + i02) * inv_wr - x
    dyr = (i10 * xp + i11 * yp + i12) * inv_wr - y
    r2 = r2 + dxr * dxr + dyr * dyr
    finite = (w != 0.0) & (wr != 0.0)
    inl = r2 < t2
    zero = torch.zeros((), dtype=torch.float32, device=pts.device)
    if scoring == "inliers":
        gain = inl.float()
    elif scoring == "msac":
        gain = torch.where(inl, 1.0 - r2 / t2, zero)
    else:  # magsac: t2 carries (k * sigma_max)^2
        g = 1.0 - torch.sqrt(torch.clamp(r2, min=0.0) / t2)
        gain = torch.where(inl, g * g, zero)
    return torch.sum(torch.where(finite, gain, zero)
                     * point_weights[..., None, :], dim=-1)


def aca_solve_score_soa(
    src: Tensor, tar: Tensor, pts: Tensor, threshold: float,
    point_weights: Tensor | None = None, scoring: str = "inliers",
) -> Tensor:
    """Fused ACA solve + symmetric-transfer RANSAC scoring (K2).

    Every hypothesis is solved and scored against all N correspondences of
    its pair; only the 4-byte score per hypothesis (and per point chunk,
    see :func:`score_grid`) reaches device memory.  One launch scores every
    pair of a leading pair axis, as ``jax.vmap`` of the TPU kernel does.

    Args:
      src, tar: (8, B) or (P, 8, B) contiguous minimal sets, float32 or
        bfloat16.
      pts: (4, N) or (P, 4, N) contiguous float32 rows [x, y, x', y'].
      threshold: squared threshold, a Python float, one for all pairs.
        'inliers' counts ``r2_fwd + r2_bwd < threshold``; 'msac' sums
        ``1 - r2/threshold`` over those; 'magsac' sums
        ``(1 - sqrt(r2/threshold))^2`` with ``threshold = (k * sigma_max)^2``.
      point_weights: optional (N,) or (P, N) float32 gain multipliers (0
        drops a point).
      scoring: 'inliers', 'msac' or 'magsac'.

    Returns:
      (B,) or (P, B) float32 scores.  On CUDA the sum over points runs in a
      fixed order set by (B, N) alone: bit-equal from call to call and
      between a launch over P pairs and P launches of one, equal to the
      plain version for 'inliers' with 0/1 weights, and within
      summation-order rounding of it otherwise (measured relative gaps are
      in PERF.md).
    """
    point_weights = _score_inputs(src, tar, pts, point_weights, scoring)
    t2 = float(threshold)
    if device_kind(src) == "cpu":
        return aca_solve_score_soa_plain(src, tar, pts, t2, point_weights,
                                         scoring)
    from sks_tpu_torch.kernels._build import load_library

    lib = load_library()
    pairs = src.shape[0] if src.dim() == 3 else 1
    b, n = src.shape[-1], pts.shape[-1]
    out = torch.empty((*src.shape[:-2], b), dtype=torch.float32,
                      device=src.device)
    if out.numel() == 0:
        return out
    _, chunks, chunk_points = score_grid(pairs, b, n)
    scratch = out if chunks == 1 else torch.empty(
        (pairs, chunks, b), dtype=torch.float32, device=src.device)
    fn = (lib.sks_aca_solve_score_f32 if src.dtype == torch.float32
          else lib.sks_aca_solve_score_bf16)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), tar.data_ptr(), pts.data_ptr(),
                 point_weights.data_ptr(), t2, _SCORING[scoring],
                 out.data_ptr(), scratch.data_ptr(), pairs, b, n, chunks,
                 chunk_points, stream)
    check_launch(err, "aca_solve_score")
    LAUNCHES["aca_solve_score"] += 1
    return out
