"""Hopper CUDA kernels for ACA: batched solve (K1) and fused solve+score (K2).

Each kernel sits beside its plain PyTorch version.  A wrapper runs the plain
version only for tensors on the CPU; for a CUDA tensor it launches the kernel
or raises.  ``LAUNCHES`` counts kernel launches (plain runs are not counted),
so a run can show that its path went through the kernels.

K1 ``aca_solve_soa`` (``csrc/aca.cu::aca_solve_kernel``)
  Replaces ``sks_tpu/kernels/aca_pallas.py::aca_solve_soa`` (body
  ``_solve_kernel``).  Bound by device-memory bytes: 16 values in and 9 out
  per hypothesis (100 B in float32, 50 B in bfloat16 storage) for 97 flops.
  Design: one thread per hypothesis on the component-major ``(8, B)`` layout,
  so each of the 25 accesses is fully coalesced; bfloat16 storage halves the
  bytes while the arithmetic stays float32.

K2 ``aca_solve_score_soa`` (``csrc/aca.cu::aca_solve_score_kernel``)
  Replaces ``sks_tpu/kernels/aca_pallas.py::aca_solve_score_soa`` (body
  ``_solve_score_kernel``).  Bound by float32 arithmetic: per (hypothesis,
  point) pair, 2 IEEE divisions and ~38 flops.  Design: one thread per
  hypothesis keeps H and its adjugate in registers; the block stages point
  tiles in shared memory, where every thread reads the same address (a
  broadcast), so the inner loop is arithmetic only.  The TPU kernel's
  sequential point grid axis becomes this loop inside the block, and its
  padding of N becomes a bounds check.  Only the 4-byte score per hypothesis
  reaches device memory.  One block holds 128 hypotheses, so a batch under
  132 x 128 does not fill an H100's SMs.

Layout: the TPU's ``(8, M, 128)`` lane-tiled SoA becomes plain ``(8, B)``
(component k of hypothesis i at ``[k, i]``), with no padding of B.
"""

from __future__ import annotations

import torch
from torch import Tensor

from sks_tpu_torch.ops.aca import aca_core

__all__ = [
    "LAUNCHES",
    "aca_solve_soa",
    "aca_solve_soa_plain",
    "aca_solve_score_soa",
    "aca_solve_score_soa_plain",
    "aca_h_cuda",
    "to_soa",
    "from_soa_h",
]

#: Kernel launches per wrapper since the last reset (plain runs not counted).
LAUNCHES = {"aca_solve": 0, "aca_solve_score": 0}

_SCORING = {"inliers": 0, "msac": 1, "magsac": 2}
_STORAGE = (torch.float32, torch.bfloat16)


def to_soa(pts: Tensor) -> Tensor:
    """(B, 4, 2) -> (8, B) component-major, contiguous."""
    b = pts.shape[0]
    return pts.reshape(b, 8).T.contiguous()


def from_soa_h(h: Tensor) -> Tensor:
    """(9, B) -> (B, 3, 3)."""
    return h.T.reshape(h.shape[1], 3, 3)


def _check_soa(src: Tensor, tar: Tensor) -> None:
    if src.dim() != 2 or src.shape[0] != 8 or src.shape != tar.shape:
        raise ValueError(
            f"src and tar must both be (8, B); got {tuple(src.shape)} and "
            f"{tuple(tar.shape)}"
        )
    if src.dtype not in _STORAGE or tar.dtype != src.dtype:
        raise TypeError(
            f"src and tar must share a float32 or bfloat16 dtype; got "
            f"{src.dtype} and {tar.dtype}"
        )
    if src.device != tar.device:
        raise ValueError(f"src on {src.device} but tar on {tar.device}")
    if not (src.is_contiguous() and tar.is_contiguous()):
        raise ValueError("src and tar must be contiguous")


def _device_kind(*tensors: Tensor) -> str:
    kind = tensors[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {kind!r}")
    return kind


def _check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def aca_solve_soa_plain(src: Tensor, tar: Tensor) -> Tensor:
    """Plain version of K1: :func:`aca_core` on the 8 component rows, in f32."""
    s = [src[k].float() for k in range(8)]
    t = [tar[k].float() for k in range(8)]
    return torch.stack(aca_core(*s, *t)).to(src.dtype)


def aca_solve_soa(src: Tensor, tar: Tensor) -> Tensor:
    """Batched division-free ACA on component-major minimal sets (K1).

    Args:
      src, tar: (8, B) contiguous, float32 or bfloat16 (see :func:`to_soa`).

    Returns:
      (9, B) up-to-scale homographies in the input dtype, computed in f32.
    """
    _check_soa(src, tar)
    if _device_kind(src) == "cpu":
        return aca_solve_soa_plain(src, tar)
    from sks_tpu_torch.kernels._build import load_library

    lib = load_library()
    b = src.shape[1]
    out = torch.empty((9, b), dtype=src.dtype, device=src.device)
    if b == 0:
        return out
    fn = (lib.sks_aca_solve_f32 if src.dtype == torch.float32
          else lib.sks_aca_solve_bf16)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), tar.data_ptr(), out.data_ptr(), b, stream)
    _check_launch(err, "aca_solve")
    LAUNCHES["aca_solve"] += 1
    return out


def aca_h_cuda(src: Tensor, tar: Tensor) -> Tensor:
    """(B, 4, 2) convenience wrapper of K1: AoS -> SoA -> solve -> AoS.

    The counterpart of ``sks_tpu.kernels.aca_pallas.aca_h_pallas``; the layout
    shuffle costs one extra round trip through device memory.
    """
    return from_soa_h(aca_solve_soa(to_soa(src), to_soa(tar)))


def _score_inputs(src, tar, pts, point_weights, scoring):
    _check_soa(src, tar)
    if scoring not in _SCORING:
        raise ValueError(f"scoring must be one of {tuple(_SCORING)}, got "
                         f"{scoring!r}")
    if pts.dim() != 2 or pts.shape[0] != 4:
        raise ValueError(f"pts must be (4, N); got {tuple(pts.shape)}")
    n = pts.shape[1]
    if point_weights is None:
        point_weights = torch.ones(n, dtype=torch.float32, device=pts.device)
    if point_weights.shape != (n,):
        raise ValueError(f"point_weights must be ({n},); got "
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
    """Plain version of K2: broadcast (B, N) arithmetic in the kernel's order.

    Follows the kernel's own forward and reverse transfer, with
    ``finite = (w != 0) & (wr != 0)`` (not ``score_hypotheses``'s rule).
    """
    s = [src[k].float() for k in range(8)]
    t = [tar[k].float() for k in range(8)]
    h00, h01, h02, h10, h11, h12, h20, h21, h22 = (
        v[:, None] for v in aca_core(*s, *t)
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

    x, y, xp, yp = pts[0], pts[1], pts[2], pts[3]
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
    return torch.sum(torch.where(finite, gain, zero) * point_weights, dim=-1)


def aca_solve_score_soa(
    src: Tensor, tar: Tensor, pts: Tensor, threshold: float,
    point_weights: Tensor | None = None, scoring: str = "inliers",
) -> Tensor:
    """Fused ACA solve + symmetric-transfer RANSAC scoring (K2).

    Every hypothesis is solved and scored against all N correspondences;
    only the 4-byte score per hypothesis reaches device memory.

    Args:
      src, tar: (8, B) contiguous minimal sets, float32 or bfloat16.
      pts: (4, N) contiguous float32 rows [x, y, x', y'].
      threshold: squared threshold, a Python float.  'inliers' counts
        ``r2_fwd + r2_bwd < threshold``; 'msac' sums ``1 - r2/threshold``
        over those; 'magsac' sums ``(1 - sqrt(r2/threshold))^2`` with
        ``threshold = (k * sigma_max)^2``.
      point_weights: optional (N,) float32 gain multipliers (0 drops a point).
      scoring: 'inliers', 'msac' or 'magsac'.

    Returns:
      (B,) float32 scores.
    """
    point_weights = _score_inputs(src, tar, pts, point_weights, scoring)
    t2 = float(threshold)
    if _device_kind(src) == "cpu":
        return aca_solve_score_soa_plain(src, tar, pts, t2, point_weights,
                                         scoring)
    from sks_tpu_torch.kernels._build import load_library

    lib = load_library()
    b, n = src.shape[1], pts.shape[1]
    out = torch.empty((b,), dtype=torch.float32, device=src.device)
    if b == 0:
        return out
    fn = (lib.sks_aca_solve_score_f32 if src.dtype == torch.float32
          else lib.sks_aca_solve_score_bf16)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), tar.data_ptr(), pts.data_ptr(),
                 point_weights.data_ptr(), t2, _SCORING[scoring],
                 out.data_ptr(), b, n, stream)
    _check_launch(err, "aca_solve_score")
    LAUNCHES["aca_solve_score"] += 1
    return out
