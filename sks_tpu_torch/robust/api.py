"""cv2-style convenience API over the vectorized RANSAC stack.

Port of ``sks_tpu/robust/api.py``: the ``cv2.findHomography`` call shape and
``(H, mask)`` return, torch tensors in and out.  Tensors are computed where
they lie; inputs that are not tensors (numpy arrays, lists) go to the CUDA
device, and raise where there is none: a caller asks for the CPU by passing
CPU tensors.
"""

from __future__ import annotations

from functools import partial

import torch
from torch import Tensor

from sks_tpu_torch.robust.ransac import (
    RansacConfig,
    ransac_homography,
    ransac_homography_adaptive,
    ransac_homography_fused_batch,
)

__all__ = [
    "fused_by_default",
    "find_homography",
    "get_perspective_transform",
    "get_affine_transform",
]

_METHODS = ("ransac", "msac", "magsac", "lmeds", "fused")


def _on_device(src, tar):
    """``src`` and ``tar`` as tensors on one device: ``src``'s if it is a
    tensor, else ``tar``'s if that is one, else the CUDA device (or raise)."""
    for x in (src, tar):
        if isinstance(x, Tensor):
            return (torch.as_tensor(src, device=x.device),
                    torch.as_tensor(tar, device=x.device))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "array inputs are computed on the CUDA device and there is none; "
            "pass CPU tensors (torch.as_tensor(x)) to compute on the CPU")
    return (torch.as_tensor(src, device="cuda"),
            torch.as_tensor(tar, device="cuda"))


def fused_by_default(device_type: str, dtype: torch.dtype) -> bool:
    """Whether an eligible fit on points of this device type and dtype takes
    the fused solve+score kernel without ``method='fused'``.

    The kernel solves and scores in float32, so only float32 and bfloat16
    points on CUDA go there.  float64 points keep the precision they were
    given, on the general path in float64 (on CUDA its batched solve is K5),
    as the JAX package keeps them off its TPU-only fused route.
    """
    return device_type == "cuda" and dtype in (torch.float32, torch.bfloat16)


def find_homography(
    src: Tensor,
    tar: Tensor,
    method: str = "ransac",
    ransac_reproj_threshold: float = 3.0,
    max_iters: int = 2048,
    solver: str = "aca",
    generator: torch.Generator | None = None,
    refine_iters: int = 2,
    confidence: float | None = None,
    sampling: str = "uniform",
    point_mask: Tensor | None = None,
    bf16_hypotheses: bool = False,
    *,
    indices: Tensor | None = None,
):
    """Robustly fit H mapping src -> tar (the ``cv2.findHomography`` shape).

    Args:
      src, tar: (..., N, 2) matched points, N >= 4.  Tensors stay on their
        device; arrays go to the CUDA device (and raise without one).
        Leading batch dims fit one pair after another, each drawing its
        minimal sets from ``generator`` in turn; on the fixed-batch fused
        path all pairs are solved and scored in one kernel launch.  With
        ``confidence`` each pair has its own early exit.
      method: 'ransac' (inlier counting), 'msac', 'magsac', 'lmeds', or
        'fused' (force the fused solve+score path).
      ransac_reproj_threshold: inlier threshold in pixels (symmetric transfer).
      max_iters: hypothesis budget.  Without ``confidence`` all hypotheses
        are evaluated at once (rounded up to a multiple of 128 on the fused
        path, as in the JAX package).  With ``confidence`` it is the
        worst-case cap of the early-exit loop.
      solver: minimal solver for hypotheses, a name in
        ``sks_tpu_torch.ops.SOLVERS_H``.
      generator: draws the minimal sets (default: seeded 0 on the input's
        device — deterministic).
      refine_iters: IRLS local-optimization rounds on the consensus set.
      confidence: if set (e.g. 0.995, the cv2 default semantic), run the
        early-exit loop (:func:`ransac_homography_adaptive`): geometrically
        growing chunks (256 -> 1024 -> 4096 -> ... capped at 2^17) until the
        termination bound is met or ``max_iters`` total.  The loop reads one
        flag back from the device before each chunk.  It takes eager chunks
        by default (on CUDA their batched solve is the solver's kernel);
        ``method='fused'`` opts in the fused kernel for stages of at least
        ``ransac.FUSED_ADAPTIVE_MIN_CHUNK`` hypotheses (past the 2^17 cap:
        on the card it was measured on, the eager chunk is the faster at
        every size).
      sampling: 'uniform', or 'prosac' progressive sampling (src/tar must be
        sorted by descending match quality).  Composes with the fused path.
      point_mask: optional (..., N) bool validity for padded point sets.
      bf16_hypotheses: store minimal sets in bfloat16 on the fused path.
      indices: optional minimal sets in place of the draws (the parity
        seam): ``(..., B, 4)`` integer indices with B the hypotheses of one
        fit (``max_iters``, rounded up to a multiple of 128 on the fused
        path); with ``confidence``, the whole schedule's draws.

    On float32 or bfloat16 CUDA tensors, eligible fits (method 'ransac' /
    'msac' / 'magsac', solver 'aca', no ``confidence``) take the fused
    kernel path, as the JAX package does on a TPU (:func:`fused_by_default`);
    float64 and CPU tensors take the general path.

    Returns:
      (H (..., 3, 3) normalized to H[..., 2, 2] = 1, mask (..., N) bool).
    """
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")
    src, tar = _on_device(src, tar)
    if point_mask is not None:
        point_mask = torch.as_tensor(point_mask, device=src.device)

    scoring = {"ransac": "inliers", "fused": "inliers"}.get(method, method)
    # The early-exit loop keeps the JAX package's routing: eager chunks
    # unless method='fused' opts the kernel in, stage by stage.
    fused = method == "fused" or (
        method in ("ransac", "msac", "magsac")
        and solver == "aca"
        and confidence is None
        and fused_by_default(src.device.type, src.dtype)
    )
    if method == "fused":
        solver = "aca"
    chunk = max_iters if confidence is None else min(256, max_iters)
    if fused:
        chunk = -(-chunk // 128) * 128
    config = RansacConfig(
        num_hypotheses=chunk,
        threshold=ransac_reproj_threshold,
        solver=solver,
        refine_iters=refine_iters,
        scoring=scoring,
        sampling=sampling,
        fused=fused,
        bf16_hypotheses=bf16_hypotheses,
    )
    if generator is None:
        generator = torch.Generator(device=src.device).manual_seed(0)

    if confidence is None:
        fit = ransac_homography
    else:
        fit = partial(ransac_homography_adaptive, confidence=confidence,
                      max_chunks=-(-max_iters // chunk))

    if src.dim() == 2:
        res = fit(generator, src, tar, config, point_mask=point_mask,
                  indices=indices)
        return res.h, res.inlier_mask

    bshape, n = src.shape[:-2], src.shape[-2]
    srcf = src.reshape(-1, n, 2)
    tarf = tar.reshape(-1, n, 2)
    pmf = None if point_mask is None else point_mask.reshape(-1, n)
    idxf = (None if indices is None
            else indices.reshape(-1, *indices.shape[-2:]))
    if fused and confidence is None:
        results = ransac_homography_fused_batch(generator, srcf, tarf, config,
                                                pmf, indices=idxf)
    else:
        results = [
            fit(generator, srcf[i], tarf[i], config,
                point_mask=None if pmf is None else pmf[i],
                indices=None if idxf is None else idxf[i])
            for i in range(srcf.shape[0])
        ]
    h = torch.stack([r.h for r in results]).reshape(*bshape, 3, 3)
    mask = torch.stack([r.inlier_mask for r in results]).reshape(*bshape, n)
    return h, mask


def get_perspective_transform(src: Tensor, tar: Tensor,
                              solver: str = "aca") -> Tensor:
    """Exact 4-point homography (the ``cv2.getPerspectiveTransform`` shape).

    Args:
      src, tar: (..., 4, 2) quads.
      solver: a name in ``sks_tpu_torch.ops.SOLVERS``.

    Returns:
      (..., 3, 3) H with H[..., 2, 2] = 1 mapping src onto tar.
    """
    from sks_tpu_torch.ops import SOLVERS

    src, tar = _on_device(src, tar)
    return SOLVERS[solver](src, tar)


def get_affine_transform(src: Tensor, tar: Tensor) -> Tensor:
    """Exact 3-point affine transform (the ``cv2.getAffineTransform`` shape).

    (..., 3, 2) x2 -> (..., 2, 3) affine matrix rows [A | t] with
    tar = A @ src + t.
    """
    from sks_tpu_torch.ops.affine import affine_3pt

    src, tar = _on_device(src, tar)
    return affine_3pt(src, tar)[..., :2, :]
