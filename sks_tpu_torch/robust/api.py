"""cv2-style convenience API over the vectorized RANSAC stack.

Port of ``sks_tpu/robust/api.py``: the ``cv2.findHomography`` call shape and
``(H, mask)`` return, torch tensors in and out, on the device of the input.
"""

from __future__ import annotations

import torch
from torch import Tensor

from sks_tpu_torch.robust.ransac import (
    RansacConfig,
    ransac_homography,
    ransac_homography_adaptive,
)

__all__ = [
    "fused_by_default",
    "find_homography",
    "get_perspective_transform",
    "get_affine_transform",
]

_METHODS = ("ransac", "msac", "magsac", "lmeds", "fused")


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
):
    """Robustly fit H mapping src -> tar (the ``cv2.findHomography`` shape).

    Args:
      src, tar: (..., N, 2) matched points, N >= 4 (tensors or arrays).
        Leading batch dims fit one pair after another, each drawing its
        minimal sets from ``generator`` in turn.
      method: 'ransac' (inlier counting), 'msac', 'magsac', 'lmeds', or
        'fused' (force the fused solve+score path).
      ransac_reproj_threshold: inlier threshold in pixels (symmetric transfer).
      max_iters: hypothesis budget, all evaluated at once (rounded up to a
        multiple of 128 on the fused path, as in the JAX package).
      solver: minimal solver for hypotheses, a name in
        ``sks_tpu_torch.ops.SOLVERS_H``.
      generator: draws the minimal sets (default: seeded 0 on the input's
        device — deterministic).
      refine_iters: IRLS local-optimization rounds on the consensus set.
      confidence: the early-exit loop; not ported yet (raises).
      sampling: 'uniform' ('prosac' is not ported yet).
      point_mask: optional (..., N) bool validity for padded point sets.
      bf16_hypotheses: store minimal sets in bfloat16 on the fused path.

    On float32 or bfloat16 CUDA tensors, eligible fits (method 'ransac' /
    'msac' / 'magsac', solver 'aca', no ``confidence``) take the fused
    kernel path, as the JAX package does on a TPU (:func:`fused_by_default`);
    float64 and CPU tensors take the general path.

    Returns:
      (H (..., 3, 3) normalized to H[..., 2, 2] = 1, mask (..., N) bool).
    """
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")
    src = torch.as_tensor(src)
    tar = torch.as_tensor(tar, device=src.device)
    if confidence is not None:
        # The early-exit loop; raises NotImplementedError until it is ported.
        ransac_homography_adaptive(src, tar, confidence=confidence)
    if point_mask is not None:
        point_mask = torch.as_tensor(point_mask, device=src.device)

    scoring = {"ransac": "inliers", "fused": "inliers"}.get(method, method)
    fused = method == "fused" or (
        method in ("ransac", "msac", "magsac")
        and solver == "aca"
        and fused_by_default(src.device.type, src.dtype)
    )
    if method == "fused":
        solver = "aca"
    config = RansacConfig(
        num_hypotheses=-(-max_iters // 128) * 128 if fused else max_iters,
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

    if src.dim() == 2:
        res = ransac_homography(generator, src, tar, config, point_mask)
        return res.h, res.inlier_mask

    bshape, n = src.shape[:-2], src.shape[-2]
    srcf = src.reshape(-1, n, 2)
    tarf = tar.reshape(-1, n, 2)
    pmf = None if point_mask is None else point_mask.reshape(-1, n)
    results = [
        ransac_homography(generator, srcf[i], tarf[i], config,
                          None if pmf is None else pmf[i])
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

    src = torch.as_tensor(src)
    return SOLVERS[solver](src, torch.as_tensor(tar, device=src.device))


def get_affine_transform(src: Tensor, tar: Tensor) -> Tensor:
    """Exact 3-point affine transform (the ``cv2.getAffineTransform`` shape).

    (..., 3, 2) x2 -> (..., 2, 3) affine matrix rows [A | t] with
    tar = A @ src + t.
    """
    from sks_tpu_torch.ops.affine import affine_3pt

    src = torch.as_tensor(src)
    return affine_3pt(src, torch.as_tensor(tar, device=src.device))[..., :2, :]
