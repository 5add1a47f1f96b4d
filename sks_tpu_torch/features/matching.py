"""Descriptor matching: similarity product + mutual NN + ratio test.

Port of ``sks_tpu/features/matching.py``.  Every function batches over
leading dims: frames for the detectors, pairs for the matcher.  The
similarity ``d1 @ d2^T`` is a float32 product; the package turns TF32 off at
import (``sks_tpu_torch/__init__.py``), which the ratio test relies on.
"""

from __future__ import annotations

import torch
from torch import Tensor

from sks_tpu_torch.features.descriptors import (
    oriented_patch_descriptors,
    patch_descriptors,
)
from sks_tpu_torch.features.harris import detect_corners, detect_corners_pyramid

__all__ = ["match_descriptors", "match_frames", "match_frames_oriented",
           "describe_frames", "match_features"]


def _take_rows(x: Tensor, idx: Tensor) -> Tensor:
    """``x[..., idx, :]`` per batch: (..., K, D) rows picked by (..., M)."""
    idx = idx.long()
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def match_descriptors(
    d1: Tensor,
    d2: Tensor,
    valid1: Tensor | None = None,
    valid2: Tensor | None = None,
    ratio: float = 0.9,
):
    """Mutual-nearest-neighbor matches with Lowe ratio test.

    Args:
      d1: (..., K1, D) L2-normalized descriptors.  d2: (..., K2, D).
      valid1/valid2: optional masks for padded keypoint slots.
      ratio: Lowe first/second distance ratio threshold (squared distances).

    Returns:
      (idx2 (..., K1) int32 — match of each d1 in d2, valid (..., K1) bool).
    """
    # Squared L2 on unit vectors: 2 - 2 a.b — one float32 product.
    sim = torch.matmul(d1, d2.transpose(-1, -2))  # (..., K1, K2)
    ninf = torch.full_like(sim, -torch.inf)
    if valid2 is not None:
        sim = torch.where(valid2[..., None, :], sim, ninf)
    best2 = torch.argmax(sim, dim=-1)  # the first maximum, as jnp.argmax
    s_sorted = torch.topk(sim, 2, dim=-1).values
    d_best = 2.0 - 2.0 * s_sorted[..., 0]
    d_second = 2.0 - 2.0 * s_sorted[..., 1]
    passes_ratio = d_best < ratio * ratio * d_second

    sim_t = sim if valid1 is None else torch.where(valid1[..., :, None], sim,
                                                   ninf)
    best1 = torch.argmax(sim_t, dim=-2)  # best d1 for each d2
    mutual = torch.gather(best1, -1, best2) == torch.arange(
        d1.shape[-2], device=d1.device)

    valid = mutual & passes_ratio
    if valid1 is not None:
        valid = valid & valid1
    return best2.to(torch.int32), valid


def match_frames(img1: Tensor, img2: Tensor, num_corners: int = 512,
                 patch: int = 8):
    """Full detect->describe->match between two frames (fixed shapes).

    Returns (pts1 (..., K, 2), pts2 (..., K, 2), valid (..., K)) —
    correspondence arrays for ``robust.ransac_homography`` (``valid`` as
    ``point_mask``).
    """
    xy1, _, v1 = detect_corners(img1, num_corners)
    xy2, _, v2 = detect_corners(img2, num_corners)
    d1 = patch_descriptors(img1, xy1, patch)
    d2 = patch_descriptors(img2, xy2, patch)
    idx2, valid = match_descriptors(d1, d2, v1, v2)
    return xy1, _take_rows(xy2, idx2), valid


def match_frames_oriented(
    img1: Tensor, img2: Tensor, num_corners: int = 512, num_octaves: int = 3,
    patch: int = 8, ratio: float = 0.9, orientation: str = "gradient",
):
    """Rotation/scale-robust detect->describe->match between two frames.

    Octave-pyramid Harris + oriented, scale-adapted patch descriptors;
    ``orientation='gradient'`` (default) uses the smoothed-gradient
    orientation, 'centroid' the ORB intensity centroid.

    Returns (pts1 (..., K, 2), pts2 (..., K, 2), valid (..., K), quality
    (..., K)) — quality is the match similarity, usable as the PROSAC sort
    key.
    """
    xy1, _, v1, s1 = detect_corners_pyramid(img1, num_corners, num_octaves)
    xy2, _, v2, s2 = detect_corners_pyramid(img2, num_corners, num_octaves)
    d1, _ = oriented_patch_descriptors(img1, xy1, scale=s1, patch=patch,
                                       orientation=orientation)
    d2, _ = oriented_patch_descriptors(img2, xy2, scale=s2, patch=patch,
                                       orientation=orientation)
    idx2, valid = match_descriptors(d1, d2, v1, v2, ratio)
    quality = torch.sum(d1 * _take_rows(d2, idx2), dim=-1)
    return xy1, _take_rows(xy2, idx2), valid, quality


def describe_frames(
    frames: Tensor, num_corners: int = 512, num_octaves: int = 3,
    patch: int = 8, orientation: str = "gradient",
):
    """Detect + describe a whole frame batch once, in one pass over (T, H, W).

    Each frame is detected and described once, however many pairs it is
    part of.

    Returns dict of per-frame feature tensors: ``xy (T, K, 2)``,
    ``valid (T, K)``, ``scale (T, K)``, ``desc (T, K, D)``.
    """
    xy, _, valid, scale = detect_corners_pyramid(frames, num_corners,
                                                 num_octaves)
    desc, _ = oriented_patch_descriptors(frames, xy, scale=scale, patch=patch,
                                         orientation=orientation)
    return {"xy": xy, "valid": valid, "scale": scale, "desc": desc}


def match_features(f1: dict, f2: dict, ratio: float = 0.9):
    """Match two per-frame feature dicts (entries of :func:`describe_frames`,
    with any leading pair axis).

    Returns (pts1 (..., K, 2), pts2 (..., K, 2), valid (..., K), quality
    (..., K)) — the contract of :func:`match_frames_oriented`.
    """
    idx2, valid = match_descriptors(f1["desc"], f2["desc"], f1["valid"],
                                    f2["valid"], ratio)
    pts2 = _take_rows(f2["xy"], idx2)
    quality = torch.sum(f1["desc"] * _take_rows(f2["desc"], idx2), dim=-1)
    return f1["xy"], pts2, valid, quality
