"""Frames -> poses: the planar-VO front and back end in one call.

Port of ``sks_tpu/slam/pipeline.py`` (single device): pyramid Harris
detection, oriented patch description, mutual-NN/ratio matching, vectorized
RANSAC over all pairs at once (with ``config.fused``, one launch of the fused
kernel K2 for every pair of a batch), homography -> pose decomposition,
metric scale chaining and, in :func:`planar_slam`, loop-closure fits and
pose-graph relaxation.  Every stage stays on the frames' device and reads
nothing back to the host.  Each stage runs inside a
``torch.profiler.record_function`` range (``vo/...``, ``ransac/...``), from
which ``bench/pipeline_fps.py`` reads the stage split of one traced call.

The JAX package's dense ESM polish (``esm_iters > 0``, ``slam/tracking.py``)
and its sharded forms (``sharded_frames_to_poses``, ``sharded_planar_slam``)
are not ported yet (ROADMAP.md Queue A items 6 and 7).
"""

from __future__ import annotations

import torch
from torch import Tensor
from torch.profiler import record_function

from sks_tpu_torch.features.matching import describe_frames, match_features
from sks_tpu_torch.robust.api import _on_device
from sks_tpu_torch.robust.ransac import RansacConfig
from sks_tpu_torch.slam.odometry import (
    _closure_tensor,
    _default_normal,
    _no_esm,
    _streams,
    chain_metric,
    fit_pairs,
    vo_trajectory,
)

__all__ = ["frames_to_poses", "planar_slam"]


def _inputs(frames, k_mat):
    """Frames and ``k_mat`` as tensors on one device (arrays go to the CUDA
    device, ``robust.api._on_device``), ``k_mat`` in the frames' dtype."""
    frames, k_mat = _on_device(frames, k_mat)
    return frames, k_mat.to(frames.dtype)


def _match_pairs_cached(frames: Tensor, idx1: Tensor, idx2: Tensor,
                        num_corners: int, num_octaves: int):
    """Detect + describe every frame once, then match the (idx1, idx2) pairs.

    Returns (p1 (P, K, 2), p2 (P, K, 2), valid (P, K)), invalid slots at the
    image center.
    """
    with record_function("vo/describe"):
        feats = describe_frames(frames, num_corners, num_octaves)
    with record_function("vo/match"):
        f_i = {k: v[idx1] for k, v in feats.items()}
        f_j = {k: v[idx2] for k, v in feats.items()}
        p1, p2, valid, _ = match_features(f_i, f_j)
        # Invalid slots parked at the image center (they stay masked).
        h, w = frames.shape[-2:]
        center = torch.stack([torch.full((), w / 2.0, dtype=p1.dtype,
                                         device=p1.device),
                              torch.full((), h / 2.0, dtype=p1.dtype,
                                         device=p1.device)])
        v = valid[..., None]
        return torch.where(v, p1, center), torch.where(v, p2, center), valid


def frames_to_poses(
    generator: torch.Generator | int | None,
    frames: Tensor,
    k_mat: Tensor,
    config: RansacConfig = RansacConfig(num_hypotheses=1024),
    num_corners: int = 384,
    num_octaves: int = 2,
    plane_depth: float = 1.0,
    plane_normal: Tensor | None = None,
    esm_iters: int = 0,
    *,
    indices: Tensor | None = None,
):
    """(T, H, W) grayscale frames -> (T, 4, 4) cam->world poses.

    Args:
      generator: a ``torch.Generator`` or an int seed (None: 0); pair i
        draws its minimal sets from stream i (``utils.streams``), on the
        generator's device (an int seed: the frames').
      frames: (T, H, W) float32; tensors are computed where they lie,
        arrays on the CUDA device.
      config: with ``config.fused`` all T-1 pairs are scored in one launch
        of the fused kernel; otherwise each pair is a general-path fit.
      esm_iters: > 0 raises ``NotImplementedError`` (the dense ESM polish is
        ROADMAP.md Queue A item 6).
      indices: optional (T-1, B, 4) minimal sets in place of the draws.

    Returns dict: poses, rel (T-1, 4, 4), num_inliers (T-1,).
    """
    _no_esm(esm_iters)
    frames, k_mat = _inputs(frames, k_mat)
    if plane_normal is None:
        plane_normal = _default_normal(frames)
    t = frames.shape[0]
    idx = torch.arange(t - 1, device=frames.device)
    p1s, p2s, masks = _match_pairs_cached(frames, idx, idx + 1, num_corners,
                                          num_octaves)
    r, t_over_d, n, ninl = fit_pairs(_streams(generator, t - 1, p1s), p1s,
                                     p2s, masks, k_mat, config, plane_normal,
                                     indices)
    rel, poses, _ = chain_metric(r, t_over_d, n, plane_depth)
    return {"poses": poses, "rel": rel, "num_inliers": ninl}


def planar_slam(
    generator: torch.Generator | int | None,
    frames: Tensor,
    k_mat: Tensor,
    config: RansacConfig = RansacConfig(num_hypotheses=1024),
    num_corners: int = 384,
    num_octaves: int = 2,
    plane_depth: float = 1.0,
    plane_normal: Tensor | None = None,
    strides: tuple = (4, 8),
    smooth: bool = True,
    esm_iters: int = 8,
    *,
    indices: Tensor | None = None,
):
    """The planar-SLAM capstone: pixels -> loop-closed poses.

    Detection and description of every frame once, matching of the
    consecutive pairs and of the frame-i <-> i+k closure candidates, RANSAC
    fits (consecutive pairs in one batch, closures in another: with
    ``config.fused``, one K2 launch each), pose recovery, metric chaining
    and pose-graph relaxation over odometry + inlier-gated closure edges.

    Args:
      frames: (T, H, W) grayscale sequence.
      strides: closure-candidate strides (frame i matched against i+k).
      smooth: pose-graph relaxation; ``smooth=False`` is
        :func:`frames_to_poses` plus closure diagnostics.
      esm_iters: the JAX package's default, 8, densely ESM-polishes every
        pair fit; that polish (``slam/tracking.py``) is not ported yet
        (ROADMAP.md Queue A item 6), so any value but 0 raises
        ``NotImplementedError``: pass ``esm_iters=0``.
      indices: optional (T-1+E, B, 4) minimal sets in place of the draws,
        the consecutive pairs first, then the E closures in the order of
        ``slam.odometry.closure_candidates``.

    Returns:
      dict: poses (T, 4, 4), rel (T-1, 4, 4), num_inliers (T-1,),
      closure_inliers (E,).
    """
    _no_esm(esm_iters)
    frames, k_mat = _inputs(frames, k_mat)
    t = frames.shape[0]
    dev = frames.device
    idx = torch.arange(t - 1, device=dev)
    cp = _closure_tensor(t, strides, dev)
    i1 = torch.cat([idx, cp[:, 0]])
    i2 = torch.cat([idx + 1, cp[:, 1]])
    # One describe_frames serves consecutive and closure matching.
    p1a, p2a, ma = _match_pairs_cached(frames, i1, i2, num_corners,
                                       num_octaves)
    kw = dict(plane_depth=plane_depth, smooth=smooth,
              plane_normal=plane_normal, point_mask=ma[:t - 1],
              indices=None if indices is None else indices[:t - 1])
    if cp.shape[0] == 0:
        # Too few frames for any closure stride: the plain odometry chain.
        out = vo_trajectory(generator, p1a, p2a, k_mat, config, **kw)
        out["closure_inliers"] = torch.zeros((0,), dtype=torch.int32,
                                             device=dev)
        return out
    return vo_trajectory(
        generator, p1a[:t - 1], p2a[:t - 1], k_mat, config,
        closure_pairs=cp, closure_pts1=p1a[t - 1:], closure_pts2=p2a[t - 1:],
        closure_mask=ma[t - 1:],
        closure_indices=None if indices is None else indices[t - 1:], **kw)
