"""Frames -> poses: the planar-VO front and back end in one call.

Port of ``sks_tpu/slam/pipeline.py`` (single device): pyramid Harris
detection, oriented patch description, mutual-NN/ratio matching, vectorized
RANSAC over all pairs at once (with ``config.fused``, one launch of the fused
kernel K2 for every pair of a batch), homography -> pose decomposition,
metric scale chaining and, in :func:`planar_slam`, loop-closure fits and
pose-graph relaxation.  With ``esm_iters > 0`` every pair's model is densely
polished against its two frames (``slam/tracking.py``, all pairs of a batch
in one pass of the ESM loop) before pose recovery.  Every stage stays on the
frames' device and reads nothing back to the host.  Each stage runs inside a
named range (``utils.profiling.annotate``: ``vo/...``, ``ransac/...``), from
which ``bench/pipeline_fps.py`` reads the stage split of one traced call.

The sharded forms (:func:`sharded_frames_to_poses`,
:func:`sharded_planar_slam`) split the pair fits over the ranks of a
``parallel.Mesh``: each rank matches and fits a contiguous block of the
pairs (with ``config.fused``, one K2 launch a rank), one gather brings every
rank the per-pair (R, t/d, n, inliers), and the chain and pose graph run
replicated.  A pair draws from the stream of its global index, so each
rank's fits are the single-device forms' own.
"""

from __future__ import annotations

import torch
from torch import Tensor

from sks_tpu_torch.features.matching import describe_frames, match_features
from sks_tpu_torch.parallel.mesh import Mesh, all_gather
from sks_tpu_torch.robust.api import _on_device
from sks_tpu_torch.robust.ransac import RansacConfig
from sks_tpu_torch.slam.odometry import (
    _closure_tensor,
    _default_normal,
    _streams,
    assemble_trajectory,
    chain_metric,
    closure_candidates,
    fit_pairs,
    vo_trajectory,
)
from sks_tpu_torch.utils.profiling import annotate
from sks_tpu_torch.utils.streams import CLOSURE_STREAM_OFFSET, pair_generators

__all__ = ["frames_to_poses", "planar_slam", "sharded_frames_to_poses",
           "sharded_planar_slam"]


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
    with annotate("vo/describe"):
        feats = describe_frames(frames, num_corners, num_octaves)
    with annotate("vo/match"):
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
      esm_iters: > 0 densely ESM-polishes every pair's RANSAC model against
        its two frames before pose recovery (``slam.odometry._esm_select``).
      indices: optional (T-1, B, 4) minimal sets in place of the draws.

    Returns dict: poses, rel (T-1, 4, 4), num_inliers (T-1,).
    """
    frames, k_mat = _inputs(frames, k_mat)
    if plane_normal is None:
        plane_normal = _default_normal(frames)
    t = frames.shape[0]
    idx = torch.arange(t - 1, device=frames.device)
    p1s, p2s, masks = _match_pairs_cached(frames, idx, idx + 1, num_corners,
                                          num_octaves)
    r, t_over_d, n, ninl = fit_pairs(_streams(generator, t - 1, p1s), p1s,
                                     p2s, masks, k_mat, config, plane_normal,
                                     indices, frames[:-1], frames[1:],
                                     esm_iters)
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
      esm_iters: > 0 densely ESM-polishes every pair fit (consecutive and
        closure) against its two frames before pose recovery; the default,
        8, is the JAX package's.  0 is the feature-only fit.
      indices: optional (T-1+E, B, 4) minimal sets in place of the draws,
        the consecutive pairs first, then the E closures in the order of
        ``slam.odometry.closure_candidates``.

    Returns:
      dict: poses (T, 4, 4), rel (T-1, 4, 4), num_inliers (T-1,),
      closure_inliers (E,), closure_rel (E, 4, 4) (each closure's metric
      cam_i -> cam_j, scaled by the plane depth at frame i: the measurement
      of its pose-graph edge).
    """
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
              frames=frames, esm_iters=esm_iters,
              indices=None if indices is None else indices[:t - 1])
    if cp.shape[0] == 0:
        # Too few frames for any closure stride: the plain odometry chain.
        out = vo_trajectory(generator, p1a, p2a, k_mat, config, **kw)
        out["closure_inliers"] = torch.zeros((0,), dtype=torch.int32,
                                             device=dev)
        out["closure_rel"] = out["rel"][:0]
        return out
    return vo_trajectory(
        generator, p1a[:t - 1], p2a[:t - 1], k_mat, config,
        closure_pairs=cp, closure_pts1=p1a[t - 1:], closure_pts2=p2a[t - 1:],
        closure_mask=ma[t - 1:],
        closure_indices=None if indices is None else indices[t - 1:], **kw)


def _sharded_fits(mesh: Mesh, axis, generator, frames, k_mat, config,
                  plane_normal, pairs, streams, num_corners, num_octaves,
                  indices, esm_iters):
    """Fit this rank's contiguous block of the work list ``pairs`` (frame
    index pairs, a multiple of the axis size) and gather every rank's
    results.

    Item j draws from stream ``streams[j]`` of the generator's seed and, with
    ``indices``, takes ``indices[j]``; the rank describes only the frames
    its pairs span.  Returns (R, t/d, n, num_inliers) of all items, in the
    list's order, on every rank.
    """
    blk = mesh.block(len(pairs), axis)
    mine = pairs[blk]
    lo = min(min(p) for p in mine)
    hi = max(max(p) for p in mine)
    dev = frames.device
    sub = frames[lo:hi + 1]
    i1 = torch.tensor([p[0] - lo for p in mine], device=dev)
    i2 = torch.tensor([p[1] - lo for p in mine], device=dev)
    p1s, p2s, masks = _match_pairs_cached(sub, i1, i2, num_corners,
                                          num_octaves)
    gdev = None if isinstance(generator, torch.Generator) else dev
    gens = [pair_generators(generator, 1, offset=s, device=gdev)[0]
            for s in streams[blk]]
    r, t_over_d, n, ninl = fit_pairs(
        gens, p1s, p2s, masks, k_mat, config, plane_normal,
        None if indices is None else indices[blk],
        sub[i1] if esm_iters else None, sub[i2] if esm_iters else None,
        esm_iters)
    return tuple(all_gather(mesh, axis, x) for x in (r, t_over_d, n, ninl))


def _mesh_inputs(mesh: Mesh, frames, k_mat, plane_normal):
    frames = torch.as_tensor(frames, device=mesh.device)
    k_mat = torch.as_tensor(k_mat, device=mesh.device).to(frames.dtype)
    if plane_normal is None:
        plane_normal = _default_normal(frames)
    return frames, k_mat, plane_normal


def sharded_frames_to_poses(
    mesh: Mesh,
    generator: torch.Generator | int | None,
    frames: Tensor,
    k_mat: Tensor,
    config: RansacConfig = RansacConfig(num_hypotheses=1024),
    num_corners: int = 384,
    num_octaves: int = 2,
    plane_depth: float = 1.0,
    plane_normal: Tensor | None = None,
    axis="frame",
    *,
    indices: Tensor | None = None,
):
    """:func:`frames_to_poses` with the T-1 pairs split over ``mesh[axis]``.

    T-1 must be a multiple of the axis size.  Each rank describes, matches
    and fits its contiguous block of pairs (with ``config.fused``, one K2
    launch), pair i drawing from stream i as in :func:`frames_to_poses`; one
    gather of the (T-1) x (3x3 + 3 + 3 + 1) results, then the metric chain,
    replicated.  ``frames`` (every rank the same) are computed on the mesh's
    device; ``indices``: optional (T-1, B, 4) global minimal sets.

    Returns the dict of :func:`frames_to_poses`, the same on every rank.
    """
    frames, k_mat, plane_normal = _mesh_inputs(mesh, frames, k_mat,
                                               plane_normal)
    t = frames.shape[0]
    pairs = [(i, i + 1) for i in range(t - 1)]
    r, t_over_d, n, ninl = _sharded_fits(
        mesh, axis, generator, frames, k_mat, config, plane_normal, pairs,
        list(range(t - 1)), num_corners, num_octaves, indices, 0)
    rel, poses, _ = chain_metric(r, t_over_d, n, plane_depth)
    return {"poses": poses, "rel": rel, "num_inliers": ninl}


def sharded_planar_slam(
    mesh: Mesh,
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
    axis="pair",
    esm_iters: int = 8,
    *,
    indices: Tensor | None = None,
):
    """:func:`planar_slam` with every pair fit, consecutive and closure,
    split over ``mesh[axis]``.

    The consecutive and closure pairs form one work list, padded to a
    multiple of the axis size by repeating pair 0 (the padding's results
    are discarded), and split contiguously.  The streams are laid out as in
    :func:`planar_slam`: consecutive pair i draws from stream i, closure e
    from ``CLOSURE_STREAM_OFFSET + e`` (the padding from streams 0, 1, ...).
    With ``esm_iters > 0`` (default 8) each rank polishes its fits against
    their frames; one gather of the per-pair results, then the chain and the
    pose graph (``slam.odometry.assemble_trajectory``), replicated.

    Args:
      indices: optional (T-1+E, B, 4) global minimal sets, the consecutive
        pairs first (padding items take row 0).

    Returns the dict of :func:`planar_slam`, the same on every rank.
    """
    frames, k_mat, plane_normal = _mesh_inputs(mesh, frames, k_mat,
                                               plane_normal)
    t = frames.shape[0]
    nc = t - 1
    if nc >= CLOSURE_STREAM_OFFSET:
        raise ValueError("consecutive-pair streams would collide with the "
                         f"closure stream at {CLOSURE_STREAM_OFFSET}")
    clos = closure_candidates(t, strides)
    pairs = [(i, i + 1) for i in range(nc)] + clos
    pad = -len(pairs) % mesh.size(axis)
    streams = (list(range(nc))
               + [CLOSURE_STREAM_OFFSET + e for e in range(len(clos))]
               + list(range(pad)))
    if indices is not None:
        idx = torch.as_tensor(indices)
        indices = torch.cat([idx, idx[:1].expand(pad, *idx.shape[1:])])
    r, td, n, ninl = _sharded_fits(
        mesh, axis, generator, frames, k_mat, config, plane_normal,
        pairs + [pairs[0]] * pad, streams, num_corners, num_octaves, indices,
        esm_iters)
    closure = None
    if clos:
        e = slice(nc, nc + len(clos))
        closure = (r[e], td[e], ninl[e], _closure_tensor(t, strides,
                                                         frames.device))
    out = assemble_trajectory(r[:nc], td[:nc], n[:nc], ninl[:nc], plane_depth,
                              smooth, closure=closure)
    if closure is None:
        out["closure_inliers"] = torch.zeros((0,), dtype=torch.int32,
                                             device=frames.device)
        out["closure_rel"] = out["rel"][:0]
    return out
