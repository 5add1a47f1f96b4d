"""Planar visual odometry: homography chain -> pose trajectory (batched).

Port of ``sks_tpu/slam/odometry.py``: for every frame pair, fit a homography
by vectorized RANSAC, decompose it into a relative pose with a known plane
depth fixing the monocular scale, chain the poses, and optionally relax them
with the pose graph.

The pairs of a batch are fitted at once.  With ``config.fused`` (the route
the JAX package takes on its TPU) one call of
``ransac_homography_fused_batch`` scores every pair's hypotheses in **one**
launch of the fused solve+score kernel K2; the top-K re-score, IRLS refit and
LM polish then run pair by pair.  Without it each pair is a general-path
``ransac_homography`` (on CUDA, one K1 launch a pair for its batched solve).
Pose recovery runs batched over all pairs.  Each pair draws from its own
generator (``utils.streams.pair_generators``), so its fit does not depend on
the other pairs of its batch; ``indices=`` replaces the draws (the parity
seam).
"""

from __future__ import annotations

import torch
from torch import Tensor
from torch.profiler import record_function

from sks_tpu_torch.geom.lie import mm_small
from sks_tpu_torch.geom.pose import recover_pose
from sks_tpu_torch.robust.ransac import (
    RansacConfig,
    ransac_homography,
    ransac_homography_fused_batch,
)
from sks_tpu_torch.slam.posegraph import PoseGraph, _inv_se3, optimize_posegraph
from sks_tpu_torch.utils.streams import CLOSURE_STREAM_OFFSET, pair_generators

__all__ = ["vo_trajectory", "chain_poses", "closure_candidates",
           "fit_pair", "fit_pairs", "chain_metric", "assemble_trajectory"]


def _no_esm(esm_iters: int) -> None:
    if esm_iters:
        raise NotImplementedError(
            "esm_iters > 0 (the dense ESM polish, slam/tracking.py) is not "
            "ported yet: ROADMAP.md Queue A item 6; pass esm_iters=0")


def _streams(generator, n: int, like: Tensor, offset: int = 0):
    """The pair generators of a batch: a ``torch.Generator``'s streams draw
    on its own device (the draws then move to the points' device), an int
    seed's on the device of ``like``."""
    device = (None if isinstance(generator, torch.Generator)
              else like.device)
    return pair_generators(generator, n, offset=offset, device=device)


def _default_normal(like: Tensor) -> Tensor:
    """The frontal plane normal (0, 0, 1), made on the device."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[2]


def fit_pair(generator, p1, p2, pm, k_mat, config, plane_normal,
             f1=None, f2=None, esm_iters: int = 0, *, indices=None):
    """RANSAC homography + pose recovery for one frame pair.

    ``esm_iters > 0`` (the JAX package's dense photometric polish of the
    RANSAC model against the frames ``f1``, ``f2``) raises
    ``NotImplementedError`` until ``slam/tracking.py`` is ported.

    Returns (R, t/d, n, num_inliers).
    """
    _no_esm(esm_iters)
    res = ransac_homography(generator, p1, p2, config, point_mask=pm,
                            indices=indices)
    r, t, n, _ = recover_pose(res.h, k_mat, k_mat, p1, p2,
                              normal_prior=plane_normal)
    return r, t, n, res.num_inliers


def fit_pairs(generators, pts1, pts2, masks, k_mat, config, plane_normal,
              indices=None):
    """:func:`fit_pair` over a batch of P pairs, batched where it can be.

    Args:
      generators: P generators, one a pair (ignored with ``indices``).
      pts1, pts2: (P, N, 2) matches; masks: (P, N) bool.
      indices: optional (P, B, 4) minimal sets in place of the draws.

    Returns (R (P, 3, 3), t/d (P, 3), n (P, 3), num_inliers (P,) int32).
    """
    if config.fused:
        # One K2 launch scores every pair's hypotheses.
        results = ransac_homography_fused_batch(
            generators, pts1, pts2, config, masks, indices=indices)
    else:
        with record_function("ransac/general"):
            results = [
                ransac_homography(generators[i], pts1[i], pts2[i], config,
                                  point_mask=masks[i],
                                  indices=None if indices is None
                                  else indices[i])
                for i in range(pts1.shape[0])
            ]
    with record_function("vo/pose"):
        h = torch.stack([res.h for res in results])
        ninl = torch.stack([res.num_inliers for res in results])
        r, t, n, _ = recover_pose(h, k_mat, k_mat, pts1, pts2,
                                  normal_prior=plane_normal)
    return r, t, n, ninl


def chain_metric(r, t_over_d, n, plane_depth):
    """Chain per-pair (R, t/d, n) into metric relative poses + world poses.

    The homography yields t/d with d the *current* plane depth; track d
    along the chain: in cam_{i+1} coords the plane is (R n).X = d + (R n).t,
    so d_{i+1} = d_i + n_{i+1}.t_i.  Returns (rel (T-1,4,4), poses (T,4,4),
    depths (T,)).
    """
    with record_function("vo/chain"):
        d = torch.full((), plane_depth, dtype=r.dtype, device=r.device)
        t_metric, d_at = [], []
        for i in range(r.shape[0]):  # the JAX package's lax.scan
            t_i = t_over_d[i] * d
            n_new = r[i] @ n[i]
            d_at.append(d)
            t_metric.append(t_i)
            d = d + torch.dot(n_new, t_i)
        rel = _rt_to_se3(r, torch.stack(t_metric) if t_metric
                         else torch.zeros_like(t_over_d))
        depths = torch.stack([*d_at, d])
        return rel, chain_poses(rel), depths


def closure_candidates(num_frames: int, strides=(4, 8)) -> list:
    """Non-consecutive frame pairs (i, i+k) to test for loop closures.

    Returns [(i, j), ...] with j - i in ``strides`` (static Python)."""
    out = []
    for k in strides:
        out.extend((i, i + k) for i in range(0, num_frames - k))
    return out


def _closure_tensor(num_frames: int, strides, device) -> Tensor:
    """:func:`closure_candidates` as an (E, 2) int64 tensor made on the
    device (from aranges: no host-to-device copy)."""
    parts = [torch.zeros((0, 2), dtype=torch.long, device=device)]
    for k in strides:
        i = torch.arange(max(num_frames - k, 0), device=device)
        parts.append(torch.stack([i, i + k], dim=-1))
    return torch.cat(parts)


def _rt_to_se3(r: Tensor, t: Tensor) -> Tensor:
    top = torch.cat([r, t[..., None]], dim=-1)
    bot = torch.eye(4, dtype=r.dtype, device=r.device)[3:]
    return torch.cat([top, bot.expand(*top.shape[:-2], 1, 4)], dim=-2)


def chain_poses(rel: Tensor) -> Tensor:
    """Chain T-1 relative cam_i->cam_{i+1} transforms into T world poses.

    rel: (T-1, 4, 4) with X_{i+1} = rel_i X_i.  Returns (T, 4, 4) cam->world
    poses, first = identity: the running product of the inverses, in order
    (the JAX package's associative scan; products associate differently).
    """
    inv_rel = _inv_se3(rel)  # cam_{i+1} -> cam_i
    eye = torch.eye(4, dtype=rel.dtype, device=rel.device)
    out = [eye]
    for i in range(rel.shape[0]):
        out.append(mm_small(out[-1], inv_rel[i]))
    return torch.stack(out)


def vo_trajectory(
    generator: torch.Generator | int | None,
    pts1: Tensor,
    pts2: Tensor,
    k_mat: Tensor,
    config: RansacConfig = RansacConfig(num_hypotheses=1024),
    plane_depth: float = 1.0,
    smooth: bool = False,
    plane_normal: Tensor | None = None,
    point_mask: Tensor | None = None,
    closure_pairs: Tensor | None = None,
    closure_pts1: Tensor | None = None,
    closure_pts2: Tensor | None = None,
    closure_mask: Tensor | None = None,
    frames: Tensor | None = None,
    esm_iters: int = 0,
    *,
    indices: Tensor | None = None,
    closure_indices: Tensor | None = None,
):
    """Trajectory from per-pair correspondences.

    Args:
      generator: a ``torch.Generator`` or an int seed (None: seed 0); pair i
        draws from stream i of it and closure e from stream
        ``CLOSURE_STREAM_OFFSET + e`` (``utils.streams``), on the
        generator's device (an int seed: the points').
      pts1, pts2: (T-1, N, 2) matched pixels for consecutive pairs.
      k_mat: (3, 3) intrinsics.
      config: the RANSAC configuration; ``config.fused`` fits all pairs with
        one launch of the fused kernel (K2) per batch.
      plane_depth: metric distance of the plane from camera 0 (fixes scale).
      smooth: run pose-graph relaxation over the chained trajectory.
      plane_normal: approximate plane normal in the camera frame (default
        frontal, (0,0,1)) — resolves the homography twofold ambiguity.
      point_mask: optional (T-1, N) validity for padded match arrays.
      closure_pairs: optional (E, 2) integer frame pairs (i, j), i < j (see
        :func:`closure_candidates`); with ``closure_pts1/pts2`` ((E, M, 2)
        matches between those frames) each is fitted like a consecutive pair
        and becomes a pose-graph edge when ``smooth=True``.
      frames, esm_iters: the dense ESM polish; ``esm_iters > 0`` raises
        ``NotImplementedError`` (ROADMAP.md Queue A item 6).
      indices: optional (T-1, B, 4) minimal sets in place of the draws of
        the consecutive pairs; ``closure_indices`` (E, B, 4) for the
        closures.

    Returns:
      dict: poses (T, 4, 4) cam->world, rel (T-1, 4, 4), num_inliers (T-1,),
      and (with closures) closure_inliers (E,).
    """
    _no_esm(esm_iters)
    t_minus_1 = pts1.shape[0]
    if t_minus_1 >= CLOSURE_STREAM_OFFSET:
        raise ValueError("consecutive-pair streams would collide with the "
                         f"closure stream at {CLOSURE_STREAM_OFFSET}")
    if plane_normal is None:
        plane_normal = _default_normal(pts1)
    dev = pts1.device

    pm = (torch.ones(pts1.shape[:-1], dtype=torch.bool, device=dev)
          if point_mask is None else point_mask)
    r, t_over_d, n, ninl = fit_pairs(
        _streams(generator, t_minus_1, pts1), pts1, pts2, pm, k_mat, config,
        plane_normal, indices)

    closure = None
    if closure_pairs is not None:
        e = closure_pts1.shape[0]
        cm = (torch.ones(closure_pts1.shape[:-1], dtype=torch.bool,
                         device=dev) if closure_mask is None else closure_mask)
        r_c, tt_c, _, ninl_c = fit_pairs(
            _streams(generator, e, pts1, offset=CLOSURE_STREAM_OFFSET),
            closure_pts1, closure_pts2, cm, k_mat, config, plane_normal,
            closure_indices)
        closure = (r_c, tt_c, ninl_c, closure_pairs)

    return assemble_trajectory(r, t_over_d, n, ninl, plane_depth, smooth,
                               closure=closure)


def assemble_trajectory(r, t_over_d, n, ninl, plane_depth: float,
                        smooth: bool, closure=None):
    """Per-pair (R, t/d, n, inliers) -> chained (+ optionally relaxed) poses.

    Metric chain, closure scaling by the plane depth at each closure's
    source frame, and pose-graph relaxation over odometry + inlier-gated
    closure edges.

    Args:
      closure: optional ``(r_c, tt_c, ninl_c, cp)`` — closure-pair rotations,
        t/d vectors, inlier counts, and (E, 2) integer frame pairs.
    """
    t_minus_1 = r.shape[0]
    rel, poses, depths = chain_metric(r, t_over_d, n, plane_depth)
    out = {"poses": poses, "rel": rel, "num_inliers": ninl}

    rel_c = None
    if closure is not None:
        r_c, tt_c, ninl_c, cp = closure
        cp = cp.long()
        # Scale each closure by the plane depth at its source frame i.
        t_c = tt_c * depths[cp[:, 0]][:, None]
        rel_c = _rt_to_se3(r_c, t_c)  # cam_i -> cam_j
        out["closure_inliers"] = ninl_c

    if smooth:
        ar = torch.arange(t_minus_1, device=r.device)
        edges = torch.stack([ar, ar + 1], dim=-1)
        meas = _inv_se3(rel)
        weights = ninl.to(poses.dtype)
        if rel_c is not None:
            edges = torch.cat([edges, cp], dim=0)
            meas = torch.cat([meas, _inv_se3(rel_c)], dim=0)
            # A closure with too few inliers is a misfit, not a constraint.
            w_c = torch.where(ninl_c >= 12, ninl_c,
                              torch.zeros_like(ninl_c)).to(poses.dtype)
            weights = torch.cat([weights, w_c], dim=0)
        graph = PoseGraph(poses=poses, edges=edges, meas=meas,
                          weights=weights)
        with record_function("vo/posegraph"):
            out["poses"] = optimize_posegraph(graph, gn_iters=5,
                                              cg_iters=30).poses
    return out
