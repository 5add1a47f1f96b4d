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
With ``esm_iters > 0`` and the frames, every pair's model is then densely
polished against the pixels (``slam.tracking.esm_polish_pair_symmetric``,
all pairs and both directions in one batch) and kept where a guard on the
matches allows.  Pose recovery runs batched over all pairs.  Each pair
draws from its own generator (``utils.streams.pair_generators``), so its
fit does not depend on the other pairs of its batch; ``indices=`` replaces
the draws (the parity seam).
"""

from __future__ import annotations

import torch
from torch import Tensor

from sks_tpu_torch.geom.lie import mm_small
from sks_tpu_torch.geom.pose import recover_pose
from sks_tpu_torch.robust.ransac import (
    RansacConfig,
    ransac_homography,
    ransac_homography_fused_batch,
    score_hypotheses,
)
from sks_tpu_torch.slam.posegraph import PoseGraph, _inv_se3, optimize_posegraph
from sks_tpu_torch.slam.tracking import esm_guard, esm_polish_pair_symmetric
from sks_tpu_torch.utils.profiling import annotate, count
from sks_tpu_torch.utils.streams import CLOSURE_STREAM_OFFSET, pair_generators

__all__ = ["vo_trajectory", "chain_poses", "closure_candidates",
           "fit_pair", "fit_pairs", "chain_metric", "assemble_trajectory",
           "CLOSURE_MIN_INLIERS"]

#: A loop closure with fewer inliers is a misfit, not a constraint: its
#: pose-graph edge gets weight 0.
CLOSURE_MIN_INLIERS = 12


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

    With ``esm_iters > 0`` and the frame pair ``(f1, f2)`` supplied, the
    RANSAC model is densely polished by photometric alignment before pose
    recovery, and kept only where :func:`_esm_select`'s guard allows.

    Returns (R, t/d, n, num_inliers).
    """
    res = ransac_homography(generator, p1, p2, config, point_mask=pm,
                            indices=indices)
    h, ninl = res.h, res.num_inliers
    if esm_iters and f1 is not None:
        h, ninl = _esm_select(h[None], res.inlier_mask[None], f1[None],
                              f2[None], p1[None], p2[None], pm[None], config,
                              esm_iters)
        h, ninl = h[0], ninl[0]
    r, t, n, _ = recover_pose(h, k_mat, k_mat, p1, p2,
                              normal_prior=plane_normal)
    return r, t, n, ninl


def _esm_select(h, inlier_mask, f1, f2, p1, p2, pm, config, esm_iters):
    """The guarded dense polish of P pair models (the JAX package's
    ``fit_pair`` body under ``jax.vmap``).

    One :func:`esm_polish_pair_symmetric` call polishes all P models, both
    directions in one batch; :func:`esm_guard` accepts a polished model only
    if the median symmetric transfer error of the RANSAC inliers does not
    grow by more than 10% (a photometric win can be a geometric loss off the
    plane); the inlier count is that of the model kept, re-scored at the
    config's threshold.

    Args:
      h: (P, 3, 3) RANSAC models; inlier_mask: (P, N) their inliers.
      f1, f2: (P, H, W) frames of each pair; p1, p2: (P, N, 2); pm: (P, N).

    Counts ``esm.models`` (P) and ``esm.kept`` (the models whose polish the
    guard accepted, summed from the guard's device mask) while a profiler
    records.

    Returns (h (P, 3, 3), num_inliers (P,) int32).
    """
    with annotate("vo/esm"):
        h_esm, _ = esm_polish_pair_symmetric(f1, f2, h, iters=esm_iters)
        ok = esm_guard(h, h_esm, p1, p2, inlier_mask)
        count("esm.models", h.shape[0])
        count("esm.kept", ok)
        inl = torch.stack([
            score_hypotheses(torch.stack([h[i], h_esm[i]]), p1[i], p2[i],
                             config.threshold, pm[i], config.scoring,
                             config.sigma_max, config.df64_scoring)[1]
            for i in range(h.shape[0])])  # (P, 2, N)
        h = torch.where(ok[:, None, None], h_esm, h)
        ninl = torch.sum(torch.where(ok[:, None], inl[:, 1], inl[:, 0]),
                         dim=-1).to(torch.int32)
    return h, ninl


def fit_pairs(generators, pts1, pts2, masks, k_mat, config, plane_normal,
              indices=None, frames1=None, frames2=None, esm_iters: int = 0):
    """:func:`fit_pair` over a batch of P pairs, batched where it can be.

    Args:
      generators: P generators, one a pair (ignored with ``indices``).
      pts1, pts2: (P, N, 2) matches; masks: (P, N) bool.
      indices: optional (P, B, 4) minimal sets in place of the draws.
      frames1, frames2, esm_iters: (P, H, W) frames of each pair; with
        ``esm_iters > 0`` all P models are densely polished in one batch
        (:func:`_esm_select`) after the per-pair fits.

    Returns (R (P, 3, 3), t/d (P, 3), n (P, 3), num_inliers (P,) int32).
    """
    if config.fused:
        # One K2 launch scores every pair's hypotheses.
        results = ransac_homography_fused_batch(
            generators, pts1, pts2, config, masks, indices=indices)
    else:
        with annotate("ransac/general"):
            results = [
                ransac_homography(generators[i], pts1[i], pts2[i], config,
                                  point_mask=masks[i],
                                  indices=None if indices is None
                                  else indices[i])
                for i in range(pts1.shape[0])
            ]
    h = torch.stack([res.h for res in results])
    ninl = torch.stack([res.num_inliers for res in results])
    if esm_iters and frames1 is not None:
        h, ninl = _esm_select(
            h, torch.stack([res.inlier_mask for res in results]), frames1,
            frames2, pts1, pts2, masks, config, esm_iters)
    with annotate("vo/pose"):
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
    with annotate("vo/chain"):
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
      frames: optional (T, H, W) frames; with ``esm_iters > 0`` every pair
        fit, consecutive and closure, is densely ESM-polished against its
        two frames before pose recovery (:func:`_esm_select`).
      esm_iters: the polish's coarse-level iteration cap (0: no polish).
      indices: optional (T-1, B, 4) minimal sets in place of the draws of
        the consecutive pairs; ``closure_indices`` (E, B, 4) for the
        closures.

    Returns:
      dict: poses (T, 4, 4) cam->world, rel (T-1, 4, 4), num_inliers (T-1,),
      and (with closures) closure_inliers (E,) and closure_rel (E, 4, 4),
      each closure's metric cam_i -> cam_j, the measurement its pose-graph
      edge holds.
    """
    t_minus_1 = pts1.shape[0]
    if t_minus_1 >= CLOSURE_STREAM_OFFSET:
        raise ValueError("consecutive-pair streams would collide with the "
                         f"closure stream at {CLOSURE_STREAM_OFFSET}")
    if plane_normal is None:
        plane_normal = _default_normal(pts1)
    dev = pts1.device

    pm = (torch.ones(pts1.shape[:-1], dtype=torch.bool, device=dev)
          if point_mask is None else point_mask)
    use_esm = esm_iters > 0 and frames is not None
    esm = dict(esm_iters=esm_iters if use_esm else 0)
    if use_esm:
        esm.update(frames1=frames[:-1], frames2=frames[1:])
    r, t_over_d, n, ninl = fit_pairs(
        _streams(generator, t_minus_1, pts1), pts1, pts2, pm, k_mat, config,
        plane_normal, indices, **esm)

    closure = None
    if closure_pairs is not None:
        e = closure_pts1.shape[0]
        cm = (torch.ones(closure_pts1.shape[:-1], dtype=torch.bool,
                         device=dev) if closure_mask is None else closure_mask)
        cpl = closure_pairs.long()
        if use_esm:
            esm.update(frames1=frames[cpl[:, 0]], frames2=frames[cpl[:, 1]])
        with annotate("vo/closure"):
            r_c, tt_c, _, ninl_c = fit_pairs(
                _streams(generator, e, pts1, offset=CLOSURE_STREAM_OFFSET),
                closure_pts1, closure_pts2, cm, k_mat, config, plane_normal,
                closure_indices, **esm)
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
        t/d vectors, inlier counts, and (E, 2) integer frame pairs.  The
        closures at ``CLOSURE_MIN_INLIERS`` or more are counted in
        ``vo.closures_kept`` (from the device mask) while a profiler records.
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
        out["closure_rel"] = rel_c
        kept = ninl_c >= CLOSURE_MIN_INLIERS
        count("vo.closures_kept", kept)

    if smooth:
        ar = torch.arange(t_minus_1, device=r.device)
        edges = torch.stack([ar, ar + 1], dim=-1)
        meas = _inv_se3(rel)
        weights = ninl.to(poses.dtype)
        if rel_c is not None:
            edges = torch.cat([edges, cp], dim=0)
            meas = torch.cat([meas, _inv_se3(rel_c)], dim=0)
            w_c = torch.where(kept, ninl_c,
                              torch.zeros_like(ninl_c)).to(poses.dtype)
            weights = torch.cat([weights, w_c], dim=0)
        graph = PoseGraph(poses=poses, edges=edges, meas=meas,
                          weights=weights)
        with annotate("vo/posegraph"):
            out["poses"] = optimize_posegraph(graph, gn_iters=5,
                                              cg_iters=30).poses
    return out
