"""RANSAC with its hypothesis budget split over a mesh axis.

Port of ``sks_tpu/parallel/sharded_ransac.py``.  Hypotheses are independent:
each rank draws, solves and scores its share of the budget against the whole
(replicated) correspondence set through the single-device route
(``robust.ransac``: the batched solve in K1, K3 or K4-GE on CUDA and the
eager scoring, or with ``fused=True`` one launch of the fused solve+score
kernel K2 and the eager re-score of its top-K), keeps its top-K, and the
consensus is a gather of the ranks' top-K models (K x 9 floats each), the
global top-K and the single-device refinement, the same on every rank.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor

from sks_tpu_torch.kernels.aca_cuda import aca_solve_score_soa
from sks_tpu_torch.parallel.mesh import Mesh, all_gather
from sks_tpu_torch.robust.ransac import (
    RansacConfig,
    RansacResult,
    _eval_chunk,
    _fused_draw,
    _fused_top,
    _refine_and_pack,
    _top_k,
    fused_kernel_threshold,
    sample_minimal_sets,
    score_hypotheses,
)
from sks_tpu_torch.utils.streams import pair_generators

__all__ = ["sharded_ransac_homography"]


def sharded_ransac_homography(
    mesh: Mesh,
    generator: torch.Generator | int | None,
    src: Tensor,
    tar: Tensor,
    config: RansacConfig = RansacConfig(),
    axis="hyp",
    fused: bool = False,
    *,
    indices: Tensor | None = None,
) -> RansacResult:
    """RANSAC with the hypothesis batch split over ``mesh[axis]``.

    ``config.num_hypotheses`` is the global budget B, a multiple of the
    axis size n; each rank evaluates B / n hypotheses.  Rank d (its
    :meth:`Mesh.index` along ``axis``) draws its minimal sets uniformly from
    stream d of the generator's seed (``utils.streams.pair_generators(
    generator, 1, offset=d)``, on the generator's device; an int seed or
    None, on the mesh's), as the JAX package folds the device index into
    its key; so the hypotheses are a function of the seed and n alone.

    ``axis`` may be a tuple of mesh axes (``('host', 'hyp')`` on a
    :func:`parallel.distributed.global_mesh`), linearized row-major.

    ``fused=True`` solves and scores each rank's batch in one launch of the
    fused kernel (constraints of ``ransac_homography_fused``: ACA, scoring
    'inliers', 'msac' or 'magsac'; any B / n); the rank's top-K is then
    re-solved and re-scored eagerly.

    Args:
      src, tar: (N, 2) matched points, the same on every rank; computed on
        the mesh's device.
      indices: optional (B, 4) global minimal sets in place of the draws;
        rank d takes rows [d B / n, (d + 1) B / n).

    Returns the same RansacResult on every rank.
    """
    n_dev = mesh.size(axis)
    b = config.num_hypotheses
    if b % n_dev:
        raise ValueError(f"num_hypotheses {b} does not split over {n_dev} "
                         "ranks")
    src = torch.as_tensor(src, device=mesh.device)
    tar = torch.as_tensor(tar, device=mesh.device, dtype=src.dtype)
    b_local = b // n_dev
    local = dataclasses.replace(config, num_hypotheses=b_local, fused=False)
    if indices is None:
        gen = pair_generators(
            generator, 1, offset=mesh.index(axis),
            device=None if isinstance(generator, torch.Generator)
            else mesh.device)[0]
        idx = sample_minimal_sets(gen, src.shape[0], b_local)
    else:
        idx = torch.as_tensor(indices)
        if idx.shape != (b, 4) or idx.is_floating_point():
            raise ValueError(f"indices must be an integer ({b}, 4) tensor; "
                             f"got {idx.dtype} {tuple(idx.shape)}")
        idx = idx[mesh.block(b, axis)]
    idx = idx.to(device=src.device, dtype=torch.long)

    if fused:
        (s4, t4), (s_soa, t_soa, pts, pw) = _fused_draw(
            None, src, tar, local, None, idx, lanes=1)
        counts = aca_solve_score_soa(s_soa, t_soa, pts,
                                     fused_kernel_threshold(config),
                                     point_weights=pw,
                                     scoring=config.scoring)
        h_loc, sc_loc, _ = _fused_top(counts, s4, t4, src, tar, local, None)
    else:
        h_loc, sc_loc, _ = _eval_chunk(None, src, tar, local, None, idx)

    # The consensus: the ranks' top-K, rank-major, then the global top-K
    # (ties to the lower hypothesis index, as over the whole batch) and the
    # single-device refinement, replicated.
    h_all = all_gather(mesh, axis, h_loc)
    sc_all = all_gather(mesh, axis, sc_loc)
    top = _top_k(sc_all, max(1, min(config.lo_candidates, sc_all.shape[0])))
    h_top, sc_top = h_all[top], sc_all[top]
    _, inl0 = score_hypotheses(h_top[:1], src, tar, config.threshold, None,
                               config.scoring, config.sigma_max,
                               config.df64_scoring)
    return _refine_and_pack(h_top, sc_top, inl0[0], src, tar, config, None)
