"""Distributed bundle adjustment: landmark-sharded Schur assembly.

Port of ``sks_tpu/parallel/sharded_ba.py``.  Every term of the Schur system

    S   = B - sum_l E_l C_l^{-1} E_l^T        (6K, 6K)
    rhs = v - sum_l E_l C_l^{-1} w_l          (6K,)

is a sum over landmarks (``B`` and ``v`` over observations, which split
with their landmarks), so the landmarks split across the ranks: each rank
linearizes its block (``slam.ba.build_normal_blocks``), one ``all_reduce``
assembles the camera system, every rank solves the same small dense system,
and the landmark back-substitution stays local.  Cameras are replicated.
"""

from __future__ import annotations

import torch

from sks_tpu_torch.geom.lie import se3_exp
from sks_tpu_torch.parallel.mesh import Mesh, all_gather, psum
from sks_tpu_torch.slam.ba import BAProblem, build_normal_blocks

__all__ = ["gather_problem", "shard_problem", "sharded_gauss_newton_step"]


def shard_problem(problem: BAProblem, mesh: Mesh, axis="lm") -> BAProblem:
    """This rank's block of the landmarks (points, and the observations and
    mask of them), with the poses and intrinsics replicated, on the mesh's
    device.  The landmark count must be a multiple of the axis size (pad
    with landmarks of mask 0)."""
    blk = mesh.block(problem.points.shape[0], axis)
    dev = mesh.device
    return BAProblem(poses=problem.poses.to(dev),
                     points=problem.points[blk].to(dev),
                     intrinsics=problem.intrinsics.to(dev),
                     obs=problem.obs[:, blk].to(dev),
                     mask=problem.mask[:, blk].to(dev))


def gather_problem(problem: BAProblem, mesh: Mesh, axis="lm") -> BAProblem:
    """The inverse of :func:`shard_problem`: the whole problem, on every
    rank (for checks and ``slam.ba.rms_reprojection``)."""
    return BAProblem(poses=problem.poses,
                     points=all_gather(mesh, axis, problem.points),
                     intrinsics=problem.intrinsics,
                     obs=all_gather(mesh, axis, problem.obs, dim=1),
                     mask=all_gather(mesh, axis, problem.mask, dim=1))


def sharded_gauss_newton_step(mesh: Mesh, problem: BAProblem,
                              damping: float = 1e-6, fix_first: bool = True,
                              axis="lm") -> BAProblem:
    """One GN step of a :func:`shard_problem` shard: the same step as
    ``slam.ba.gauss_newton_step`` on the whole problem, up to the order of
    the landmark sums.  Returns this rank's shard of the new problem."""
    kk = problem.poses.shape[0]
    dt, dev = problem.poses.dtype, problem.poses.device
    b, e, c, v, w = build_normal_blocks(problem)
    c = c + damping * torch.eye(3, dtype=dt, device=dev)
    c_inv = torch.linalg.inv_ex(c, check_errors=False).inverse
    ec = torch.einsum("klij,ljm->klim", e, c_inv)
    s_off = torch.einsum("klim,qljm->kqij", ec, e)
    rhs_corr = torch.einsum("klim,lm->ki", ec, w)
    # The landmark sums, and B and v (observation sums), in one reduction.
    s_off, b, v, rhs_corr = psum(mesh, axis, s_off, b, v, rhs_corr)
    if fix_first:
        # The gauge on camera 0, added once, after the reduction.
        big = 1e12 * torch.eye(6, dtype=dt, device=dev)
        b = torch.cat([b[:1] + big, b[1:]])
    diag = torch.arange(kk, device=dev)
    s = (-s_off).index_put((diag, diag),
                           b + damping * torch.eye(6, dtype=dt, device=dev),
                           accumulate=True)
    s_dense = s.permute(0, 2, 1, 3).reshape(kk * 6, kk * 6)
    rhs = (v - rhs_corr).reshape(kk * 6)
    dx_c = torch.linalg.solve_ex(s_dense, rhs,
                                 check_errors=False).result.reshape(kk, 6)
    # The back-substitution is local to the shard.
    et_dx = torch.einsum("klij,ki->lj", e, dx_c)
    dx_p = torch.einsum("lij,lj->li", c_inv, w - et_dx)
    return BAProblem(poses=problem.poses @ se3_exp(dx_c),
                     points=problem.points + dx_p,
                     intrinsics=problem.intrinsics, obs=problem.obs,
                     mask=problem.mask)
