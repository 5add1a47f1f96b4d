"""Pose-graph optimization on SE(3) (batched, matrix-free Gauss-Newton).

Port of ``sks_tpu/slam/posegraph.py``.  Fixed shape: K nodes, E edges with
relative-pose measurements and weights.  Residual per edge:

    r_e = log( Z_e^{-1} . T_i^{-1} . T_j )          (6,)

The Gauss-Newton normal equations are applied matrix-free with
``torch.func.jvp`` / ``torch.func.vjp`` (products with J and J^T, no dense
J) and solved by a fixed number of conjugate-gradient steps; nothing is read
back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

from sks_tpu_torch.geom.lie import mm_small, se3_exp, se3_log

__all__ = ["PoseGraph", "posegraph_residuals", "optimize_posegraph",
           "optimize_posegraph_dense", "ate_rmse"]


@dataclass
class PoseGraph:
    """poses: (K, 4, 4); edges: (E, 2) integer (i, j); meas: (E, 4, 4) Z_ij;
    weights: (E,) nonnegative (0 disables an edge — fixed-shape padding)."""

    poses: Tensor
    edges: Tensor
    meas: Tensor
    weights: Tensor


def _inv_se3(g: Tensor) -> Tensor:
    """(..., 4, 4) rigid transforms -> their inverses."""
    r = g[..., :3, :3]
    t = g[..., :3, 3]
    rt = r.transpose(-1, -2)
    ti = -torch.sum(rt * t[..., None, :], dim=-1)
    top = torch.cat([rt, ti[..., None]], dim=-1)
    bot = torch.eye(4, dtype=g.dtype, device=g.device)[3:]
    return torch.cat([top, bot.expand(*top.shape[:-2], 1, 4)], dim=-2)


def posegraph_residuals(graph: PoseGraph, dx: Tensor | None = None) -> Tensor:
    """Weighted edge residuals (E, 6); dx (K, 6) is the GN increment."""
    poses = graph.poses
    if dx is not None:
        poses = mm_small(poses, se3_exp(dx))
    edges = graph.edges.long()
    ti = poses[edges[:, 0]]
    tj = poses[edges[:, 1]]
    err = mm_small(mm_small(_inv_se3(graph.meas), _inv_se3(ti)), tj)
    r = se3_log(err)
    return r * torch.sqrt(torch.clamp(graph.weights, min=0.0))[..., None]


def _cg(matvec, b: Tensor, iters: int, eps: float = 1e-12) -> Tensor:
    """Plain conjugate gradient, a fixed number of steps (no host reads)."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.sum(r * r)
    for _ in range(iters):
        ap = matvec(p)
        alpha = rs / torch.clamp(torch.sum(p * ap), min=eps)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.sum(r * r)
        beta = rs_new / torch.clamp(rs, min=eps)
        p = r + beta * p
        rs = rs_new
    return x


def _residual_fn(graph: PoseGraph, fix_first: bool):
    """dx (K, 6) -> the stacked residual vector the GN step minimizes."""
    def res(dx):
        r = posegraph_residuals(graph, dx).reshape(-1)
        if fix_first:
            r = torch.cat([r, 1e3 * dx[0]])
        return r

    return res


def _step(graph: PoseGraph, dx: Tensor) -> PoseGraph:
    return PoseGraph(poses=mm_small(graph.poses, se3_exp(dx)),
                     edges=graph.edges, meas=graph.meas,
                     weights=graph.weights)


def optimize_posegraph(
    graph: PoseGraph,
    gn_iters: int = 10,
    cg_iters: int = 50,
    damping: float = 1e-6,
    fix_first: bool = True,
) -> PoseGraph:
    """Matrix-free Gauss-Newton: J^T J dx = -J^T r via jvp/vjp + CG."""
    k = graph.poses.shape[0]
    for _ in range(gn_iters):
        zero = torch.zeros((k, 6), dtype=graph.poses.dtype,
                           device=graph.poses.device)
        res = _residual_fn(graph, fix_first)
        r0, vjp = torch.func.vjp(res, zero)
        g = vjp(r0)[0]  # J^T r

        def jtjv(v, res=res, vjp=vjp, zero=zero):
            _, jv = torch.func.jvp(res, (zero,), (v.reshape(k, 6),))
            return (vjp(jv)[0] + damping * v.reshape(k, 6)).reshape(-1)

        dx = _cg(jtjv, -g.reshape(-1), cg_iters).reshape(k, 6)
        graph = _step(graph, dx)
    return graph


def optimize_posegraph_dense(
    graph: PoseGraph,
    gn_iters: int = 10,
    damping: float = 1e-6,
    fix_first: bool = True,
) -> PoseGraph:
    """Dense Gauss-Newton for small graphs: one forward-mode Jacobian
    (``torch.func.jacfwd``) and a direct 6K x 6K solve per iteration.  The
    same normal equations as :func:`optimize_posegraph` at CG convergence;
    kept, as in the JAX package, as the check of the matrix-free form."""
    k = graph.poses.shape[0]
    for _ in range(gn_iters):
        zero = torch.zeros((k, 6), dtype=graph.poses.dtype,
                           device=graph.poses.device)
        res = _residual_fn(graph, fix_first)
        r0 = res(zero)
        jm = torch.func.jacfwd(res)(zero).reshape(r0.shape[0], k * 6)
        a = jm.T @ jm + damping * torch.eye(k * 6, dtype=jm.dtype,
                                            device=jm.device)
        dx = torch.linalg.solve(a, -(jm.T @ r0)).reshape(k, 6)
        graph = _step(graph, dx)
    return graph


def ate_rmse(poses_est: Tensor, poses_gt: Tensor) -> Tensor:
    """Absolute trajectory error (translation RMSE) after SE(3) alignment of
    the first pose (odometry convention)."""
    align = poses_gt[0] @ _inv_se3(poses_est[0])
    aligned = align @ poses_est
    d = aligned[:, :3, 3] - poses_gt[:, :3, 3]
    return torch.sqrt(torch.mean(torch.sum(d * d, dim=-1)))
