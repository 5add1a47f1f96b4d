"""Distributed pose-graph optimization: edge-sharded Gauss-Newton.

Port of ``sks_tpu/parallel/sharded_posegraph.py``.  Every Gauss-Newton
quantity is a sum over edges,

    g   = Jᵀ r    = sum_e J_eᵀ r_e
    H v = Jᵀ J v  = sum_e J_eᵀ (J_e v),

so the edges split across the ranks.  The poses (K x 6 DOF) are replicated;
each rank evaluates residuals, JVPs and VJPs (``torch.func``) of its edges
only, and one ``all_reduce`` of a (K, 6) vector completes each CG matvec.
The gauge prior on node 0 (``fix_first``) belongs to no edge: it is added
once, analytically, after the reduction (the single-device form carries it
as extra residual rows, ``slam.posegraph._residual_fn``).
"""

from __future__ import annotations

import torch

from sks_tpu_torch.geom.lie import mm_small, se3_exp
from sks_tpu_torch.parallel.mesh import Mesh, psum
from sks_tpu_torch.slam.posegraph import PoseGraph, _cg, posegraph_residuals

__all__ = ["sharded_optimize_posegraph", "shard_graph"]


def shard_graph(graph: PoseGraph, mesh: Mesh, axis="edge") -> PoseGraph:
    """This rank's block of the edges (edges, measurements, weights), with
    the poses replicated, on the mesh's device.

    The edges are padded to a multiple of the axis size with disabled edges
    (0 -> 0, identity measurement, weight 0), the fixed-shape padding the
    rest of the stack uses.
    """
    dev = mesh.device
    edges, meas, weights = (x.to(dev) for x in (graph.edges, graph.meas,
                                                 graph.weights))
    pad = -edges.shape[0] % mesh.size(axis)
    if pad:
        edges = torch.cat([edges, edges.new_zeros((pad, 2))])
        meas = torch.cat([meas, torch.eye(4, dtype=meas.dtype, device=dev)
                          .expand(pad, 4, 4)])
        weights = torch.cat([weights, weights.new_zeros((pad,))])
    blk = mesh.block(edges.shape[0], axis)
    return PoseGraph(poses=graph.poses.to(dev), edges=edges[blk],
                     meas=meas[blk], weights=weights[blk])


def sharded_optimize_posegraph(
    mesh: Mesh,
    graph: PoseGraph,
    gn_iters: int = 10,
    cg_iters: int = 50,
    damping: float = 1e-6,
    fix_first: bool = True,
    axis="edge",
) -> PoseGraph:
    """Edge-sharded matrix-free Gauss-Newton of a :func:`shard_graph` shard:
    ``slam.posegraph.optimize_posegraph`` up to the order of the edge sums.
    Returns the shard with the new (replicated) poses."""
    k = graph.poses.shape[0]
    poses = graph.poses
    gauge = 1e3 if fix_first else 0.0  # the single form's gauge-row scale
    for _ in range(gn_iters):
        zero = torch.zeros((k, 6), dtype=poses.dtype, device=poses.device)
        local = PoseGraph(poses, graph.edges, graph.meas, graph.weights)

        def res(dx, local=local):
            # The shard's edge residuals only: no gauge rows.
            return posegraph_residuals(local, dx).reshape(-1)

        r0, vjp = torch.func.vjp(res, zero)
        # The prior's gradient at dx = 0 is 0: only its matvec term remains.
        g = psum(mesh, axis, vjp(r0)[0])

        def jtjv(v, res=res, vjp=vjp, zero=zero):
            vk = v.reshape(k, 6)
            _, jv = torch.func.jvp(res, (zero,), (vk,))
            h = psum(mesh, axis, vjp(jv)[0])
            # Jᵀ J v of the rows gauge * dx[0], rounded as the single form
            # rounds them.
            h = torch.cat([h[:1] + gauge * (gauge * vk[:1]), h[1:]])
            return (h + damping * vk).reshape(-1)

        dx = _cg(jtjv, -g.reshape(-1), cg_iters).reshape(k, 6)
        poses = mm_small(poses, se3_exp(dx))
    return PoseGraph(poses=poses, edges=graph.edges, meas=graph.meas,
                     weights=graph.weights)
