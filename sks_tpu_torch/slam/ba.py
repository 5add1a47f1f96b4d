"""Bundle adjustment with Schur-complement reduction (batched).

Port of ``sks_tpu/slam/ba.py`` (single device).  Problem: K camera poses
(SE(3) tangent increments), L 3-D landmarks, masked observations (K, L, 2).
Gauss-Newton with the classic two-block structure:

    [ B   E ] [dx_c]   [ v ]          B: (K, 6, 6) camera blocks
    [ E^T C ] [dx_p] = [ w ]          C: (L, 3, 3) landmark blocks (block-diag)

Landmarks are eliminated in closed form (3x3 inverses), leaving the Schur
system ``S dx_c = v - E C^{-1} w`` with ``S = B - E C^{-1} E^T``: dense
(6K, 6K), solved on the device.  The per-observation Jacobians come from
``torch.func.jacfwd`` under ``torch.func.vmap``, as the JAX package's come
from ``jax.jacfwd``.  The 3x3 block inverses and the Schur solve are
library calls (``inv_ex``, ``solve_ex``), which return inf/NaN on a singular
block as ``jnp.linalg`` does, and never read the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor
from torch.func import jacfwd, vmap

from sks_tpu_torch.geom.lie import se3_exp

__all__ = ["BAProblem", "ba_residuals", "build_normal_blocks",
           "schur_reduce_solve", "gauss_newton_step", "run_ba",
           "rms_reprojection", "synth_ba_problem"]


@dataclass
class BAProblem:
    """Fixed-shape BA problem.

    poses: (K, 4, 4) world->camera transforms.
    points: (L, 3) world landmarks.
    intrinsics: (3, 3) shared K matrix.
    obs: (K, L, 2) observed pixels.
    mask: (K, L) observation validity (0/1 float).
    """

    poses: Tensor
    points: Tensor
    intrinsics: Tensor
    obs: Tensor
    mask: Tensor


def _project(pose: Tensor, point: Tensor, k: Tensor) -> Tensor:
    """World point -> pixel under pose (4, 4) and intrinsics (3, 3)."""
    pc = pose[..., :3, :3] @ point[..., None] + pose[..., :3, 3:4]
    pc = pc[..., 0]
    uv = (k @ pc[..., None])[..., 0]
    return uv[..., :2] / uv[..., 2:3]


def ba_residuals(problem: BAProblem, dx_c: Tensor | None = None,
                 dx_p: Tensor | None = None) -> Tensor:
    """Masked reprojection residuals (K, L, 2).

    dx_c (K, 6) / dx_p (L, 3) are optional local increments (right-perturbed
    poses, additive points).
    """
    poses = problem.poses
    if dx_c is not None:
        poses = poses @ se3_exp(dx_c)
    points = problem.points if dx_p is None else problem.points + dx_p
    uv = _project(poses[:, None], points[None, :], problem.intrinsics)
    return (uv - problem.obs) * problem.mask[..., None]


def build_normal_blocks(problem: BAProblem):
    """Per-observation Jacobians -> GN blocks (B, E, C, v, w).

    Jacobians come from ``torch.func.jacfwd`` of the per-observation residual
    in the local increment, vmapped over cameras and landmarks.
    """
    k_mat = problem.intrinsics
    dt, dev = problem.poses.dtype, problem.poses.device
    zero6 = torch.zeros((6,), dtype=dt, device=dev)
    zero3 = torch.zeros((3,), dtype=dt, device=dev)

    def res_one(pose, point, obs, dc, dp):
        # se3_exp of a batch of one: forward-mode AD in torch promotes the
        # tangent of a 0-d tensor combined with a Python float to float64,
        # and an unbatched twist's angle is 0-d.
        return _project(pose @ se3_exp(dc[None])[0], point + dp, k_mat) - obs

    def jac_one(pose, point, obs):
        jc = jacfwd(lambda d: res_one(pose, point, obs, d, zero3))(zero6)
        jp = jacfwd(lambda d: res_one(pose, point, obs, zero6, d))(zero3)
        r = res_one(pose, point, obs, zero6, zero3)
        return jc, jp, r

    jac = vmap(vmap(jac_one, in_dims=(None, 0, 0)), in_dims=(0, None, 0))
    jc, jp, r = jac(problem.poses, problem.points, problem.obs)
    m = problem.mask[..., None, None]
    jc = jc * m  # (K, L, 2, 6)
    jp = jp * m  # (K, L, 2, 3)
    r = r * problem.mask[..., None]

    b = torch.einsum("klri,klrj->kij", jc, jc)  # (K, 6, 6)
    c = torch.einsum("klri,klrj->lij", jp, jp)  # (L, 3, 3)
    e = torch.einsum("klri,klrj->klij", jc, jp)  # (K, L, 6, 3)
    v = -torch.einsum("klri,klr->ki", jc, r)  # (K, 6)
    w = -torch.einsum("klri,klr->li", jp, r)  # (L, 3)
    return b, e, c, v, w


def schur_reduce_solve(b, e, c, v, w, damping: float = 1e-6):
    """Eliminate landmarks, solve the Schur system, back-substitute.

    Returns (dx_c (K, 6), dx_p (L, 3)).
    """
    kk = e.shape[0]
    dt, dev = b.dtype, b.device
    c = c + damping * torch.eye(3, dtype=dt, device=dev)
    c_inv = torch.linalg.inv_ex(c, check_errors=False).inverse  # (L, 3, 3)

    ec = torch.einsum("klij,ljm->klim", e, c_inv)  # (K, L, 6, 3)
    s = -torch.einsum("klim,qljm->kqij", ec, e)  # (K, K, 6, 6)
    diag = torch.arange(kk, device=dev)
    s = s.index_put((diag, diag),
                    b + damping * torch.eye(6, dtype=dt, device=dev),
                    accumulate=True)
    rhs = v - torch.einsum("klim,lm->ki", ec, w)  # (K, 6)

    s_dense = s.permute(0, 2, 1, 3).reshape(kk * 6, kk * 6)
    dx_c = torch.linalg.solve_ex(s_dense, rhs.reshape(kk * 6),
                                 check_errors=False).result.reshape(kk, 6)

    # Back-substitute: dx_p = C^{-1} (w - E^T dx_c).
    et_dx = torch.einsum("klij,ki->lj", e, dx_c)
    dx_p = torch.einsum("lij,lj->li", c_inv, w - et_dx)
    return dx_c, dx_p


def gauss_newton_step(problem: BAProblem, damping: float = 1e-6,
                      fix_first: bool = True) -> BAProblem:
    """One GN/LM step: linearize, Schur-solve, retract.

    ``fix_first`` gauges the problem by freezing camera 0 (removes the 6-DOF
    gauge freedom; scale is fixed by the landmarks).
    """
    b, e, c, v, w = build_normal_blocks(problem)
    if fix_first:
        big = 1e12 * torch.eye(6, dtype=b.dtype, device=b.device)
        b = torch.cat([b[:1] + big, b[1:]])
    dx_c, dx_p = schur_reduce_solve(b, e, c, v, w, damping)
    return BAProblem(
        poses=problem.poses @ se3_exp(dx_c),
        points=problem.points + dx_p,
        intrinsics=problem.intrinsics,
        obs=problem.obs,
        mask=problem.mask,
    )


def run_ba(problem: BAProblem, iters: int = 5,
           damping: float = 1e-6) -> BAProblem:
    """Fixed-iteration Gauss-Newton BA."""
    for _ in range(iters):
        problem = gauss_newton_step(problem, damping)
    return problem


def rms_reprojection(problem: BAProblem) -> Tensor:
    """RMS reprojection error over the observed (cam, point) pairs, in
    pixels per coordinate."""
    r = ba_residuals(problem)
    n = torch.clamp(problem.mask.sum(), min=1.0)
    return torch.sqrt(torch.sum(r * r) / (2 * n))


def synth_ba_problem(
    generator: torch.Generator,
    num_cams: int = 20,
    num_points: int = 10_240,
    noise_pose: float = 0.02,
    noise_pt: float = 0.05,
    noise_px: float = 0.5,
    visibility: float = 0.8,
    dtype=torch.float32,
):
    """Synthetic BA problem at arbitrary scale: (ground_truth, noisy_init).

    Cameras on a gentle arc viewing a thick planar cloud around z = 4; each
    observation is the exact projection plus ``noise_px`` pixels; a random
    ``visibility`` fraction of (cam, point) pairs is observed.  The noisy
    init perturbs poses and points.  Drawn on the generator's device, in the
    order: camera twists, landmark x-y, landmark depth, visibility, pixel
    noise, pose noise, landmark noise.
    """
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=dev)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=dev)

    k_mat = torch.tensor(
        [[600.0, 0.0, 320.0], [0.0, 600.0, 240.0], [0.0, 0.0, 1.0]],
        dtype=dtype, device=dev)
    poses_gt = se3_exp(normal(num_cams, 6) * 0.1)
    pts = torch.cat([-1.5 + 3.0 * uniform(num_points, 2),
                     4.0 + 0.2 * normal(num_points, 1)], dim=-1)
    mask = (uniform(num_cams, num_points) < visibility).to(dtype)
    gt = BAProblem(poses=poses_gt, points=pts, intrinsics=k_mat,
                   obs=torch.zeros((num_cams, num_points, 2), dtype=dtype,
                                   device=dev), mask=mask)
    obs = ba_residuals(gt)  # == projections (obs is zero above)
    obs = obs + noise_px * normal(*obs.shape)
    gt = BAProblem(poses_gt, pts, k_mat, obs, mask)
    poses0 = poses_gt @ se3_exp(normal(num_cams, 6) * noise_pose)
    pts0 = pts + noise_pt * normal(*pts.shape)
    return gt, BAProblem(poses0, pts0, k_mat, obs, mask)
