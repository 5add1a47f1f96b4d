"""sks_tpu_torch — the PyTorch/CUDA port of ``sks_tpu``.

A second package beside the JAX reference: the same module names, function
names and call shapes (4-point solvers take ``(..., 4, 2)`` pairs and return
``(..., 3, 3)``; ``find_homography`` returns ``(H, mask)``), written as plain
functions on torch tensors.  The device follows the input tensors; randomness
comes from explicit ``torch.Generator`` objects.  On CUDA tensors the hot path
runs hand-written Hopper kernels (``sks_tpu_torch.kernels``); on CPU tensors
each kernel's plain PyTorch version runs instead.

The port covers the robust homography fit (``find_homography`` with its fused
ACA solve+score kernel, the confidence early-exit loop and PROSAC sampling),
the batched 4-point solve of all six solvers of the paper's Table 8 (ACA,
SKS, RHO-GE, GPT-LU, HO, NDLT), each with its kernel, in float32 and in
native float64 (the ``*_fp64`` ops, fp64 RANSAC scoring, kernel K5), the
rectangle solvers (``aca_rect``) and the SKS / ACA factors, and the planar
visual-odometry pipeline from pixels to poses (``frames_to_poses``,
``planar_slam``: Harris features, descriptors, matching, batched RANSAC with
one fused-kernel launch for all pairs, the dense ESM polish of every pair,
pose recovery, chaining and the pose graph), with bundle adjustment and
checkpoints (``slam.ba``, ``slam.checkpoint``), and the learned models
(``sks_tpu_torch.models``: the four differentiable solver heads
``offsets_to_h``, ``HomographyNet`` and the iterative IHN with their train
steps); the rest of ``sks_tpu`` follows slice by slice (see ROADMAP.md).
"""

import os as _os

import torch as _torch

# Geometry arithmetic must run float32 products in full float32: a
# reduced-precision product (TF32 keeps ~10 mantissa bits) puts ~0.1% error on
# every 3x3 homography product, and bf16-grade products were measured
# collapsing a 205-inlier consensus to 53 through one denormalization in the
# JAX package.  Mirrors ``sks_tpu/__init__.py``; host applications that manage
# their own precision opt out with ``SKS_TPU_NO_GLOBAL_PRECISION=1``.
if not _os.environ.get("SKS_TPU_NO_GLOBAL_PRECISION"):
    _torch.backends.cuda.matmul.allow_tf32 = False
    _torch.backends.cudnn.allow_tf32 = False
    _torch.set_float32_matmul_precision("highest")

from sks_tpu_torch.ops import (  # noqa: E402
    SOLVERS,
    SOLVERS_H,
    aca,
    aca_factors,
    aca_fp64,
    aca_fp64_h,
    aca_h,
    aca_rect,
    aca_rect_h,
    ge_fp64_h,
    gpt_fp64_h,
    gpt_lu,
    ho,
    ho_fp64_h,
    ho_h,
    ndlt,
    ndlt_fp64_h,
    ndlt_h,
    residual2_fp64,
    rho_ge,
    sks,
    sks_factors,
    sks_fp64,
    sks_fp64_h,
    sks_h,
    sks_kernel_chain,
    solve_h,
)
from sks_tpu_torch.robust.api import (  # noqa: E402
    find_homography,
    get_affine_transform,
    get_perspective_transform,
)
from sks_tpu_torch.geom.homography import (  # noqa: E402
    apply_homography,
    reprojection_error,
    symmetric_transfer_error,
)
from sks_tpu_torch.slam.odometry import vo_trajectory  # noqa: E402
from sks_tpu_torch.slam.pipeline import frames_to_poses, planar_slam  # noqa: E402
from sks_tpu_torch.slam.posegraph import ate_rmse, optimize_posegraph  # noqa: E402

__all__ = [
    "SOLVERS",
    "SOLVERS_H",
    "aca",
    "aca_h",
    "aca_rect",
    "aca_rect_h",
    "sks",
    "sks_h",
    "rho_ge",
    "gpt_lu",
    "ho",
    "ho_h",
    "ndlt",
    "ndlt_h",
    "solve_h",
    "aca_factors",
    "sks_factors",
    "sks_kernel_chain",
    "aca_fp64_h",
    "aca_fp64",
    "sks_fp64_h",
    "sks_fp64",
    "ndlt_fp64_h",
    "ge_fp64_h",
    "gpt_fp64_h",
    "ho_fp64_h",
    "residual2_fp64",
    "find_homography",
    "get_affine_transform",
    "get_perspective_transform",
    "apply_homography",
    "reprojection_error",
    "symmetric_transfer_error",
    "frames_to_poses",
    "planar_slam",
    "vo_trajectory",
    "optimize_posegraph",
    "ate_rmse",
]

__version__ = "0.1.0"
