"""sks_tpu_torch — the PyTorch/CUDA port of ``sks_tpu``.

A second package beside the JAX reference: the same module names, function
names and call shapes (4-point solvers take ``(..., 4, 2)`` pairs and return
``(..., 3, 3)``; ``find_homography`` returns ``(H, mask)``), written as plain
functions on torch tensors.  The device follows the input tensors; randomness
comes from explicit ``torch.Generator`` objects.  On CUDA tensors the hot path
runs hand-written Hopper kernels (``sks_tpu_torch.kernels.aca_cuda``); on CPU
tensors each kernel's plain PyTorch version runs instead.

The port covers the robust homography fit (``find_homography`` with its fused
ACA solve+score kernel) and the batched ACA solve; the rest of ``sks_tpu``
follows slice by slice (see ROADMAP.md).
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
    aca_h,
    ndlt,
    ndlt_h,
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

__all__ = [
    "SOLVERS",
    "SOLVERS_H",
    "aca",
    "aca_h",
    "ndlt",
    "ndlt_h",
    "solve_h",
    "find_homography",
    "get_affine_transform",
    "get_perspective_transform",
    "apply_homography",
    "reprojection_error",
    "symmetric_transfer_error",
]

__version__ = "0.1.0"
