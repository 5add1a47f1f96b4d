"""Differentiable solver heads: 4-corner offsets -> homography.

Port of ``sks_tpu/models/heads.py``.  The reference's PyTorch stack compares
solver *heads* for deep homography networks
(``PyTorch Codes/Modules_Runtime_Test.py``): TensorDLT (an 8x8 solve),
TensorGE (batched RHO Gaussian elimination) and TensorACA_rect (the paper's
contribution).  All consume the "4-point parameterization": an axis-aligned
source rectangle plus per-corner offsets.  Every head here is one function
over the port's batched ops, selected by name, and each backpropagates to
the offsets (closed-form ACA-rect; unrolled Gauss-Jordan and Jacobi, which
take out-of-place writes under autograd, for the DLT and NDLT heads; masked
elimination for GE).
"""

from __future__ import annotations

from torch import Tensor

from sks_tpu_torch.ops.aca_rect import aca_rect, aca_rect_h, rect_corners
from sks_tpu_torch.ops.ge import rho_ge
from sks_tpu_torch.ops.gpt import gpt_lu
from sks_tpu_torch.ops.ndlt import ndlt

__all__ = ["offsets_to_h", "HEAD_METHODS"]

#: head name -> reference counterpart (Modules_Runtime_Test.py function).
HEAD_METHODS = {
    "aca_rect": "TensorACA_rect (:286-309)",
    "dlt": "TensorDLT_1 / TensorDLT_2 (:43-101; same 8x8 system, LU here)",
    "ge": "TensorGE (:107-283)",
    "ndlt": "(no reference twin; normalized least-squares head)",
}


def offsets_to_h(
    offsets: Tensor,
    origin: Tensor,
    size: Tensor,
    method: str = "aca_rect",
    normalize: bool = True,
) -> Tensor:
    """Homography from the 4-point offset parameterization.

    Args:
      offsets: (..., 4, 2) predicted corner displacements, in
        :func:`rect_corners` order [M, N, P, Q].
      origin: (..., 2) source rect top-left (x0, y0).
      size: (..., 2) source rect (width, height).
      method: one of :data:`HEAD_METHODS`.
      normalize: divide by H[2,2]; only ``aca_rect`` can skip it (the warp is
        scale-invariant, ``ACA_rect.m:33-36``), the other heads normalize.

    Returns:
      (..., 3, 3) homography mapping rect corners onto corners + offsets.
    """
    corners = rect_corners(origin, size)
    tar = corners + offsets
    if method == "aca_rect":
        return (
            aca_rect(tar, origin, size)
            if normalize
            else aca_rect_h(tar, origin, size)
        )
    if method == "dlt":
        return gpt_lu(corners, tar)
    if method == "ge":
        return rho_ge(corners, tar)
    if method == "ndlt":
        return ndlt(corners, tar)
    raise ValueError(f"unknown head {method!r}; options: {sorted(HEAD_METHODS)}")
