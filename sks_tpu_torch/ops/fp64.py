"""fp64 solvers and fp64 residual scoring (counterpart of ``sks_tpu/ops/df64.py``).

The TPU has no fp64, so the JAX package emulates it with double-float pairs
(``DF``, ~49 bits) and runs its solver cores on them.  The H100 has native
fp64, so the port carries over the capability and not the emulation: every
function here takes ``(..., 4, 2)`` float32 or float64 points, runs the
solver's own core in float64 and returns float64.  Nothing of ``DF`` is
ported.

``FP64_CORES`` maps the JAX package's kinds (``df64_pallas._CORES``) to the
cores: NDLT and HO take their float64 eigensolver branches
(``eig='invit64'``, ``eig_method='invit64'``), as the JAX package's DF
branches do.  Each core is the plain version of its instance of kernel K5
(``sks_tpu_torch.kernels.fp64_cuda.fp64_solve_soa``) and the specification of
that kernel's body.
"""

from __future__ import annotations

import functools

import torch
from torch import Tensor

from sks_tpu_torch.ops.aca import aca_core
from sks_tpu_torch.ops.ge import ge_core
from sks_tpu_torch.ops.gpt import gpt_core
from sks_tpu_torch.ops.ho import ho_core
from sks_tpu_torch.ops.ndlt import ndlt_core
from sks_tpu_torch.ops.sks import sks_core

__all__ = [
    "FP64_CORES",
    "aca_fp64_h",
    "aca_fp64",
    "sks_fp64_h",
    "sks_fp64",
    "ndlt_fp64_h",
    "ge_fp64_h",
    "gpt_fp64_h",
    "ho_fp64_h",
    "residual2_fp64",
    "SOLVERS_FP64_H",
]

#: JAX kind (``sks_tpu.kernels.df64_pallas`` ``kind``) -> float64 core.
FP64_CORES = {
    "aca": aca_core,
    "sks": sks_core,
    "ndlt": functools.partial(ndlt_core, eig="invit64"),
    "ge": ge_core,
    "gpt": gpt_core,
    "ho": functools.partial(ho_core, eig_method="invit64"),
}


def _fp64_h(kind: str, src: Tensor, tar: Tensor) -> Tensor:
    """The core of ``kind`` on float64 components of (..., 4, 2) points."""
    s = src.double().reshape(*src.shape[:-2], 8)
    t = tar.double().reshape(*tar.shape[:-2], 8)
    h = FP64_CORES[kind](*(s[..., i] for i in range(8)),
                         *(t[..., i] for i in range(8)))
    return torch.stack(h, dim=-1).reshape(*h[0].shape, 3, 3)


def _normalized(h: Tensor) -> Tensor:
    return h / h[..., 2:3, 2:3]


def aca_fp64_h(src: Tensor, tar: Tensor) -> Tensor:
    """Up-to-scale ACA homography in float64; stands for
    ``sks_tpu.ops.df64.aca_df64_h`` (the division-free body ``aca_core``)."""
    return _fp64_h("aca", src, tar)


def aca_fp64(src: Tensor, tar: Tensor) -> Tensor:
    """float64 ACA homography normalized to ``H[2,2] == 1``; stands for
    ``sks_tpu.ops.df64.aca_df64``."""
    return _normalized(aca_fp64_h(src, tar))


def sks_fp64_h(src: Tensor, tar: Tensor) -> Tensor:
    """Up-to-scale SKS homography in float64; stands for
    ``sks_tpu.ops.df64.sks_df64_h``."""
    return _fp64_h("sks", src, tar)


def sks_fp64(src: Tensor, tar: Tensor) -> Tensor:
    """float64 SKS homography normalized to ``H[2,2] == 1``; stands for
    ``sks_tpu.ops.df64.sks_df64``."""
    return _normalized(sks_fp64_h(src, tar))


def ndlt_fp64_h(src: Tensor, tar: Tensor) -> Tensor:
    """Minimal-set (N=4) NDLT in float64, up to scale; stands for
    ``sks_tpu.ops.df64.ndlt_df64_h`` (``df_eig='invit'``): the block
    normal matrix, a float32 Jacobi seed, float64 LDL^T inverse iteration."""
    return _fp64_h("ndlt", src, tar)


def ge_fp64_h(src: Tensor, tar: Tensor) -> Tensor:
    """RHO-GE in float64, ``H[2,2] == 1`` by construction; stands for
    ``sks_tpu.ops.df64.ge_df64_h``."""
    return _fp64_h("ge", src, tar)


def gpt_fp64_h(src: Tensor, tar: Tensor) -> Tensor:
    """GPT-LU (the pivoted Gauss-Jordan ``gpt_core``) in float64,
    ``H[2,2] == 1``; stands for ``sks_tpu.ops.df64.gpt_df64_h``."""
    return _fp64_h("gpt", src, tar)


def ho_fp64_h(src: Tensor, tar: Tensor) -> Tensor:
    """Harker-O'Leary in float64, up to scale; stands for
    ``sks_tpu.ops.df64.ho_df64_h``: the reduced 3x3 eigenproblem by a
    float32 Jacobi seed and float64 LDL^T inverse iteration."""
    return _fp64_h("ho", src, tar)


#: Solver name (as in ``ops.SOLVERS_H``) -> its float64 op, up to scale.
SOLVERS_FP64_H = {
    "aca": aca_fp64_h,
    "sks": sks_fp64_h,
    "rho_ge": ge_fp64_h,
    "gpt_lu": gpt_fp64_h,
    "ho": ho_fp64_h,
    "ndlt": ndlt_fp64_h,
}


def residual2_fp64(h: Tensor, src: Tensor, tar: Tensor) -> Tensor:
    """Symmetric-transfer squared residuals computed in float64.

    The fp64 scoring of RANSAC (``RansacConfig(df64_scoring=True)``); stands
    for ``sks_tpu.ops.df64.residual2_df64``.  H is first rescaled by the same
    exact power of two as there (its largest entry into (0.5, 1]), where the
    float32 words of the adjugate of ACA's ~1e20-scale up-to-scale H would
    overflow; the common factor cancels in every homogeneous ratio, so the
    float32 scoring's adjugate overflow (ROADMAP.md Queue C) cannot occur.

    Args:
      h: (..., 3, 3) homographies, any scale and float dtype.
      src, tar: (N, 2) correspondences.

    Returns:
      (..., N) squared forward plus reverse transfer errors, in the points'
      dtype.
    """
    h = h.double()
    m = torch.amax(torch.abs(h), dim=(-2, -1), keepdim=True)
    h = h * torch.exp2(-torch.ceil(torch.log2(torch.clamp(m, min=1e-30))))
    e = [[h[..., i, j, None] for j in range(3)] for i in range(3)]
    x, y = src[..., :, 0].double(), src[..., :, 1].double()
    xp, yp = tar[..., :, 0].double(), tar[..., :, 1].double()

    # Forward transfer.
    w = e[2][0] * x + e[2][1] * y + e[2][2]
    dx = (e[0][0] * x + e[0][1] * y + e[0][2]) / w - xp
    dy = (e[1][0] * x + e[1][1] * y + e[1][2]) / w - yp
    r2 = dx * dx + dy * dy

    # Reverse transfer through the adjugate (the inverse up to scale).
    a = [[e[1][1] * e[2][2] - e[1][2] * e[2][1],
          e[0][2] * e[2][1] - e[0][1] * e[2][2],
          e[0][1] * e[1][2] - e[0][2] * e[1][1]],
         [e[1][2] * e[2][0] - e[1][0] * e[2][2],
          e[0][0] * e[2][2] - e[0][2] * e[2][0],
          e[0][2] * e[1][0] - e[0][0] * e[1][2]],
         [e[1][0] * e[2][1] - e[1][1] * e[2][0],
          e[0][1] * e[2][0] - e[0][0] * e[2][1],
          e[0][0] * e[1][1] - e[0][1] * e[1][0]]]
    wr = a[2][0] * xp + a[2][1] * yp + a[2][2]
    dxr = (a[0][0] * xp + a[0][1] * yp + a[0][2]) / wr - x
    dyr = (a[1][0] * xp + a[1][1] * yp + a[1][2]) / wr - y
    r2 = r2 + dxr * dxr + dyr * dyr
    return r2.to(src.dtype)
