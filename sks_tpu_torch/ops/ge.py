"""RHO-GE — 4-point homography by pivot-free Gaussian elimination (batched).

Port of ``sks_tpu/ops/ge.py`` (the block structure it exploits is derived
in that module's docstring): the 8x8 system of GPT-LU, eliminated in a fixed
order with no pivoting, the two 4x4 diagonal blocks by a Cramer solve that
shares one 3x3 determinant, coupled through (h7, h8) by a 2x2 solve.
:func:`ge_core` is the eager op, the plain version of the CUDA kernel
``ge_solve_soa`` (``sks_tpu_torch.kernels.baselines_cuda``) and the
specification of that kernel's body (``csrc/baselines.cu``).
"""

from __future__ import annotations

import torch
from torch import Tensor

__all__ = ["ge_core", "rho_ge"]


def ge_core(
    x0, y0, x1, y1, x2, y2, x3, y3,
    X0, Y0, X1, Y1, X2, Y2, X3, Y3,
):
    """Straight-line RHO-GE on scalar-like components (flat point order).

    Returns the 9 homography entries row-major with ``H[2,2] == 1`` by
    construction.  No pivoting: a configuration that puts a zero on the fixed
    pivot chain gives non-finite entries, as in the reference.
    """
    # Cramer solve of [x y 1] u = r over the first three points; the 3x3
    # determinant is shared by all six right-hand sides.
    det = x0 * (y1 - y2) - y0 * (x1 - x2) + (x1 * y2 - x2 * y1)
    inv = 1.0 / det

    def solve3(r0, r1, r2):
        u0 = (r0 * (y1 - y2) - y0 * (r1 - r2) + (r1 * y2 - r2 * y1)) * inv
        u1 = (x0 * (r1 - r2) - r0 * (x1 - x2) + (x1 * r2 - x2 * r1)) * inv
        u2 = (x0 * (y1 * r2 - y2 * r1) - y0 * (x1 * r2 - x2 * r1)
              + r0 * (x1 * y2 - x2 * y1)) * inv
        return u0, u1, u2

    # u(g) = u0 + h7 ux + h8 uy with g = (h7, h8); the same for v.
    u0 = solve3(X0, X1, X2)
    ux = solve3(x0 * X0, x1 * X1, x2 * X2)
    uy = solve3(y0 * X0, y1 * X1, y2 * X2)
    v0 = solve3(Y0, Y1, Y2)
    vx = solve3(x0 * Y0, x1 * Y1, x2 * Y2)
    vy = solve3(y0 * Y0, y1 * Y1, y2 * Y2)

    def row(u):
        return u[0] * x3 + u[1] * y3 + u[2]

    # The fourth point's two constraints give the 2x2 system in (h7, h8).
    a11 = row(ux) - x3 * X3
    a12 = row(uy) - y3 * X3
    b1 = X3 - row(u0)
    a21 = row(vx) - x3 * Y3
    a22 = row(vy) - y3 * Y3
    b2 = Y3 - row(v0)

    det2 = a11 * a22 - a12 * a21
    inv2 = 1.0 / det2
    h7 = (b1 * a22 - b2 * a12) * inv2
    h8 = (a11 * b2 - a21 * b1) * inv2

    h00 = u0[0] + h7 * ux[0] + h8 * uy[0]
    h01 = u0[1] + h7 * ux[1] + h8 * uy[1]
    h02 = u0[2] + h7 * ux[2] + h8 * uy[2]
    h10 = v0[0] + h7 * vx[0] + h8 * vy[0]
    h11 = v0[1] + h7 * vx[1] + h8 * vy[1]
    h12 = v0[2] + h7 * vx[2] + h8 * vy[2]
    return h00, h01, h02, h10, h11, h12, h7, h8, torch.ones_like(h7)


def _components(pts: Tensor):
    p = pts.reshape(*pts.shape[:-2], 8)
    return tuple(p[..., i] for i in range(8))


def rho_ge(src: Tensor, tar: Tensor) -> Tensor:
    """4-point homography with ``H[2,2] == 1``, pivot-free fixed elimination.

    Args:
      src, tar: (..., 4, 2).

    Returns:
      (..., 3, 3).  Degenerate configurations that place a zero on the fixed
      pivot chain give non-finite output (as in the reference).
    """
    h = ge_core(*_components(src), *_components(tar))
    return torch.stack(h, dim=-1).reshape(*h[0].shape, 3, 3)
