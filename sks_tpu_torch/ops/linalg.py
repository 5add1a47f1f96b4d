"""Batched small-matrix linear algebra (port of ``sks_tpu/ops/linalg.py``).

This slice brings the two pieces the weighted NDLT refit needs:
:func:`mm_highest` and the fixed-sweep cyclic Jacobi eigensolver
:func:`jacobi_eigh`.  Both broadcast over leading batch dimensions and
preserve dtype.
"""

from __future__ import annotations

import torch
from torch import Tensor

__all__ = ["mm_highest", "jacobi_eigh"]


def mm_highest(a: Tensor, b: Tensor) -> Tensor:
    """Full-float32 matmul.

    The package pins float32 products to full precision at import (TF32 off);
    this name marks the small geometry contractions that depend on it, as the
    JAX package's ``precision='highest'`` call sites do.
    """
    return torch.matmul(a, b)


def jacobi_eigh(a: Tensor, sweeps: int = 8):
    """Eigendecomposition of small symmetric matrices by cyclic Jacobi.

    Branch-free fixed-sweep Jacobi: every (p, q) pair is rotated each sweep
    with an angle that is exactly zero when the off-diagonal entry is zero, so
    no convergence test (and no host sync) is needed.  For 9x9 inputs, 8
    sweeps reach fp32 roundoff.  The rotation is written overflow-free, as in
    the JAX package: ``t = sign(tau) * apq / (|tau| + sqrt(tau^2 + apq^2))``.

    Args:
      a: (..., n, n) symmetric.
      sweeps: number of full cyclic sweeps.

    Returns:
      (eigenvalues (..., n) ascending, eigenvectors (..., n, n) columns).
    """
    n = a.shape[-1]
    a = a.clone()
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    # Smallest normal; added (un-squared: tiny**2 underflows to 0) under the
    # hypot sqrt so an already-diagonal pair gives t = 0/sqrt(tiny), not 0/0.
    tiny = torch.finfo(a.dtype).tiny
    pairs = [(p, q) for p in range(n) for q in range(p + 1, n)]

    for _ in range(sweeps):
        for p, q in pairs:
            app = a[..., p, p]
            aqq = a[..., q, q]
            apq = a[..., p, q]
            tau = (aqq - app) * 0.5
            sgn = torch.where(tau >= 0, 1.0, -1.0).to(a.dtype)
            hyp = torch.sqrt(tau * tau + apq * apq + tiny)
            t = sgn * apq / (sgn * tau + hyp)
            c = 1.0 / torch.sqrt(t * t + 1)
            s = t * c
            c_, s_ = c[..., None], s[..., None]

            # Both new rows (columns) are computed before either is written:
            # the slices are views of the matrix being updated.
            rp = a[..., p, :]
            rq = a[..., q, :]
            new_p, new_q = c_ * rp - s_ * rq, s_ * rp + c_ * rq
            a[..., p, :] = new_p
            a[..., q, :] = new_q
            cp = a[..., :, p]
            cq = a[..., :, q]
            new_p, new_q = c_ * cp - s_ * cq, s_ * cp + c_ * cq
            a[..., :, p] = new_p
            a[..., :, q] = new_q
            vp = v[..., :, p]
            vq = v[..., :, q]
            new_p, new_q = c_ * vp - s_ * vq, s_ * vp + c_ * vq
            v[..., :, p] = new_p
            v[..., :, q] = new_q

    w = torch.diagonal(a, dim1=-2, dim2=-1)
    w, order = torch.sort(w, dim=-1, stable=True)
    v = torch.gather(v, -1, order[..., None, :].expand(v.shape))
    return w, v
