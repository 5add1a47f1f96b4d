"""Batched small-matrix linear algebra (port of ``sks_tpu/ops/linalg.py``).

Two forms, as in the JAX package:

* matrix form, broadcasting over leading batch dims: :func:`mm_highest`,
  :func:`jacobi_eigh`, :func:`smallest_eigvec_sym` and :func:`solve_unrolled`;
* component form, on n x n Python lists of broadcastable tensors (one
  component per matrix entry, one lane per hypothesis):
  :func:`jacobi_smallest_col_core`, :func:`invit_smallest_col_core` and
  :func:`smallest_eigvec3_core`.  These are the eigensolvers inside the
  solver cores that the CUDA kernels (``csrc/baselines.cu``) follow op for
  op, so their operation order is part of their contract: each line is one
  rounded float32 operation, and a sum is a left fold.

All functions preserve dtype.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

__all__ = [
    "mm_highest",
    "jacobi_eigh",
    "jacobi_smallest_col_core",
    "invit_smallest_col_core",
    "smallest_eigvec3_core",
    "smallest_eigvec_sym",
    "solve_unrolled",
]


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
    # Under autograd each write goes into a fresh copy, since the products
    # save views of the matrix being updated; without it the writes stay in
    # place (the IRLS refit calls this eagerly, and a copy is a launch).
    grad = torch.is_grad_enabled() and a.requires_grad
    a = a.clone()
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape).clone()
    # Smallest normal; added (un-squared: tiny**2 underflows to 0) under the
    # hypot sqrt so an already-diagonal pair gives t = 0/sqrt(tiny), not 0/0.
    tiny = torch.finfo(a.dtype).tiny
    pairs = [(p, q) for p in range(n) for q in range(p + 1, n)]
    if grad:
        # A pair whose diagonal entries and coupling all agree to within
        # rounding (tau and apq both at rounding level: a rectangle's DLT
        # normal matrix has such ties, and so has every degenerate
        # eigenspace) turns by an angle that is rounding noise, and t's
        # derivative there, ~1 / (|tau| + |apq|), amplifies the rounding
        # left in the cotangent to O(1) and beyond.  Such an angle is held
        # constant under autograd; the Frobenius norm sets the scale, as the
        # rotations keep it.
        floor = 64 * torch.finfo(a.dtype).eps * torch.linalg.matrix_norm(
            a.detach())

    for _ in range(sweeps):
        for p, q in pairs:
            app = a[..., p, p]
            aqq = a[..., q, q]
            apq = a[..., p, q]
            tau = (aqq - app) * 0.5
            sgn = torch.where(tau >= 0, 1.0, -1.0).to(a.dtype)
            hyp = torch.sqrt(tau * tau + apq * apq + tiny)
            if grad:
                den = sgn * tau + hyp
                t = sgn * apq / den
                t = torch.where(den < floor, t.detach(), t)
            else:
                t = sgn * apq / (sgn * tau + hyp)
            c = 1.0 / torch.sqrt(t * t + 1)
            s = t * c
            c_, s_ = c[..., None], s[..., None]

            # Both new rows (columns) are computed before either is written:
            # the slices are views of the matrix being updated.
            rp = a[..., p, :]
            rq = a[..., q, :]
            new_p, new_q = c_ * rp - s_ * rq, s_ * rp + c_ * rq
            if grad:
                a = a.clone()
            a[..., p, :] = new_p
            a[..., q, :] = new_q
            cp = a[..., :, p]
            cq = a[..., :, q]
            new_p, new_q = c_ * cp - s_ * cq, s_ * cp + c_ * cq
            if grad:
                a = a.clone()
            a[..., :, p] = new_p
            a[..., :, q] = new_q
            vp = v[..., :, p]
            vq = v[..., :, q]
            new_p, new_q = c_ * vp - s_ * vq, s_ * vp + c_ * vq
            if grad:
                v = v.clone()
            v[..., :, p] = new_p
            v[..., :, q] = new_q

    w = torch.diagonal(a, dim1=-2, dim2=-1)
    w, order = torch.sort(w, dim=-1, stable=True)
    v = torch.gather(v, -1, order[..., None, :].expand(v.shape))
    return w, v


def _smallest_eigvec_3x3(a: Tensor) -> Tensor:
    """Closed-form unit eigenvector of the smallest eigenvalue of symmetric 3x3.

    Analytic eigenvalues via the trigonometric (Cardano) method, eigenvector
    via the largest cross product of rows of ``A - lambda I`` (branch-free),
    then one Rayleigh-shifted adjugate inverse-iteration step (see
    ``sks_tpu.ops.linalg._smallest_eigvec_3x3`` for why).
    """
    dtype = a.dtype
    finfo = torch.finfo(dtype)
    eye = torch.eye(3, dtype=dtype, device=a.device)
    q = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / 3.0
    b = a - q[..., None, None] * eye
    p2 = torch.sum(b * b, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=finfo.tiny))
    bn = b / p[..., None, None]
    detb = (
        bn[..., 0, 0] * (bn[..., 1, 1] * bn[..., 2, 2]
                         - bn[..., 1, 2] * bn[..., 2, 1])
        - bn[..., 0, 1] * (bn[..., 1, 0] * bn[..., 2, 2]
                           - bn[..., 1, 2] * bn[..., 2, 0])
        + bn[..., 0, 2] * (bn[..., 1, 0] * bn[..., 2, 1]
                           - bn[..., 1, 1] * bn[..., 2, 0])
    )
    # Clip strictly inside (-1, 1), as the JAX package does.
    lim = 1.0 - 8 * finfo.eps
    r = torch.clamp(detb / 2.0, -lim, lim)
    phi = torch.arccos(r) / 3.0
    lam = q + 2 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    m = a - lam[..., None, None] * eye
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)
    norms = torch.sum(cands * cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    vec = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 3))[..., 0, :]
    nrm = torch.sqrt(torch.clamp(torch.sum(vec * vec, dim=-1, keepdim=True),
                                 min=finfo.tiny))
    vec = vec / nrm

    rho = torch.einsum("...i,...ij,...j->...", vec, a, vec)
    b = a - rho[..., None, None] * eye
    b00, b01, b02 = b[..., 0, 0], b[..., 0, 1], b[..., 0, 2]
    b11, b12, b22 = b[..., 1, 1], b[..., 1, 2], b[..., 2, 2]
    adj = torch.stack([
        torch.stack([b11 * b22 - b12 * b12, b02 * b12 - b01 * b22,
                     b01 * b12 - b02 * b11], dim=-1),
        torch.stack([b02 * b12 - b01 * b22, b00 * b22 - b02 * b02,
                     b01 * b02 - b00 * b12], dim=-1),
        torch.stack([b01 * b12 - b02 * b11, b01 * b02 - b00 * b12,
                     b00 * b11 - b01 * b01], dim=-1),
    ], dim=-2)
    w = torch.einsum("...ij,...j->...i", adj, vec)
    wn2 = torch.sum(w * w, dim=-1, keepdim=True)
    ok = wn2 > finfo.tiny
    w = w / torch.sqrt(torch.where(ok, wn2, torch.ones_like(wn2)))
    return torch.where(ok, w, vec)


def smallest_eigvec_sym(a: Tensor, method: str = "auto") -> Tensor:
    """Unit eigenvector for the smallest eigenvalue of a symmetric (..., n, n).

    ``method``: 'auto' (closed form for n==3, Jacobi otherwise), 'jacobi',
    'eigh' (``torch.linalg.eigh``), or 'closed3'.
    """
    n = a.shape[-1]
    if method == "auto":
        method = "closed3" if n == 3 else "jacobi"
    if method == "closed3":
        if n != 3:
            raise ValueError(f"'closed3' needs 3x3 matrices; got {n}x{n}")
        return _smallest_eigvec_3x3(a)
    if method == "jacobi":
        _, v = jacobi_eigh(a)
        return v[..., :, 0]
    if method == "eigh":
        _, v = torch.linalg.eigh(a)
        return v[..., :, 0]
    raise ValueError(f"unknown method {method!r}")


def jacobi_smallest_col_core(a, sweeps: int = 8):
    """Smallest eigenvector of a symmetric matrix given as component lists.

    The lane-parallel twin of :func:`jacobi_eigh`: ``a`` is an n x n list of
    lists of broadcastable tensors, every rotation is unrolled over the
    static (p, q) pairs, each lane runs its own Jacobi.  The full matrix is
    rotated (rows, then columns), so the two triangles evolve as the JAX
    package's do.  Returns the eigenvector column (tuple of n components) of
    the smallest diagonal entry, selected branch-free: a strict ``<``, so a
    NaN diagonal is never taken and ties keep the lower index.
    """
    n = len(a)
    one = torch.ones_like(a[0][0])
    zero = torch.zeros_like(a[0][0])
    a_ = [list(row) for row in a]
    v_ = [[one if i == j else zero for j in range(n)] for i in range(n)]
    tiny = torch.finfo(a[0][0].dtype).tiny

    for _ in range(sweeps):
        for p in range(n):
            for q in range(p + 1, n):
                app, aqq, apq = a_[p][p], a_[q][q], a_[p][q]
                # Overflow-free rotation; see the jacobi_eigh derivation.
                tau = (aqq - app) * 0.5
                sgn = torch.where(tau >= 0, 1.0, -1.0)
                hyp = torch.sqrt(tau * tau + apq * apq + tiny)
                t = sgn * apq / (sgn * tau + hyp)
                c = 1.0 / torch.sqrt(t * t + 1.0)
                s = t * c
                for j in range(n):
                    rp, rq = a_[p][j], a_[q][j]
                    a_[p][j] = c * rp - s * rq
                    a_[q][j] = s * rp + c * rq
                for i in range(n):
                    cp, cq = a_[i][p], a_[i][q]
                    a_[i][p] = c * cp - s * cq
                    a_[i][q] = s * cp + c * cq
                    vp, vq = v_[i][p], v_[i][q]
                    v_[i][p] = c * vp - s * vq
                    v_[i][q] = s * vp + c * vq

    best_w = a_[0][0]
    best = [v_[i][0] for i in range(n)]
    for j in range(1, n):
        take = a_[j][j] < best_w
        best_w = torch.where(take, a_[j][j], best_w)
        best = [torch.where(take, v_[i][j], best[i]) for i in range(n)]
    return tuple(best)


def invit_smallest_col_core(a, seed=None, shift_rel: float = 2.0 ** -22,
                            solves: int = 3, seed_sweeps: int = 3):
    """Smallest eigenvector of a symmetric PSD component matrix by shifted
    inverse iteration: unrolled LDL^T of ``A + eps I`` + chained solves.

    Port of ``sks_tpu.ops.linalg.invit_smallest_col_core`` (its docstring has
    the accuracy argument: the shift sits at ``shift_rel * trace(A)``, and
    after each solve the iterate is rescaled by the exact power of two
    ``shift_rel``, a lossless range rescale).

    Args:
      a: n x n list of lists of broadcastable tensor components (PSD).
      seed: length-n component list; None runs ``seed_sweeps`` Jacobi sweeps.
      shift_rel: diagonal shift relative to trace(a); a power of two.
      solves: inverse-iteration steps sharing the one factorization.

    Returns the eigenvector as a tuple of n components, up to scale.
    """
    n = len(a)
    if seed is None:
        seed = jacobi_smallest_col_core(a, sweeps=seed_sweeps)
    tr = a[0][0]
    for i in range(1, n):
        tr = tr + a[i][i]
    eps = tr * shift_rel
    lmat = [[None] * n for _ in range(n)]
    wmat = [[None] * n for _ in range(n)]
    d = [None] * n
    for j in range(n):
        s = a[j][j] + eps
        for k in range(j):
            s = s - lmat[j][k] * wmat[j][k]
        d[j] = s
        for i in range(j + 1, n):
            t = a[i][j]
            for k in range(j):
                t = t - lmat[i][k] * wmat[j][k]
            wmat[i][j] = t
            lmat[i][j] = t / s
    x = list(seed)
    scale = float(shift_rel)
    for _ in range(solves):
        y = []
        for i in range(n):
            yi = x[i]
            for k in range(i):
                yi = yi - lmat[i][k] * y[k]
            y.append(yi)
        z = [y[i] / d[i] for i in range(n)]
        xn = [None] * n
        for i in reversed(range(n)):
            xi = z[i]
            for k in range(i + 1, n):
                xi = xi - lmat[k][i] * xn[k]
            xn[i] = xi
        x = [v * scale for v in xn]
    return tuple(x)


def smallest_eigvec3_core(a00, a01, a02, a11, a12, a22):
    """Closed-form smallest eigenvector of symmetric 3x3 on components.

    The component-form twin of :func:`_smallest_eigvec_3x3` (trigonometric
    eigenvalue, largest row-cross eigenvector, one Rayleigh-shifted adjugate
    inverse-iteration step).  Returns (v0, v1, v2), unit norm.
    """
    finfo = torch.finfo(a00.dtype)
    tiny = finfo.tiny
    third = 1.0 / 3.0

    q = (a00 + a11 + a22) * third
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=tiny))
    inv_p = 1.0 / p
    detb = (
        (b00 * inv_p) * ((b11 * inv_p) * (b22 * inv_p)
                         - (a12 * inv_p) * (a12 * inv_p))
        - (a01 * inv_p) * ((a01 * inv_p) * (b22 * inv_p)
                           - (a12 * inv_p) * (a02 * inv_p))
        + (a02 * inv_p) * ((a01 * inv_p) * (a12 * inv_p)
                           - (b11 * inv_p) * (a02 * inv_p))
    )
    lim = 1.0 - 8 * finfo.eps
    r = torch.clamp(detb * 0.5, -lim, lim)
    phi = torch.arccos(r) * third
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    m00, m11, m22 = a00 - lam, a11 - lam, a22 - lam
    r0 = (m00, a01, a02)
    r1 = (a01, m11, a12)
    r2 = (a02, a12, m22)

    def cross(u, w):
        return (u[1] * w[2] - u[2] * w[1],
                u[2] * w[0] - u[0] * w[2],
                u[0] * w[1] - u[1] * w[0])

    def norm2(u):
        return u[0] * u[0] + u[1] * u[1] + u[2] * u[2]

    best = cross(r0, r1)
    best_n = norm2(best)
    for cand in (cross(r0, r2), cross(r1, r2)):
        cn = norm2(cand)
        take = cn > best_n
        best = tuple(torch.where(take, cand[i], best[i]) for i in range(3))
        best_n = torch.where(take, cn, best_n)
    inv_n = 1.0 / torch.sqrt(torch.clamp(best_n, min=tiny))
    v0, v1, v2 = best[0] * inv_n, best[1] * inv_n, best[2] * inv_n

    rho = (v0 * (a00 * v0 + a01 * v1 + a02 * v2)
           + v1 * (a01 * v0 + a11 * v1 + a12 * v2)
           + v2 * (a02 * v0 + a12 * v1 + a22 * v2))
    c00, c11, c22 = a00 - rho, a11 - rho, a22 - rho
    adj00 = c11 * c22 - a12 * a12
    adj01 = a02 * a12 - a01 * c22
    adj02 = a01 * a12 - a02 * c11
    adj11 = c00 * c22 - a02 * a02
    adj12 = a01 * a02 - c00 * a12
    adj22 = c00 * c11 - a01 * a01
    w0 = adj00 * v0 + adj01 * v1 + adj02 * v2
    w1 = adj01 * v0 + adj11 * v1 + adj12 * v2
    w2 = adj02 * v0 + adj12 * v1 + adj22 * v2
    wn2 = w0 * w0 + w1 * w1 + w2 * w2
    ok = wn2 > tiny
    inv_w = 1.0 / torch.sqrt(torch.where(ok, wn2, torch.ones_like(wn2)))
    return (torch.where(ok, w0 * inv_w, v0),
            torch.where(ok, w1 * inv_w, v1),
            torch.where(ok, w2 * inv_w, v2))


def solve_unrolled(a: Tensor, b: Tensor, pivot: bool = False) -> Tensor:
    """Solve small dense systems by statically unrolled Gauss-Jordan.

    The elimination order is static and vectorizes over the batch; with
    ``pivot=True`` each step swaps in the row of largest ``|pivot|`` (the
    first such row, as ``jnp.argmax``) through a one-hot product, branch-free.

    Args:
      a: (..., n, n); b: (..., n) or (..., n, k).

    Returns:
      x with b's shape.
    """
    squeeze = b.dim() == a.dim() - 1
    if squeeze:
        b = b[..., None]
    n = a.shape[-1]
    t = torch.cat([a, b], dim=-1)
    # As in jacobi_eigh: a fresh copy before each row write under autograd.
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)

    for k in range(n):
        if pivot:
            rel = torch.argmax(torch.abs(t[..., k:, k]), dim=-1)
            sel = torch.nn.functional.one_hot(rel + k, n).to(t.dtype)
            pivrow = torch.einsum("...r,...rc->...c", sel, t)
            rowk = t[..., k, :]
            t = t + sel[..., :, None] * (rowk[..., None, :]
                                         - pivrow[..., None, :])
            t[..., k, :] = pivrow
        inv = 1.0 / t[..., k, k]
        rowk = t[..., k, :] * inv[..., None]
        if grad:
            t = t.clone()
        t[..., k, :] = rowk  # t is this function's own tensor
        update = t[..., :, k, None] * rowk[..., None, :]
        keep = (torch.arange(n, device=a.device) != k)[:, None]
        t = torch.where(keep, t - update, t)

    x = t[..., n:]
    return x[..., 0] if squeeze else x
