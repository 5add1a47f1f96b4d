"""The plain reference of a robust homography fit.

Plain PyTorch, written from the method's description and not from the
program: uniform draws of minimal sets, the exact 4-point solve of each,
inlier counting by the symmetric transfer error, the best count's model
refitted twice by a weighted normalized DLT on its consensus, then a
Levenberg-Marquardt polish of the forward reprojection error on the
consensus at 1.0, 0.7 and 0.5 times the threshold, and the final mask at the
threshold.  It computes in the dtype it is given (float64 for the
reference, bfloat16 for the control): every elementwise operation and
reduction runs in that dtype, and only the small dense solves (8 x 8, 9 x 9)
run in float32 where the dtype has none, their results rounded back.

Nothing here raises on a degenerate consensus: a step whose solve fails, or
whose result is not finite, or that has fewer than 8 points of consensus,
leaves the model as it was.
"""

from __future__ import annotations

import torch
from torch import Tensor

#: Dtypes the dense solves run in directly; others go through float32.
_SOLVE_DTYPES = (torch.float32, torch.float64)


def _wide(dtype):
    return dtype if dtype in _SOLVE_DTYPES else torch.float32


def _solve(a: Tensor, b: Tensor) -> Tensor:
    """``solve(a, b)`` in the solve dtype, NaN where it fails."""
    wide = _wide(a.dtype)
    x, info = torch.linalg.solve_ex(a.to(wide), b.to(wide)[..., None])
    x = torch.where((info == 0)[..., None, None], x,
                    torch.full_like(x, torch.nan))
    return x[..., 0].to(a.dtype)


def _smallest_eigvec(m: Tensor) -> Tensor | None:
    """The eigenvector of the symmetric ``m`` with the smallest eigenvalue,
    or None where the eigensolver fails."""
    wide = _wide(m.dtype)
    if not bool(torch.isfinite(m).all()):
        return None
    try:
        _, v = torch.linalg.eigh(m.to(wide))
    except RuntimeError:  # torch.linalg.LinAlgError: no convergence
        return None
    return v[..., 0].to(m.dtype)


def apply_h(h: Tensor, pts: Tensor) -> Tensor:
    """(..., 3, 3) applied to (N, 2): (..., N, 2)."""
    x, y = pts[..., 0], pts[..., 1]
    hb = h[..., None, :, :]
    w = hb[..., 2, 0] * x + hb[..., 2, 1] * y + hb[..., 2, 2]
    u = (hb[..., 0, 0] * x + hb[..., 0, 1] * y + hb[..., 0, 2]) / w
    v = (hb[..., 1, 0] * x + hb[..., 1, 1] * y + hb[..., 1, 2]) / w
    return torch.stack([u, v], dim=-1)


def adjugate(h: Tensor) -> Tensor:
    """The inverse of a homography up to scale."""
    a, b, c = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    d, e, f = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    g, i, j = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]
    return torch.stack([
        torch.stack([e * j - f * i, c * i - b * j, b * f - c * e], -1),
        torch.stack([f * g - d * j, a * j - c * g, c * d - a * f], -1),
        torch.stack([d * i - e * g, b * g - a * i, a * e - b * d], -1),
    ], dim=-2)


def sym_r2(h: Tensor, src: Tensor, tar: Tensor) -> Tensor:
    """Squared symmetric transfer error (..., N); +inf where not finite."""
    d1 = apply_h(h, src) - tar
    d2 = apply_h(adjugate(h), tar) - src
    r2 = (d1 * d1).sum(-1) + (d2 * d2).sum(-1)
    return torch.where(torch.isfinite(r2), r2, torch.full_like(r2, torch.inf))


def solve_minimal(s4: Tensor, t4: Tensor) -> Tensor:
    """Exact homographies (B, 3, 3) of minimal sets (B, 4, 2): the 8 x 8
    DLT with H[2, 2] = 1; NaN where it is singular."""
    x, y = s4[..., 0], s4[..., 1]
    u, v = t4[..., 0], t4[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    rows_u = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    rows_v = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    h = _solve(torch.cat([rows_u, rows_v], dim=-2), torch.cat([u, v], -1))
    return torch.cat([h, torch.ones_like(h[..., :1])], -1).reshape(
        *h.shape[:-1], 3, 3)


def best_hypothesis(src, tar, valid, threshold, hypotheses, generator,
                    block: int = 16384) -> Tensor | None:
    """The model of the highest inlier count (the first among ties) over
    ``hypotheses`` uniform draws of four valid points; None with fewer than
    four valid points."""
    pool = torch.nonzero(valid).flatten()
    t2 = threshold * threshold
    best_h, best_n = None, -1
    if pool.numel() < 4:
        return best_h
    for start in range(0, hypotheses, block):
        b = min(block, hypotheses - start)
        pick = torch.randint(0, pool.numel(), (b, 4), generator=generator,
                             device=generator.device).to(src.device)
        idx = pool[pick]
        h = solve_minimal(src[idx], tar[idx])
        counts = ((sym_r2(h, src, tar) < t2) & valid).sum(-1)
        i = int(torch.argmax(counts))
        if int(counts[i]) > best_n:
            best_h, best_n = h[i], int(counts[i])
    return best_h


def _hartley(pts: Tensor, w: Tensor):
    """Weighted centroid and the scale that brings the weighted mean
    distance to sqrt(2); returns (normalized points, T (3, 3))."""
    mass = w.sum()
    c = (pts * w[:, None]).sum(0) / mass
    dist = torch.sqrt(((pts - c) ** 2).sum(-1))
    s = 1.4142135623730951 / ((dist * w).sum() / mass)
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    t = torch.stack([torch.stack([s, zero, -s * c[0]]),
                     torch.stack([zero, s, -s * c[1]]),
                     torch.stack([zero, zero, one])])
    return (pts - c) * s, t


def _inv_t(t: Tensor) -> Tensor:
    s, cx, cy = t[0, 0], -t[0, 2] / t[0, 0], -t[1, 2] / t[0, 0]
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    return torch.stack([torch.stack([1 / s, zero, cx]),
                        torch.stack([zero, 1 / s, cy]),
                        torch.stack([zero, zero, one])])


def weighted_dlt(src: Tensor, tar: Tensor, w: Tensor) -> Tensor | None:
    """The normalized DLT of the points of weight ``w`` (N,)."""
    sn, t1 = _hartley(src, w)
    tn, t2 = _hartley(tar, w)
    x, y = sn[:, 0], sn[:, 1]
    u, v = tn[:, 0], tn[:, 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    a = torch.cat([
        torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1),
        torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1),
    ])
    ww = torch.cat([w, w])
    vec = _smallest_eigvec((a * ww[:, None]).T @ a)
    if vec is None:
        return None
    return _inv_t(t2) @ vec.reshape(3, 3) @ t1


def _normal_equations(p: Tensor, sn: Tensor, tn: Tensor, w: Tensor):
    """J^T W J, J^T W r and the cost of the forward residual
    ``H(src) - tar`` over the 8 parameters of H with H[2, 2] = 1."""
    x, y = sn[:, 0], sn[:, 1]
    px = p[0] * x + p[1] * y + p[2]
    py = p[3] * x + p[4] * y + p[5]
    pz = p[6] * x + p[7] * y + 1.0
    rx, ry = px / pz - tn[:, 0], py / pz - tn[:, 1]
    zero = torch.zeros_like(x)
    jx = torch.stack([x / pz, y / pz, 1 / pz, zero, zero, zero,
                      -px * x / pz ** 2, -px * y / pz ** 2], -1)
    jy = torch.stack([zero, zero, zero, x / pz, y / pz, 1 / pz,
                      -py * x / pz ** 2, -py * y / pz ** 2], -1)
    a = (jx * w[:, None]).T @ jx + (jy * w[:, None]).T @ jy
    g = (jx * (w * rx)[:, None]).sum(0) + (jy * (w * ry)[:, None]).sum(0)
    return a, g, (w * (rx * rx + ry * ry)).sum()


def levenberg_marquardt(h: Tensor, src: Tensor, tar: Tensor, w: Tensor,
                        iters: int = 30) -> Tensor:
    """Weighted LM of the forward reprojection error from ``h``, on points
    normalized as :func:`_hartley` does."""
    sn, t1 = _hartley(src, w)
    tn, t2 = _hartley(tar, w)
    hn = t2 @ h @ _inv_t(t1)
    hn = hn / hn[2, 2]
    p = hn.flatten()[:8]
    lam = 1e-3
    a, g, cost = _normal_equations(p, sn, tn, w)
    for _ in range(iters):
        damped = a + lam * torch.diag(torch.diag(a))
        step = _solve(damped, -g)
        a_new, g_new, cost_new = _normal_equations(p + step, sn, tn, w)
        if bool(torch.isfinite(cost_new)) and bool(cost_new < cost):
            p, a, g, cost = p + step, a_new, g_new, cost_new
            lam = max(lam * 0.3, 1e-10)
        else:
            lam *= 10.0
    hn = torch.cat([p, torch.ones_like(p[:1])]).reshape(3, 3)
    return _inv_t(t2) @ hn @ t1


def _finite(h) -> bool:
    return h is not None and bool(torch.isfinite(h).all())


def fit(src: Tensor, tar: Tensor, threshold: float, hypotheses: int,
        generator: torch.Generator, dtype=torch.float64,
        valid: Tensor | None = None):
    """The reference fit of (N, 2) matches: (H (3, 3) with H[2, 2] = 1,
    mask (N,) bool), computed in ``dtype``."""
    src, tar = src.to(dtype), tar.to(dtype)
    if valid is None:
        valid = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
    h = best_hypothesis(src, tar, valid, threshold, hypotheses, generator)
    if not _finite(h):
        h = torch.eye(3, dtype=dtype, device=src.device)
    for _ in range(2):
        w = (sym_r2(h, src, tar) < threshold * threshold) & valid
        if int(w.sum()) >= 8:
            h_new = weighted_dlt(src, tar, w.to(dtype))
            if _finite(h_new):
                h = h_new / h_new[2, 2]
    for level in (1.0, 0.7, 0.5):
        limit = 2.0 * (level * threshold) ** 2
        w = (sym_r2(h, src, tar) < limit) & valid
        if int(w.sum()) >= 8:
            h_new = levenberg_marquardt(h, src, tar, w.to(dtype))
            if _finite(h_new):
                h = h_new / h_new[2, 2]
    mask = (sym_r2(h, src, tar) < threshold * threshold) & valid
    return h / h[2, 2], mask


def corner_gap(h_a: Tensor, h_b: Tensor, width: float, height: float
               ) -> float:
    """The largest distance, in pixels, between where two homographies put
    the image's four corners; +inf where either is not finite."""
    quad = torch.tensor([[0.0, 0.0], [width, 0.0], [width, height],
                         [0.0, height]], dtype=torch.float64)
    a = apply_h(h_a.double().cpu(), quad)
    b = apply_h(h_b.double().cpu(), quad)
    gap = torch.sqrt(((a - b) ** 2).sum(-1)).max()
    return float(gap) if bool(torch.isfinite(gap)) else float("inf")
