"""The plain reference of planar SLAM: frames in, loop-closed poses out.

Plain PyTorch, written from the method's published description and not from
the program.  Detection, description and matching are ``ref_vo``'s, once a
frame, for the consecutive pairs (i, i+1) and the loop-closure pairs
(i, i+k) of each stride k; each pair is fitted by ``ref_fit.fit``.  Every
pair's model is then densely polished: the symmetric ESM of Benhimane and
Malis (IROS 2004) on SL(3), forward (frame i's border-inset template against
frame j) and backward (frame j's against frame i, from the inverse start),
each a Levenberg-Marquardt iteration on the ESM Jacobian (the mean of the
template's and the warped image's gradients) with a closed-form gain and
bias and Huber weights (scale 0.1), and the two averaged by the geodesic
midpoint H_f (H_f^-1 H_b^-1)^(1/2); coarse to fine over 2 levels (2 x 2
mean pyramid, ``iters`` iterations at half resolution with an 8-pixel
border, then ``fine_iters`` at full resolution with a 16-pixel border).  A
guard keeps the polished model only where the median symmetric transfer
error of the fit's inliers grows by no more than 10%; the pair's inlier
count is that of the model kept, at the threshold.  Then the pose of each
model (``ref_vo.pose``), the metric chain of the plane depth, each closure
scaled by the plane depth at its source frame and gated at 12 inliers, and
Gauss-Newton on the weighted SE(3) edge residuals

    r_e = sqrt(w_e) log(Z_e^-1 T_i^-1 T_j),   T <- T exp(dx),

with consecutive edges weighted by their inlier counts, closures by theirs
(0 below the gate), the first pose held by a residual 1e3 dx_0 and a
damping of 1e-6.

It computes in the dtype it is given (float64 for the reference, bfloat16
for the control); matrix inverses, exponentials, square roots and solves run
in float32 where the dtype has none, as ``ref_vo``'s do, and the guard's
medians are taken in float32 there.  TF32 is off for every product.

Departures from the program, each deliberate:

* each Gauss-Newton step is solved exactly, by dense normal equations
  (``torch.linalg.solve``), where the program runs 30 conjugate-gradient
  steps;
* the coarse-to-fine change of coordinates is the exact one of the 2 x 2
  mean pyramid, x_fine = 2 x_coarse + 1/2, where the program conjugates by
  diag(1/2, 1/2, 1) and so ignores the half pixel;
* the Huber weights enter the normal equations once (iteratively reweighted
  least squares on the Huber cost) and a step is accepted where it lowers
  the Huber cost;
* every ESM runs its whole iteration cap: a converged model's further steps
  are below rounding, where the program freezes it;
* pose recovery, as ``ref_vo``'s, votes with the valid matches alone.
"""

from __future__ import annotations

import torch
from torch import Tensor

from benchmark.core import ref_fit, ref_vo

#: A closure with fewer inliers is a misfit: its edge gets weight 0.
CLOSURE_MIN_INLIERS = 12
#: The guard's tolerance on the median transfer error of the inliers.
GUARD_TOL = 1.1
#: Huber scale of the photometric residual, in intensity units.
HUBER = 0.1


def _exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _wide(fn, *xs: Tensor) -> Tensor:
    """``fn`` of ``xs`` in the solve dtype, rounded back to theirs."""
    dt = xs[0].dtype
    wide = ref_fit._wide(dt)
    return fn(*(x.to(wide) for x in xs)).to(dt)


def _inv(m: Tensor) -> Tensor:
    return _wide(lambda a: torch.linalg.inv_ex(a).inverse, m)


def closure_pairs(num_frames: int, strides) -> list:
    """The loop-closure candidates (i, i+k) of each stride, stride by
    stride."""
    return [(i, i + k) for k in strides for i in range(num_frames - k)]


# --- SE(3) ------------------------------------------------------------------

def _hat(w: Tensor) -> Tensor:
    x, y, z = w.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _angle_terms(w: Tensor):
    """(theta^2, small, theta) of rotation vectors, theta evaluated at 1
    where it is small so that every branch stays finite under
    differentiation."""
    th2 = (w * w).sum(-1)
    small = th2 < 1e-8
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    return th2, small, th


def se3_exp(xi: Tensor) -> Tensor:
    """Twists (..., 6) = [v, w] -> rigid transforms (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    th2, small, th = _angle_terms(w)
    a = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / th ** 2)
    c = torch.where(small, 1 / 6 - th2 / 120, (th - torch.sin(th)) / th ** 3)
    k = _hat(w)
    kk = k @ k
    eye = _eye(3, xi)
    r = eye + a[..., None, None] * k + b[..., None, None] * kk
    jl = eye + b[..., None, None] * k + c[..., None, None] * kk
    t = (jl @ v[..., None])[..., 0]
    return _se3(r, t)


def _se3(r: Tensor, t: Tensor) -> Tensor:
    top = torch.cat([r, t[..., None]], -1)
    bottom = _eye(4, r)[3:].expand(*r.shape[:-2], 1, 4)
    return torch.cat([top, bottom], -2)


def se3_log(g: Tensor) -> Tensor:
    """Rigid transforms (..., 4, 4), rotations below pi -> twists [v, w]."""
    r, t = g[..., :3, :3], g[..., :3, 3]
    skew = torch.stack([r[..., 2, 1] - r[..., 1, 2],
                        r[..., 0, 2] - r[..., 2, 0],
                        r[..., 1, 0] - r[..., 0, 1]], -1)  # 2 sin(th) axis
    cos = (r.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2
    s2 = (skew * skew).sum(-1) / 4  # sin^2
    small = s2 < 1e-12
    sin = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    th = torch.atan2(sin, cos)
    fac = torch.where(small, 0.5 + s2 / 12, th / (2 * sin))
    w = fac[..., None] * skew
    th2, small_w, th_w = _angle_terms(w)
    coef = torch.where(small_w, 1 / 12 + th2 / 720,
                       1 / th_w ** 2 - (1 + torch.cos(th_w))
                       / (2 * th_w * torch.sin(th_w)))
    k = _hat(w)
    jli = _eye(3, g) - 0.5 * k + coef[..., None, None] * (k @ k)
    return torch.cat([(jli @ t[..., None])[..., 0], w], -1)


def rot_gap_deg(a: Tensor, b: Tensor) -> Tensor:
    """The angle of a_R^T b_R, in degrees, from the rotation's skew part
    and its trace together (atan2): exact to rounding at small angles, where
    the arccos of the trace alone reads a float32 rotation's departure from
    orthonormality (~1e-7) as an angle of ~0.03 deg."""
    r = a[..., :3, :3].transpose(-1, -2) @ b[..., :3, :3]
    skew = torch.stack([r[..., 2, 1] - r[..., 1, 2],
                        r[..., 0, 2] - r[..., 2, 0],
                        r[..., 1, 0] - r[..., 0, 1]], -1)
    cos = r.diagonal(dim1=-2, dim2=-1).sum(-1) - 1
    return torch.rad2deg(torch.atan2(torch.linalg.norm(skew, dim=-1), cos))


def chain(rel: Tensor) -> Tensor:
    """Relative poses (T-1, 4, 4), X_{i+1} = rel_i X_i -> the chain of
    cam -> world poses (T, 4, 4), the first the identity."""
    poses = [_eye(4, rel)]
    for g in inv_se3(rel):
        poses.append(poses[-1] @ g)
    return torch.stack(poses)


def inv_se3(g: Tensor) -> Tensor:
    rt = g[..., :3, :3].transpose(-1, -2)
    return _se3(rt, -(rt @ g[..., :3, 3:])[..., 0])


def posegraph(poses: Tensor, edges: list, meas: Tensor, weights: Tensor,
              iters: int = 5, damping: float = 1e-6) -> Tensor:
    """Gauss-Newton on the pose graph, each step solved exactly.

    poses (K, 4, 4) cam -> world; edges [(i, j), ...]; meas (E, 4, 4) the
    measured T_i^-1 T_j; weights (E,).  The first pose is held by a
    residual 1e3 dx_0.
    """
    _exact()
    k = poses.shape[0]
    i = torch.tensor([e[0] for e in edges], device=poses.device)
    j = torch.tensor([e[1] for e in edges], device=poses.device)
    z_inv = inv_se3(meas)
    sw = torch.sqrt(weights.clamp(min=0))[:, None]

    for _ in range(iters):
        def residual(dx, poses=poses):
            p = poses @ se3_exp(dx)
            err = z_inv @ inv_se3(p[i]) @ p[j]
            return torch.cat([(se3_log(err) * sw).reshape(-1), 1e3 * dx[0]])

        zero = torch.zeros((k, 6), dtype=poses.dtype, device=poses.device)
        r0 = residual(zero)
        jac = torch.func.jacfwd(residual)(zero).reshape(r0.shape[0], 6 * k)
        a = jac.T @ jac + damping * _eye(6 * k, jac)
        dx = ref_fit._solve(a, -(jac.T @ r0)).reshape(k, 6)
        if not bool(torch.isfinite(dx).all()):
            break
        poses = poses @ se3_exp(dx)
    return poses


# --- ESM on SL(3) -----------------------------------------------------------

def _sl3_generators(like: Tensor) -> Tensor:
    """The 8 generators of Benhimane and Malis: translations, rotation and
    scale in the image plane's affine part, the two stretches, and the two
    projective terms (traceless)."""
    e = _eye(9, like).reshape(9, 3, 3)  # e[3 r + c] = E_rc
    return torch.stack([e[2], e[5], e[1], e[3], e[0] - e[4], e[8] - e[4],
                        e[6], e[7]])


def _grad(img: Tensor):
    """Central differences, the border pixel repeated."""
    px = torch.cat([img[:, :1], img, img[:, -1:]], 1)
    py = torch.cat([img[:1], img, img[-1:]], 0)
    return 0.5 * (px[:, 2:] - px[:, :-2]), 0.5 * (py[2:] - py[:-2])


def _down2(img: Tensor) -> Tensor:
    h, w = img.shape[-2] // 2 * 2, img.shape[-1] // 2 * 2
    return img[:h, :w].reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))


def _sample(img: Tensor, u: Tensor, v: Tensor) -> Tensor:
    """Bilinear samples of (H, W) at (u, v), clamped to the image.  The
    four neighbours' indices are clamped as integers, so that no rounding
    of a coordinate (bfloat16 spaces them 4 px apart at 640) reads past the
    image; a NaN location (a model that is not finite) reads pixel 0, and
    is no valid pixel."""
    h, w = img.shape
    x = torch.nan_to_num(u, nan=0.0).clamp(0, w - 1)
    y = torch.nan_to_num(v, nan=0.0).clamp(0, h - 1)
    x0 = torch.floor(x).long().clamp(0, w - 2)
    y0 = torch.floor(y).long().clamp(0, h - 2)
    fx, fy = x - x0.to(x.dtype), y - y0.to(y.dtype)
    flat = img.reshape(-1)

    def at(dy, dx):
        return flat[(y0 + dy) * w + x0 + dx]

    return (at(0, 0) * (1 - fx) * (1 - fy) + at(0, 1) * fx * (1 - fy)
            + at(1, 0) * (1 - fx) * fy + at(1, 1) * fx * fy)


class _Warp:
    """One ESM problem: template ``tpl`` whose pixel p sits at origin + p,
    aligned to ``img``."""

    def __init__(self, tpl: Tensor, origin: int, img: Tensor):
        th, tw = tpl.shape
        ys = torch.arange(th, dtype=tpl.dtype, device=tpl.device) + origin
        xs = torch.arange(tw, dtype=tpl.dtype, device=tpl.device) + origin
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        self.x = torch.stack([gx.reshape(-1), gy.reshape(-1),
                              torch.ones_like(gx.reshape(-1))], -1)
        self.t = tpl.reshape(-1)
        tgx, tgy = _grad(tpl)
        self.tg = torch.stack([tgx.reshape(-1), tgy.reshape(-1)], -1)
        self.img = img
        self.igx, self.igy = _grad(img)
        self.h_max, self.w_max = img.shape[0] - 2.0, img.shape[1] - 2.0

    def project(self, h: Tensor):
        y = self.x @ h.T
        z = y[:, 2]
        u, v = y[:, 0] / z, y[:, 1] / z
        valid = ((u >= 1) & (u <= self.w_max) & (v >= 1) & (v <= self.h_max)
                 & (z > 1e-6))
        return u, v, z, valid

    def residual(self, u, v, valid):
        """The photometric residual I(w(x)) - (a T(x) + b) with the gain
        a and bias b of least squares over the valid pixels (a in
        [0.25, 4]), zero off them; and a."""
        iw = _sample(self.img, u, v)
        m = valid.to(iw.dtype)
        n = m.sum().clamp(min=1)
        mt, mi = (m * self.t).sum() / n, (m * iw).sum() / n
        var = (m * (self.t - mt) ** 2).sum().clamp(min=1e-8)
        a = ((m * (self.t - mt) * (iw - mi)).sum() / var).clamp(0.25, 4.0)
        return (iw - a * self.t - (mi - a * mt)) * m, a

    def cost(self, h: Tensor) -> Tensor:
        """The Huber cost of the residual at ``h``."""
        u, v, _, valid = self.project(h)
        r = self.residual(u, v, valid)[0].abs()
        return torch.where(r <= HUBER, 0.5 * r * r,
                           HUBER * r - 0.5 * HUBER * HUBER).sum()


def esm(tpl: Tensor, origin: int, img: Tensor, h: Tensor, iters: int,
        damping: float = 1e-4) -> Tensor:
    """ESM of ``tpl`` (pixel p at origin + p) against ``img`` from ``h``:
    ``iters`` Levenberg-Marquardt steps H <- H exp(sum_k d_k G_k)."""
    prob = _Warp(tpl, origin, img)
    gens = _sl3_generators(h)
    lam = damping
    cost = prob.cost(h)
    for _ in range(iters):
        u, v, z, valid = prob.project(h)
        r, a = prob.residual(u, v, valid)
        wg = torch.stack([_sample(prob.igx, u, v), _sample(prob.igy, u, v)],
                         -1)
        g = 0.5 * (a * prob.tg + wg)  # the ESM gradient
        hgx = torch.einsum("kij,nj->nki", h @ gens, prob.x)  # (N, 8, 3)
        du = (hgx[..., 0] - u[:, None] * hgx[..., 2]) / z[:, None]
        dv = (hgx[..., 1] - v[:, None] * hgx[..., 2]) / z[:, None]
        jac = g[:, :1] * du + g[:, 1:] * dv
        w = valid.to(r.dtype) * torch.clamp(
            HUBER / r.abs().clamp(min=1e-12), max=1.0)
        normal = (jac * w[:, None]).T @ jac
        rhs = -(jac * (w * r)[:, None]).sum(0)
        d = ref_fit._solve(normal + lam * torch.diag(torch.diag(normal)), rhs)
        h_new = h @ _wide(torch.linalg.matrix_exp,
                          (d[:, None, None] * gens).sum(0))
        cost_new = prob.cost(h_new)
        if bool(torch.isfinite(cost_new)) and bool(cost_new < cost):
            h, cost, lam = h_new, cost_new, max(lam * 0.3, 1e-6)
        else:
            lam *= 8.0
    return h


def _sqrtm(m: Tensor, steps: int = 8) -> Tensor:
    """The principal square root by the Denman-Beavers iteration."""
    y, z = m, _eye(3, m)
    for _ in range(steps):
        y, z = 0.5 * (y + _inv(z)), 0.5 * (z + _inv(y))
    return y


def _finite(h: Tensor) -> bool:
    return bool(torch.isfinite(h).all())


def _normalized(h: Tensor) -> Tensor:
    return h / h[2, 2]


def esm_symmetric(img1: Tensor, img2: Tensor, h0: Tensor, iters: int,
                  fine_iters: int = 2, border: int = 16) -> Tensor:
    """The symmetric two-level polish of ``h0`` (img1 -> img2 pixels)."""
    _exact()

    def once(a, b, h, bdr, its):
        tpl_a = a[bdr:a.shape[0] - bdr, bdr:a.shape[1] - bdr]
        tpl_b = b[bdr:b.shape[0] - bdr, bdr:b.shape[1] - bdr]
        h_f = esm(tpl_a, bdr, b, h, its)
        h_b = esm(tpl_b, bdr, a, _normalized(_inv(h)), its)
        hf, hb = _normalized(h_f), _normalized(_inv(h_b))
        h_sym = hf @ _wide(_sqrtm, _normalized(_inv(hf) @ hb))
        if _finite(h_sym):
            return h_sym
        return h_f if _finite(h_f) else h

    up = torch.zeros((3, 3), dtype=h0.dtype, device=h0.device)
    up[0, 0], up[1, 1], up[0, 2], up[1, 2], up[2, 2] = 2.0, 2.0, 0.5, 0.5, 1.0
    h_half = once(_down2(img1), _down2(img2), _normalized(_inv(up) @ h0 @ up),
                  max(border // 2, 4), iters)
    h_up = up @ h_half @ _inv(up)
    h = _normalized(h_up) if _finite(h_up) else h0
    return _normalized(once(img1, img2, h, border, fine_iters))


def _median(x: Tensor) -> Tensor:
    wide = x if x.dtype in (torch.float32, torch.float64) else x.float()
    return torch.quantile(wide, 0.5) if wide.numel() else wide.new_tensor(
        torch.nan)


def guard(h_base: Tensor, h_esm: Tensor, p1: Tensor, p2: Tensor,
          inliers: Tensor) -> bool:
    """Keep the polished model: finite, and the median symmetric transfer
    error of the inliers no more than ``GUARD_TOL`` times the fit's."""
    if not _finite(h_esm):
        return False
    med_b = _median(ref_fit.sym_r2(h_base, p1, p2)[inliers])
    med_e = _median(ref_fit.sym_r2(h_esm, p1, p2)[inliers])
    return bool(med_e <= GUARD_TOL * med_b)


# --- the whole call ---------------------------------------------------------

def slam(frames: Tensor, k_mat: Tensor, config: dict, hypotheses: int,
         generator: torch.Generator, dtype=torch.float64):
    """The reference of one ``planar_slam`` call: (poses (T, 4, 4) relaxed
    cam -> world, rel (T-1, 4, 4), num_inliers (T-1,), closure_inliers
    (E,), closure_rel (E, 4, 4)), on the host; ``config`` as the
    configuration's file gives it."""
    _exact()
    f = frames.to(dtype)
    kk = k_mat.to(dtype)
    t = f.shape[0]
    thr = float(config["threshold_px"])
    esm_iters = int(config["esm_iters"])
    pairs = ([(i, i + 1) for i in range(t - 1)]
             + closure_pairs(t, config["strides"]))
    i1 = torch.tensor([p[0] for p in pairs], device=f.device)
    i2 = torch.tensor([p[1] for p in pairs], device=f.device)
    xy, valid, scale = ref_vo.corners_pyramid(f, int(config["num_corners"]),
                                              int(config["num_octaves"]))
    desc = ref_vo.describe(f, xy, scale)
    idx2, ok = ref_vo.match(desc[i1], desc[i2], valid[i1], valid[i2])
    p1s = xy[i1]
    p2s = torch.gather(xy[i2], -2, idx2[..., None].expand(*idx2.shape, 2))
    prior = _eye(3, kk)[2]

    fits = []
    for e, (a, b) in enumerate(pairs):
        p1, p2, m = p1s[e], p2s[e], ok[e]
        h, inl = ref_fit.fit(p1, p2, thr, hypotheses, generator, dtype,
                             valid=m)
        if esm_iters:
            h_esm = esm_symmetric(f[a], f[b], h, esm_iters)
            if guard(h, h_esm, p1, p2, inl):
                h = h_esm
        n = int(((ref_fit.sym_r2(h, p1, p2) < thr * thr) & m).sum())
        r, t_over_d, nrm = ref_vo.pose(h, kk, p1, p2, m, prior)
        fits.append((r, t_over_d, nrm, n))

    depth = torch.full((), float(config["plane_depth"]), dtype=dtype,
                       device=f.device)
    depths, rel = [], []
    for r, t_over_d, nrm, _ in fits[:t - 1]:
        depths.append(depth)
        tr = t_over_d * depth
        depth = depth + (r @ nrm) @ tr
        rel.append(_se3(r, tr))
    rel = torch.stack(rel)
    rel_c = torch.stack([rel[0]] + [
        _se3(r, t_over_d * depths[a]) for (a, _), (r, t_over_d, _, _)
        in zip(pairs[t - 1:], fits[t - 1:])])[1:]

    ninl = torch.tensor([fit[3] for fit in fits])
    poses = relax(rel, ninl[:t - 1], rel_c, ninl[t - 1:], pairs[t - 1:])
    return (poses.double().cpu(), rel.double().cpu(), ninl[:t - 1],
            ninl[t - 1:], rel_c.double().cpu())


def relax(rel: Tensor, ninl: Tensor, rel_c: Tensor, ninl_c: Tensor,
          closures: list) -> Tensor:
    """The relaxed poses of a chain and its closures: Gauss-Newton from the
    chain of ``rel`` over the odometry edges (i, i+1), measured by
    ``rel`` and weighted by ``ninl``, and the closure edges ``closures``,
    measured by ``rel_c`` (metric cam_i -> cam_j) and weighted by
    ``ninl_c``, 0 below ``CLOSURE_MIN_INLIERS``; in ``rel``'s dtype."""
    t = rel.shape[0] + 1
    pairs = [(i, i + 1) for i in range(t - 1)] + list(closures)
    w_c = torch.where(ninl_c >= CLOSURE_MIN_INLIERS, ninl_c,
                      torch.zeros_like(ninl_c))
    weights = torch.cat([ninl, w_c]).to(device=rel.device, dtype=rel.dtype)
    meas = inv_se3(torch.cat([rel, rel_c.to(rel)]))
    return posegraph(chain(rel), pairs, meas, weights)
