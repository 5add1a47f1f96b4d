"""Direct (dense) homography tracking on SL(3): ESM.

Port of ``sks_tpu/slam/tracking.py``: align the raw pixels of a template to
an image by minimizing the photometric error over the 8-parameter SL(3)
homography group, Efficient Second-order Minimization (ESM, Benhimane &
Malis, IROS 2004), by damped Gauss-Newton with a closed-form gain/bias and
Huber weights.  ``esm_polish_pair_symmetric`` is the dense polish the VO
pipeline applies to every pair's RANSAC model (``slam/odometry.py``).

Every function takes a **leading batch axis**: templates (..., th, tw),
images (..., H, W) and homographies (..., 3, 3) broadcast over their leading
dims, and one pass of the iteration loop steps every element; unbatched
inputs work as in the JAX package.  The JAX package runs the loop as a
``lax.while_loop`` that stops when the element has converged, and under
``jax.vmap`` a finished element's carry is frozen by a select while the
others step on.  Here the loop runs the static cap and a per-element
``done`` mask freezes ``h``, the damping and the residual, which gives each
element the JAX result with no host read inside the loop.

Sampling is by bilinear gathers only (``sampler='gather'``; 'auto' resolves
to it).  The JAX package's one-hot matmul samplers ('matmul',
'matmul_bf16') exist for the TPU, where gathers serialize, and raise here.

Math (forward compositional, ESM gradient):
  warp  w(x; H) = pi(H x),   update  H <- H . exp(sum_k d_k G_k)
with G_k the sl(3) generators (:func:`sks_tpu_torch.geom.lie.sl3_basis`).
At d = 0 the Jacobian column k at template pixel p is

  J_k(p) = g(p)^T . dpi(y_p) . (H G_k x_p),      y_p = H x_p,

where dpi is the 2x3 projection differential and g(p) the ESM gradient: the
mean of the template gradient and the warped-image gradient.
"""

from __future__ import annotations

import torch
from torch import Tensor

from sks_tpu_torch.features.descriptors import bilinear_sample
from sks_tpu_torch.geom.homography import symmetric_transfer_error
from sks_tpu_torch.geom.lie import (
    expm3,
    logm3_near_identity,
    mm_small,
    sl3_basis,
    sl3_exp,
)
from sks_tpu_torch.ops.linalg import mm_highest
from sks_tpu_torch.robust.ransac import _all_finite, _scalar

__all__ = ["esm_track", "esm_track_pyramid", "esm_polish_pair",
           "esm_polish_pair_symmetric", "esm_guard"]


def _check_sampler(sampler: str) -> None:
    if sampler in ("matmul", "matmul_bf16"):
        raise ValueError(
            f"sampler={sampler!r} (the one-hot matmul sampler of the TPU) is "
            "not part of the port; use 'gather' or 'auto'")
    if sampler not in ("gather", "auto"):
        raise ValueError(f"unknown sampler {sampler!r}")


def _diag3(s: float, like: Tensor) -> Tensor:
    """diag(s, s, 1), made on the device."""
    scale = torch.cat([torch.full((2,), s, dtype=like.dtype,
                                  device=like.device),
                       torch.ones((1,), dtype=like.dtype, device=like.device)])
    return torch.eye(3, dtype=like.dtype, device=like.device) * scale


def _inv(h: Tensor) -> Tensor:
    """Batched 3x3 inverse that returns inf/NaN on a singular matrix, as
    ``jnp.linalg.inv`` does, instead of raising (and reading the card)."""
    return torch.linalg.inv_ex(h, check_errors=False).inverse


def _grad(img: Tensor) -> tuple:
    """Edge-clamped central-difference gradients (..., H, W) -> (gx, gy).

    Edge padding (not wrap): a rolled difference would mix opposite borders
    into the boundary pixels' gradients.
    """
    px = torch.cat([img[..., :1], img, img[..., -1:]], dim=-1)
    py = torch.cat([img[..., :1, :], img, img[..., -1:, :]], dim=-2)
    gx = 0.5 * (px[..., 2:] - px[..., :-2])
    gy = 0.5 * (py[..., 2:, :] - py[..., :-2, :])
    return gx, gy


def _down2(img: Tensor) -> Tensor:
    """2x2 mean downsample (even-cropped) of (..., H, W)."""
    h2, w2 = (img.shape[-2] // 2) * 2, (img.shape[-1] // 2) * 2
    x = img[..., :h2, :w2]
    return 0.25 * (x[..., 0::2, 0::2] + x[..., 1::2, 0::2]
                   + x[..., 0::2, 1::2] + x[..., 1::2, 1::2])


def esm_track(
    template: Tensor,
    image: Tensor,
    h0: Tensor,
    origin: Tensor | tuple | None = None,
    iters: int = 20,
    damping: float = 1e-4,
    photometric: bool = True,
    huber: float = 0.1,
    dof: int = 8,
    sampler: str = "auto",
    stride: int = 1,
) -> tuple:
    """Align ``image`` to ``template`` by ESM over SL(3).

    Args:
      template: (..., th, tw) grayscale template (the reference appearance).
      image: (..., H, W) current frame(s).
      h0: (..., 3, 3) initial homography mapping template pixel coords ->
        image pixel coords.
      origin: (..., 2) template's top-left in its own coordinate frame
        (default (0, 0)): template pixel p has homogeneous coords
        (origin + p, 1).  A tensor, or a pair of numbers.
      iters: damped Gauss-Newton iteration cap.  An element stops stepping
        once it has converged (a sub-1e-5 accepted step and a flat cost) or
        its damping has blown up; its result is then frozen while the others
        of the batch step on.
      damping: initial Levenberg diagonal damping added to J^T J.
      photometric: solve a closed-form gain/bias (I_w ~ a T + b) each
        iteration.
      huber: Huber scale in intensity units.
      dof: leading sl(3) generators to optimize (2 translation, 4
        similarity, 6 affine, 8 full homography).
      sampler: 'gather' or 'auto' (both gather; the TPU's 'matmul' and
        'matmul_bf16' raise).
      stride: template-pixel subsampling step (the image is sampled at full
        resolution; only the set of voting template pixels thins).

    Returns:
      (h (..., 3, 3), rms (...)): ``h`` maps template coords -> image
      coords; ``rms`` is the photometric RMS residual (gain/bias-compensated)
      over valid (in-bounds) pixels, inf if no iteration ran.  The leading
      dims are those of the inputs, broadcast.
    """
    _check_sampler(sampler)
    dt, dev = template.dtype, template.device
    image = image.to(dt)
    h0 = torch.as_tensor(h0, dtype=dt, device=dev)
    if origin is None:
        origin = torch.zeros((2,), dtype=dt, device=dev)
    elif not isinstance(origin, Tensor):
        origin = torch.stack([_scalar(float(o), template) for o in origin])
    origin = origin.to(dt)
    th, tw = template.shape[-2:]
    ih, iw_ = image.shape[-2:]
    batch = torch.broadcast_shapes(template.shape[:-2], image.shape[:-2],
                                   h0.shape[:-2], origin.shape[:-1])
    tpl = template.expand(*batch, th, tw).reshape(-1, th, tw)
    img = image.expand(*batch, ih, iw_).reshape(-1, ih, iw_)
    h = h0.expand(*batch, 3, 3).reshape(-1, 3, 3)
    org = origin.expand(*batch, 2).reshape(-1, 2)
    h, rms = _esm_loop(tpl, img, h, org, iters, damping, photometric, huber,
                       dof, stride)
    return h.reshape(*batch, 3, 3), rms.reshape(batch)


def _esm_loop(tpl, img, h, org, iters, damping, photometric, huber, dof,
              stride):
    """:func:`esm_track` on a flat batch: tpl (B, th, tw), img (B, H, W),
    h (B, 3, 3), org (B, 2)."""
    dt, dev = tpl.dtype, tpl.device
    th, tw = tpl.shape[-2:]
    ys = torch.arange(0, th, stride, dtype=dt, device=dev)
    xs = torch.arange(0, tw, stride, dtype=dt, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    gx = gx.reshape(1, -1) + org[:, 0:1]
    gy = gy.reshape(1, -1) + org[:, 1:2]
    # (B, N, 3) homogeneous template coords (every stride-th pixel).
    xh = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    t_flat = tpl[:, ::stride, ::stride].reshape(tpl.shape[0], -1)
    tgx, tgy = _grad(tpl)  # full-res gradients, sampled at the grid
    tg = torch.stack([tgx[:, ::stride, ::stride].reshape(t_flat.shape),
                      tgy[:, ::stride, ::stride].reshape(t_flat.shape)],
                     dim=-1)  # (B, N, 2)
    gens = sl3_basis(dt, dev)[:dof]  # (dof, 3, 3)
    h0f, w0f = img.shape[-2] - 1.0, img.shape[-1] - 1.0
    igx, igy = _grad(img)
    # The image and its two gradients, sampled with one set of weights.
    img3 = torch.stack([img, igx, igy], dim=1)  # (B, 3, H, W)
    hub = _scalar(huber, tpl)
    pad = torch.zeros((h.shape[0], 8 - dof), dtype=dt, device=dev)
    eye = torch.eye(dof, dtype=dt, device=dev)

    def in_bounds(u, v, z):
        return ((u >= 1.0) & (u <= w0f - 1.0)
                & (v >= 1.0) & (v <= h0f - 1.0)
                & (z > 1e-6)).to(dt)

    def gain_bias(iw, valid):
        """Closed-form a, b (B, 1) minimizing sum valid (a T + b - I_w)^2."""
        if not photometric:
            ones = torch.ones((iw.shape[0], 1), dtype=dt, device=dev)
            return ones, torch.zeros_like(ones)
        n = torch.clamp(torch.sum(valid, dim=-1, keepdim=True), min=1.0)
        st = torch.sum(valid * t_flat, dim=-1, keepdim=True)
        si = torch.sum(valid * iw, dim=-1, keepdim=True)
        stt = torch.sum(valid * t_flat * t_flat, dim=-1, keepdim=True)
        sti = torch.sum(valid * t_flat * iw, dim=-1, keepdim=True)
        var = torch.clamp(stt - st * st / n, min=1e-8)
        a = (sti - st * si / n) / var
        a = torch.clamp(a, 0.25, 4.0)
        b = (si - a * st) / n
        return a, b

    def residual(iw, valid):
        a, b = gain_bias(iw, valid)
        r = (iw - (a * t_flat + b)) * valid
        # Huber IRLS weights: large residuals (occlusion, off-plane) fade.
        w = torch.clamp(hub / torch.clamp(torch.abs(r), min=1e-12), max=1.0)
        return a, r, w

    def cost_of(hm):
        # The iteration's validity rule (z > 1e-6 included), so that
        # accept/reject compares costs over the same pixel set.
        y = mm_highest(xh, hm.transpose(-1, -2))
        zr = y[..., 2]
        uv = y[..., :2] / torch.clamp(zr, min=1e-6)[..., None]
        valid = in_bounds(uv[..., 0], uv[..., 1], zr)
        iw = bilinear_sample(img, uv)
        _, r, w = residual(iw, valid)
        return torch.sum(w * r * r, dim=-1)

    lam = torch.full((h.shape[0],), damping, dtype=dt, device=dev)
    rms = torch.full((h.shape[0],), torch.inf, dtype=dt, device=dev)
    done = torch.zeros((h.shape[0],), dtype=torch.bool, device=dev)
    for _ in range(iters):
        y = mm_highest(xh, h.transpose(-1, -2))  # (B, N, 3)
        z = y[..., 2]
        iz = 1.0 / torch.clamp(z, min=1e-6)
        u = y[..., 0] * iz
        v = y[..., 1] * iz
        valid = in_bounds(u, v, z)
        uv = torch.stack([u, v], dim=-1)
        iw, gxw, gyw = bilinear_sample(
            img3, uv[:, None].expand(-1, 3, -1, -1)).unbind(1)
        a, r, w = residual(iw, valid)
        # ESM gradient: mean of (gain-scaled) template and warped gradients.
        wg = torch.stack([gxw, gyw], dim=-1)
        g = 0.5 * (a[..., None] * tg + wg) * (valid * w)[..., None]
        # dpi(y) rows: [1/z, 0, -u/z], [0, 1/z, -v/z];
        # J_k = g . dpi(y) . (H G_k x), with M_k = H G_k.
        m = mm_highest(h[:, None], gens)  # (B, dof, 3, 3)
        hgx = torch.einsum("bkil,bnl->bnki", m, xh)  # (B, N, dof, 3)
        du = (hgx[..., 0] - u[..., None] * hgx[..., 2]) * iz[..., None]
        dv = (hgx[..., 1] - v[..., None] * hgx[..., 2]) * iz[..., None]
        jac = g[..., 0:1] * du + g[..., 1:2] * dv  # (B, N, dof)
        jt = jac.transpose(-1, -2)
        a_mat = mm_highest(jt, jac)
        a_mat = (a_mat + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(a_mat, dim1=-2, dim2=-1)) + 1e-10 * eye)
        rhs = -mm_highest(jt, (w * r)[..., None])[..., 0]
        # A singular system gives inf/NaN, as jnp.linalg.solve does; the
        # finiteness test below rejects the step.
        d = torch.linalg.solve_ex(a_mat, rhs, check_errors=False).result
        h_new = mm_highest(h, sl3_exp(torch.cat([d, pad], dim=-1)))
        # Accept only improving, finite steps (branch-free).
        c_old = torch.sum(w * r * r, dim=-1)
        c_new = cost_of(h_new)
        ok = torch.isfinite(c_new) & (c_new < c_old) & _all_finite(h_new)
        # Adaptive LM damping: shrink on accept, grow on reject.
        lam_new = torch.where(ok, torch.clamp(lam * 0.3, min=1e-6), lam * 8.0)
        nval = torch.clamp(torch.sum(valid, dim=-1), min=1.0)
        rms_new = torch.sqrt(torch.where(ok, c_new, c_old) / nval)
        # Converged: an accepted step below 1e-5 in both parameters and
        # cost, or damping grown past any useful step.
        small = (torch.amax(torch.abs(d), dim=-1) < 1e-5) & (
            c_old - c_new < 1e-5 * (c_old + 1e-30))
        done_new = (ok & small) | (lam_new > 1e6)
        # An element already done keeps its carry (the JAX while_loop's
        # frozen carry under vmap).
        step = ~done
        h = torch.where((step & ok)[:, None, None], h_new, h)
        lam = torch.where(step, lam_new, lam)
        rms = torch.where(step, rms_new, rms)
        done = done | done_new
    return h, rms


def esm_polish_pair(
    img1: Tensor,
    img2: Tensor,
    h0: Tensor,
    crop: tuple | None = None,
    iters: int = 10,
    dof: int = 8,
    sampler: str = "auto",
    stride: int = 1,
) -> tuple:
    """Dense ESM refinement of a pair homography.

    A feature-RANSAC model ``h0`` (``img1`` pixel coords -> ``img2`` pixel
    coords) is polished by photometric alignment of a central crop of
    ``img1`` against ``img2``: every pixel of the crop votes.  The start is
    already within ~1 px, so one level suffices.

    Args:
      img1, img2: (..., H, W) grayscale frames.
      h0: (..., 3, 3) initial homography img1 -> img2.
      crop: (ch, cw) template size (default: the central half-frame).
      iters/dof/sampler/stride: forwarded to :func:`esm_track`.

    Returns:
      (h (..., 3, 3) refined, rms photometric residual (...)).
    """
    h_img, w_img = img1.shape[-2:]
    if crop is None:
        crop = (h_img // 2, w_img // 2)
    ch, cw = crop
    cy, cx = (h_img - ch) // 2, (w_img - cw) // 2
    tpl = img1[..., cy:cy + ch, cx:cx + cw]
    return esm_track(tpl, img2, h0, origin=(cx, cy), iters=iters, dof=dof,
                     sampler=sampler, stride=stride)


def esm_polish_pair_symmetric(
    img1: Tensor,
    img2: Tensor,
    h0: Tensor,
    border: int = 16,
    iters: int = 8,
    dof: int = 8,
    sampler: str = "auto",
    stride: int = 1,
    levels: int = 2,
    fine_iters: int = 2,
) -> tuple:
    """Bias-cancelling dense polish: forward AND backward ESM, geodesic mean.

    Polishes img1 -> img2 and img2 -> img1 (from the inverse start) over the
    ``border``-inset full frame; to first order a blur bias shifts the two
    optima in opposite directions, so the SL(3) geodesic mean
    ``H_f . exp(0.5 log(H_f^-1 H_b^-1))`` cancels it.  The two directions of
    all P pairs run as one batch of 2P in one pass of the loop.

    Args:
      img1, img2: (..., H, W) grayscale frames.
      h0: (..., 3, 3) initial homography img1 -> img2 (the RANSAC model).
      border: inset of the full-frame template.
      levels: 2 (default): the symmetric polish at 1/2 resolution first
        (2x2-mean low-pass), then ``fine_iters`` full-resolution iterations
        from the upscaled model; 1: all ``iters`` at full resolution.  The
        model moves between levels by the similarity S = diag(1/2, 1/2, 1):
        H_half = S H S^-1, which ignores the quarter-pixel shift of the
        2x2-mean pixel centres, as the JAX package does.
      fine_iters: full-resolution iteration cap when ``levels >= 2``.
      iters/dof/sampler/stride: forwarded to :func:`esm_track` (``iters``
        is a cap).

    Returns:
      (h (..., 3, 3) refined img1->img2, mean fwd/bwd rms residual (...)).
    """
    _check_sampler(sampler)
    batch = torch.broadcast_shapes(img1.shape[:-2], img2.shape[:-2],
                                   h0.shape[:-2])
    shape = img1.shape[-2:]
    i1 = img1.expand(*batch, *shape).reshape(-1, *shape)
    i2 = img2.to(img1.dtype).expand(*batch, *shape).reshape(-1, *shape)
    h_cur = torch.as_tensor(h0, dtype=img1.dtype, device=img1.device)
    h_cur = h_cur.expand(*batch, 3, 3).reshape(-1, 3, 3)
    p = h_cur.shape[0]

    def sym_once(a, b, h_init, bdr, its):
        h_img, w_img = a.shape[-2:]
        crop = (h_img - 2 * bdr, w_img - 2 * bdr)
        h0i = _inv(h_init)
        h0i = h0i / h0i[..., 2:3, 2:3]
        # Forward and backward as one batch of 2P.
        h_fb, rms_fb = esm_polish_pair(
            torch.cat([a, b]), torch.cat([b, a]), torch.cat([h_init, h0i]),
            crop=crop, iters=its, dof=dof, sampler=sampler, stride=stride)
        h_f, h_b = h_fb[:p], h_fb[p:]
        hbi = _inv(h_b)
        hfn = h_f / h_f[..., 2:3, 2:3]
        hbn = hbi / hbi[..., 2:3, 2:3]
        # Both normalized models estimate a -> b; their deviation from
        # agreement is the (mostly antisymmetric) bias + noise.
        d = mm_small(_inv(hfn), hbn)
        d = d / d[..., 2:3, 2:3]
        h_sym = mm_small(hfn, expm3(0.5 * logm3_near_identity(d)))
        keep_f = _all_finite(h_f)[:, None, None]
        h_out = torch.where(_all_finite(h_sym)[:, None, None], h_sym,
                            torch.where(keep_f, h_f, h_init))
        return h_out, 0.5 * (rms_fb[:p] + rms_fb[p:])

    if levels >= 2:
        i1c, i2c = _down2(i1), _down2(i2)
        s_dn, s_up = _diag3(0.5, h_cur), _diag3(2.0, h_cur)
        h_half = mm_small(s_dn, mm_small(h_cur, s_up))
        h_half, _ = sym_once(i1c, i2c, h_half / h_half[..., 2:3, 2:3],
                             max(border // 2, 4), iters)
        h_up = mm_small(s_up, mm_small(h_half, s_dn))
        h_cur = torch.where(_all_finite(h_up)[:, None, None],
                            h_up / h_up[..., 2:3, 2:3], h_cur)
        fine = fine_iters
    else:
        fine = iters
    h, rms = sym_once(i1, i2, h_cur, border, fine)
    return h.reshape(*batch, 3, 3), rms.reshape(batch)


def _nanmedian(x: Tensor) -> Tensor:
    """Median over the last dim ignoring NaN; an even count averages the two
    middle values, as ``jnp.nanmedian`` and numpy do (``torch.nanmedian``
    returns the lower one).  NaN where every value is NaN."""
    xs = torch.sort(x, dim=-1).values  # NaN sorts last
    n = torch.sum(~torch.isnan(x), dim=-1, keepdim=True)
    lo = torch.gather(xs, -1, torch.clamp((n - 1) // 2, min=0))[..., 0]
    hi = torch.gather(xs, -1, torch.clamp(n // 2, max=x.shape[-1] - 1))[..., 0]
    # jnp.nanmedian's linear interpolation at 0.5, term for term.
    return 0.5 * lo + 0.5 * hi


def esm_guard(h_base: Tensor, h_esm: Tensor, p1: Tensor, p2: Tensor,
              inlier_mask: Tensor, tol: float = 1.1) -> Tensor:
    """Geometry guard for the dense polish: accept the ESM model only if it
    does not degrade the matched-feature fit,

        median r2_esm(inliers) <= tol * median r2_base(inliers),

    with r2 the symmetric transfer error of the base model's inliers.

    Args:
      h_base, h_esm: (..., 3, 3); p1, p2: (..., N, 2); inlier_mask: (..., N).

    Returns a bool tensor (...) (combine with ``torch.where``).
    """
    r2b = symmetric_transfer_error(h_base, p1, p2)
    r2e = symmetric_transfer_error(h_esm, p1, p2)
    nan = torch.full_like(r2b, torch.nan)
    medb = _nanmedian(torch.where(inlier_mask, r2b, nan))
    mede = _nanmedian(torch.where(inlier_mask, r2e, nan))
    return _all_finite(h_esm) & (mede <= tol * medb)


def esm_track_pyramid(
    template: Tensor,
    image: Tensor,
    h0: Tensor,
    levels: int = 3,
    iters: int = 15,
    sampler: str = "auto",
) -> tuple:
    """Coarse-to-fine ESM: track at 1/2^(levels-1) ... full resolution.

    The homography is rescaled between levels with the similarity
    conjugation H_l = S_l H S_l^{-1}, S_l = diag(1/2^l, 1/2^l, 1).  Batched
    like :func:`esm_track`.

    Returns (h (..., 3, 3), rms at the finest level (...)).
    """
    _check_sampler(sampler)
    dt = template.dtype
    tpl = [template]
    img = [image.to(dt)]
    for _ in range(levels - 1):
        tpl.append(_down2(tpl[-1]))
        img.append(_down2(img[-1]))
    h = torch.as_tensor(h0, dtype=dt, device=template.device)
    rms = None
    for lvl in range(levels - 1, -1, -1):
        s = 0.5 ** lvl
        h_l = mm_highest(mm_highest(_diag3(s, h), h), _diag3(1.0 / s, h))
        h_l, rms = esm_track(tpl[lvl], img[lvl], h_l, iters=iters,
                             sampler=sampler)
        h = mm_highest(mm_highest(_diag3(1.0 / s, h), h_l), _diag3(s, h))
    return h, rms
