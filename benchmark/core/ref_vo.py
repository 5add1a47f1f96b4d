"""The plain reference of planar visual odometry: frames in, per-pair poses
and inlier counts out.

Plain PyTorch, written from the pipeline's published description: Harris
corners (Sobel gradients, a Gaussian-smoothed structure tensor, k = 0.04)
with 9 x 9 non-maximum suppression, a 16-pixel border, the strongest K over
an octave pyramid and a sub-pixel quadratic fit; an 8 x 8 patch descriptor
on a 2-pixel grid, rotated to the smoothed-gradient orientation and scaled
by the octave, zero-mean and unit-norm; mutual nearest neighbours with a
0.9 ratio test; for each consecutive pair the reference fit of
``ref_fit.fit``; the homography's pose by the Faugeras-Lustman
decomposition (an SVD), the candidate chosen by cheirality and a plane
normal prior; and the metric chain of the known plane depth.  It computes in
the dtype it is given (float64 for the reference, bfloat16 for the control);
the SVDs and solves in float32 where the dtype has none.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor

from benchmark.core import ref_fit


def _filter1d(img: Tensor, taps, axis: int) -> Tensor:
    """Zero-padded 'same' correlation with ``taps`` along ``axis``."""
    r = len(taps) // 2
    x = F.pad(img, (r, r) if axis == -1 else (0, 0, r, r))
    n = img.shape[axis]
    out = torch.zeros_like(img)
    for i, t in enumerate(taps):
        if t != 0.0:
            out = out + t * x.narrow(axis, i, n)
    return out


def _separable(img, taps_h, taps_w):
    return _filter1d(_filter1d(img, taps_h, -2), taps_w, -1)


def _gauss(sigma: float, radius: int):
    g = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-radius, radius + 1)]
    return [v / sum(g) for v in g]


_SOBEL_S = (0.125, 0.25, 0.125)
_SOBEL_D = (-1.0, 0.0, 1.0)


def harris(img: Tensor, k: float = 0.04) -> Tensor:
    ix = _separable(img, _SOBEL_S, _SOBEL_D)
    iy = _separable(img, _SOBEL_D, _SOBEL_S)
    g = _gauss(1.5, 3)
    sxx = _separable(ix * ix, g, g)
    syy = _separable(iy * iy, g, g)
    sxy = _separable(ix * iy, g, g)
    return sxx * syy - sxy * sxy - k * (sxx + syy) ** 2


def _subpixel(resp: Tensor, yi: Tensor, xi: Tensor):
    """Quadratic fit of the 3 x 3 response around each maximum; the offset
    is kept where the fit is a maximum within 0.75 px (clamped to 0.5)."""
    h, w = resp.shape[-2:]
    yc, xc = yi.clamp(1, h - 2), xi.clamp(1, w - 2)
    flat = resp.flatten(-2)

    def at(dy, dx):
        return torch.gather(flat, -1, (yc + dy) * w + (xc + dx))

    r0 = at(0, 0)
    gx = 0.5 * (at(0, 1) - at(0, -1))
    gy = 0.5 * (at(1, 0) - at(-1, 0))
    hxx = at(0, 1) - 2.0 * r0 + at(0, -1)
    hyy = at(1, 0) - 2.0 * r0 + at(-1, 0)
    hxy = 0.25 * (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1))
    det = hxx * hyy - hxy * hxy
    safe = torch.where(det.abs() > 1e-20, det, torch.ones_like(det))
    ox = -(hyy * gx - hxy * gy) / safe
    oy = -(hxx * gy - hxy * gx) / safe
    good = (det > 0) & (hxx + hyy < 0) & (ox.abs() <= 0.75) & (
        oy.abs() <= 0.75)
    ox = torch.where(good, ox.clamp(-0.5, 0.5), torch.zeros_like(ox))
    oy = torch.where(good, oy.clamp(-0.5, 0.5), torch.zeros_like(oy))
    return yc.to(resp.dtype) + oy, xc.to(resp.dtype) + ox


def _strongest(x: Tensor, k: int):
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def corners(img: Tensor, k: int, nms: int = 4, border: int = 16):
    """(xy (T, k, 2), score (T, k), valid (T, k)) of one octave."""
    h, w = img.shape[-2:]
    resp = harris(img)
    pooled = F.max_pool2d(resp[:, None], 2 * nms + 1, stride=1,
                          padding=nms)[:, 0]
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (
        xs < w - border)
    keep = torch.where((resp >= pooled) & inside, resp,
                       torch.full_like(resp, -torch.inf))
    score, idx = _strongest(keep.flatten(-2), k)
    yy, xx = _subpixel(resp, idx // w, idx % w)
    return (torch.stack([xx, yy], -1), score,
            torch.isfinite(score) & (score > 0))


def corners_pyramid(frames: Tensor, k: int, octaves: int):
    """The strongest k corners over ``octaves`` 2x average-pooled levels:
    (xy, valid, scale), xy in full-resolution pixels."""
    xys, scores, valids, scales = [], [], [], []
    level = frames
    for o in range(octaves):
        xy, sc, va = corners(level, k)
        f = float(2 ** o)
        xys.append(xy * f + (f - 1) / 2.0)
        scores.append(torch.where(va, sc, torch.full_like(sc, -torch.inf)))
        valids.append(va)
        scales.append(torch.full_like(sc, f))
        h, w = level.shape[-2:]
        level = level[..., :h // 2 * 2, :w // 2 * 2].reshape(
            *level.shape[:-2], h // 2, 2, w // 2, 2).mean(dim=(-3, -1))
    score, idx = _strongest(torch.cat(scores, -1), k)
    xy = torch.gather(torch.cat(xys, -2), -2, idx[..., None].expand(
        *idx.shape, 2))
    valid = torch.gather(torch.cat(valids, -1), -1, idx) & torch.isfinite(
        score)
    return xy, valid, torch.gather(torch.cat(scales, -1), -1, idx)


def sample(img: Tensor, xy: Tensor) -> Tensor:
    """Bilinear samples of (T, H, W) at (T, ..., 2), clamped to the image."""
    t, h, w = img.shape
    flat = img.reshape(t, h * w)
    pts = xy.reshape(t, -1, 2)
    x = pts[..., 0].clamp(0.0, w - 1.001)
    y = pts[..., 1].clamp(0.0, h - 1.001)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)

    def at(yy, xx):
        return torch.gather(flat, -1, yy * w + xx)

    out = (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x1) * fx * (1 - fy)
           + at(y1, x0) * (1 - fx) * fy + at(y1, x1) * fx * fy)
    return out.reshape(xy.shape[:-1])


def describe(frames: Tensor, xy: Tensor, scale: Tensor, patch: int = 8,
             stride: float = 2.0) -> Tensor:
    """Oriented, scaled, normalized patch descriptors (T, K, patch^2)."""
    gx = _separable(frames, _SOBEL_S, _SOBEL_D)
    gy = _separable(frames, _SOBEL_D, _SOBEL_S)
    g = _gauss(4.0, 8)
    theta = torch.atan2(sample(_separable(gy, g, g), xy),
                        sample(_separable(gx, g, g), xy))
    half = (patch - 1) / 2.0
    grid = (torch.arange(patch, dtype=frames.dtype, device=frames.device)
            - half) * stride
    oy, ox = torch.meshgrid(grid, grid, indexing="ij")
    ox, oy = ox.reshape(-1), oy.reshape(-1)
    c, s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    rot = torch.stack([c * ox - s * oy, s * ox + c * oy], -1)
    vals = sample(frames, xy[..., None, :] + rot * scale[..., None, None])
    vals = vals - vals.mean(-1, keepdim=True)
    return vals / torch.sqrt((vals * vals).sum(-1, keepdim=True) + 1e-8)


def match(d1, d2, v1, v2, ratio: float = 0.9):
    """Mutual nearest neighbours passing the ratio test on squared
    distances: (index into the second set (P, K), valid (P, K))."""
    sim = d1 @ d2.transpose(-1, -2)
    ninf = torch.full_like(sim, -torch.inf)
    sim = torch.where(v2[..., None, :], sim, ninf)
    best2 = torch.argmax(sim, -1)
    top = torch.topk(sim, 2, dim=-1).values
    passes = (2 - 2 * top[..., 0]) < ratio * ratio * (2 - 2 * top[..., 1])
    best1 = torch.argmax(torch.where(v1[..., :, None], sim, ninf), -2)
    mutual = torch.gather(best1, -1, best2) == torch.arange(
        d1.shape[-2], device=d1.device)
    return best2, mutual & passes & v1


def _svd(m: Tensor):
    wide = ref_fit._wide(m.dtype)
    u, d, vh = torch.linalg.svd(m.to(wide))
    return u.to(m.dtype), d.to(m.dtype), vh.transpose(-1, -2).to(m.dtype)


def pose(h: Tensor, k_mat: Tensor, p1: Tensor, p2: Tensor, valid: Tensor,
         prior: Tensor):
    """(R, t/d, n) of a pixel homography by the Faugeras-Lustman closed
    form: the four candidates, the one whose points lie in front of both
    cameras for the largest share of the valid matches, plus 0.1 of its
    normal's agreement with ``prior``."""
    k_inv = torch.linalg.inv(k_mat.to(ref_fit._wide(h.dtype))).to(h.dtype)
    hn = k_inv @ h @ k_mat
    u, d, v = _svd(hn)
    d1, d3 = d[0] / d[1], d[2] / d[1]
    s = torch.linalg.det(u.to(ref_fit._wide(h.dtype))).to(h.dtype) * \
        torch.linalg.det(v.to(ref_fit._wide(h.dtype))).to(h.dtype)
    denom = (d1 * d1 - d3 * d3).clamp(min=1e-12)
    aux1 = torch.sqrt((d1 * d1 - 1).clamp(min=0) / denom)
    aux3 = torch.sqrt((1 - d3 * d3).clamp(min=0) / denom)
    sin_t = torch.sqrt((d1 * d1 - 1).clamp(min=0) * (1 - d3 * d3).clamp(
        min=0)) / (d1 + d3).clamp(min=1e-12)
    cos_t = (1 + d1 * d3) / (d1 + d3).clamp(min=1e-12)
    m1 = torch.cat([p1, torch.ones_like(p1[:, :1])], -1) @ k_inv.T
    m1 = m1 / m1[:, 2:3]
    best = None
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = sin_t * e1 * e3
            zero, one = torch.zeros_like(st), torch.ones_like(st)
            rp = torch.stack([torch.stack([cos_t, zero, -st]),
                              torch.stack([zero, one, zero]),
                              torch.stack([st, zero, cos_t])])
            r = s * (u @ rp @ v.T)
            t = u @ ((d1 - d3) * torch.stack([aux1 * e1, zero, -aux3 * e3]))
            n = v @ torch.stack([aux1 * e1, zero, aux3 * e3])
            if bool(n[2] < 0):
                n, t = -n, -t
            depth1 = m1 @ n
            z2 = (m1 @ r.T)[:, 2] / torch.where(
                depth1 == 0, torch.full_like(depth1, 1e-12), depth1) + t[2]
            front = ((depth1 > 0) & (z2 > 0) & valid).sum() / valid.sum(
            ).clamp(min=1)
            rank = float(front) + 0.1 * float(n @ prior)
            if best is None or rank > best[0]:
                best = (rank, r, t, n)
    return best[1], best[2], best[3]


def poses(frames: Tensor, k_mat: Tensor, config: dict, hypotheses: int,
          generator: torch.Generator, dtype=torch.float64):
    """The reference of one ``frames_to_poses`` call: (rel (T-1, 4, 4)
    metric cam_i -> cam_{i+1}, num_inliers (T-1,), valid (T-1,)), where
    ``valid`` counts each pair's matches."""
    f = frames.to(dtype)
    kk = k_mat.to(dtype)
    k = int(config["num_corners"])
    xy, valid, scale = corners_pyramid(f, k, int(config["num_octaves"]))
    desc = describe(f, xy, scale)
    idx2, ok = match(desc[:-1], desc[1:], valid[:-1], valid[1:])
    p1 = xy[:-1]
    p2 = torch.gather(xy[1:], -2, idx2[..., None].expand(*idx2.shape, 2))
    prior = torch.zeros(3, dtype=dtype, device=f.device)
    prior[2] = 1.0
    depth = torch.full((), float(config["plane_depth"]), dtype=dtype,
                       device=f.device)
    rel, inliers = [], []
    for i in range(frames.shape[0] - 1):
        h, mask = ref_fit.fit(p1[i], p2[i], float(config["threshold_px"]),
                              hypotheses, generator, dtype, valid=ok[i])
        r, t_over_d, n = pose(h, kk, p1[i], p2[i], ok[i], prior)
        t = t_over_d * depth
        depth = depth + (r @ n) @ t
        top = torch.cat([r, t[:, None]], -1)
        bottom = torch.zeros((1, 4), dtype=dtype, device=f.device)
        bottom[0, 3] = 1.0
        rel.append(torch.cat([top, bottom]))
        inliers.append(int(mask.sum()))
    return (torch.stack(rel).double().cpu(), torch.tensor(inliers),
            ok.sum(-1).cpu())
