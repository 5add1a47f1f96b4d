"""Rendered video for the VO cells: a camera sweeping over a textured plane.

A copy of ``sks_tpu_torch/data/images.py::planar_sequence`` and the helpers
it uses (the JAX package's ``sks_tpu/data/images.py``, ported), kept here so
that a change to the program cannot change the benchmark's frames.  Every
frame is a render of the same plane texture under the exact homography of
its pose, with gain, bias, gamma and sensor noise, on the generator's
device.  The trajectory (a lateral sweep with a slight push-in and gentle
yaw and roll) is the same for every seed; the texture and the photometric
nuisances are the seed's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor


def _uniform(generator, shape, dtype, lo, hi) -> Tensor:
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return lo + (hi - lo) * u


def resize_linear(img: Tensor, shape: tuple) -> Tensor:
    """Linear resize with half-pixel centers, antialiased along an axis that
    shrinks (``jax.image.resize(img, shape, 'linear')``)."""
    h, w = img.shape[-2:]
    th, tw = shape
    x = img[None, None]
    if th >= h and tw >= w:
        return F.interpolate(x, size=(th, tw), mode="bilinear",
                             align_corners=False)[0, 0]
    x = F.interpolate(x, size=(th, w), mode="bilinear", align_corners=False,
                      antialias=th < h)
    return F.interpolate(x, size=(th, tw), mode="bilinear",
                         align_corners=False, antialias=tw < w)[0, 0]


def plane_texture(generator: torch.Generator, shape: tuple,
                  octaves: int = 5, dtype=torch.float32) -> Tensor:
    """Multi-octave value noise in [0, 1]; the coarsest octave quantized into
    high-contrast cells (edges and corners for the detector)."""
    h, w = shape
    img = torch.zeros(shape, dtype=dtype, device=generator.device)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        gh = max(2, (h // 64) * (2 ** o))
        gw = max(2, (w // 64) * (2 ** o))
        grid = torch.rand((gh, gw), generator=generator, dtype=dtype,
                          device=generator.device)
        up = resize_linear(grid, shape)
        if o == 0:
            up = torch.round(up * 4.0) / 4.0
            layer_amp = 1.5
        else:
            layer_amp = amp
        img = img + layer_amp * up
        total += layer_amp
        amp *= 0.55
    img = img / total
    lo, hi = torch.min(img), torch.max(img)
    return (img - lo) / torch.clamp(hi - lo, min=1e-6)


def apply_homography(h: Tensor, pts: Tensor) -> Tensor:
    x, y = pts[..., 0], pts[..., 1]
    hb = h[..., None, :, :]
    u = hb[..., 0, 0] * x + hb[..., 0, 1] * y + hb[..., 0, 2]
    v = hb[..., 1, 0] * x + hb[..., 1, 1] * y + hb[..., 1, 2]
    w = hb[..., 2, 0] * x + hb[..., 2, 1] * y + hb[..., 2, 2]
    inv = 1.0 / w
    return torch.stack([u * inv, v * inv], dim=-1)


def bilinear_sample(img: Tensor, xy: Tensor) -> Tensor:
    """Sample (H, W) at (..., 2) [x, y]; clamped to the image."""
    h, w = img.shape[-2:]
    flat = img.reshape(-1, h * w)
    pts = xy.reshape(flat.shape[0], -1, 2)
    x = torch.clamp(pts[..., 0], 0.0, w - 1.001)
    y = torch.clamp(pts[..., 1], 0.0, h - 1.001)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0 = torch.nan_to_num(x0, nan=0.0).long()
    y0 = torch.nan_to_num(y0, nan=0.0).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)

    def at(yy, xx):
        return torch.gather(flat, -1, yy * w + xx)

    out = (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x1) * fx * (1 - fy)
           + at(y1, x0) * (1 - fx) * fy + at(y1, x1) * fx * fy)
    return out.reshape(xy.shape[:-1])


def warp_image(img: Tensor, h_mat: Tensor, fill: float = 0.5) -> Tensor:
    """Views of ``img`` under ``h_mat`` (..., 3, 3), source -> output pixels,
    by inverse warping; pixels from outside the source get ``fill``."""
    hh, ww = img.shape[-2:]
    hi = torch.linalg.inv_ex(h_mat).inverse
    ys = torch.arange(hh, dtype=img.dtype, device=img.device)
    xs = torch.arange(ww, dtype=img.dtype, device=img.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pts = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    src = apply_homography(hi, pts)
    vals = bilinear_sample(img, src)
    inside = ((src[..., 0] >= 0.0) & (src[..., 0] <= ww - 1.0)
              & (src[..., 1] >= 0.0) & (src[..., 1] <= hh - 1.0))
    vals = torch.where(inside, vals, torch.full_like(vals, fill))
    return vals.reshape(*vals.shape[:-1], hh, ww)


def photometric_jitter(generator: torch.Generator, img: Tensor,
                       noise: float, max_gain: float = 0.25,
                       max_bias: float = 0.1) -> Tensor:
    """Per-image gain, bias and gamma, then Gaussian sensor noise."""
    batch, dt = img.shape[:-2], img.dtype
    gain = 1.0 + _uniform(generator, batch, dt, -max_gain, max_gain)
    bias = _uniform(generator, batch, dt, -max_bias, max_bias)
    gamma = torch.exp(_uniform(generator, batch, dt, -0.2, 0.2))
    x = torch.clamp(img * gain[..., None, None] + bias[..., None, None],
                    0.0, 1.0) ** gamma[..., None, None]
    x = x + noise * torch.randn(img.shape, generator=generator, dtype=dt,
                                device=generator.device)
    return torch.clamp(x, 0.0, 1.0)


def intrinsics(shape: tuple, focal: float, device) -> Tensor:
    h, w = shape
    return torch.tensor(
        [[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device)


def planar_sequence(generator: torch.Generator, num_frames: int,
                    shape: tuple, focal: float, noise: float):
    """(frames (T, H, W), poses_gt (T, 4, 4) cam -> world, k_mat (3, 3)),
    the plane at depth 3 in frame 0, float32 on the generator's device."""
    dev = generator.device
    f32 = torch.float32
    k_mat = intrinsics(shape, focal, dev)
    d = torch.full((num_frames,), 3.0, dtype=f32, device=dev)
    n = torch.tensor([0.0, 0.0, 1.0], dtype=f32, device=dev)
    base = plane_texture(generator, shape)
    ts = torch.arange(num_frames, dtype=f32, device=dev) / max(
        num_frames - 1, 1)
    tx, ty, tz = 0.8 * ts, 0.2 * torch.sin(ts * math.pi), 0.15 * ts
    yaw, roll = 0.12 * ts, 0.06 * torch.sin(ts * 2 * math.pi)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cr, sr = torch.cos(roll), torch.sin(roll)
    zero, one = torch.zeros_like(cy), torch.ones_like(cy)
    ry = torch.stack([torch.stack([cy, zero, sy], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([-sy, zero, cy], -1)], -2)
    rz = torch.stack([torch.stack([cr, -sr, zero], -1),
                      torch.stack([sr, cr, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    r = ry @ rz
    t = torch.stack([tx, ty, tz], dim=-1)
    # H = K (R + t n^T / d) K^-1 for the world (frame-0) plane n.X = d.
    core = r + t[:, :, None] * n[None, None, :] / d[:, None, None]
    h_i = k_mat @ core @ torch.linalg.inv_ex(k_mat).inverse
    frames = photometric_jitter(generator, warp_image(base, h_i), noise)
    rt = r.transpose(-1, -2)
    ti = -(rt @ t[..., None])[..., 0]
    bot = torch.zeros((num_frames, 1, 4), dtype=f32, device=dev)
    bot[..., 3] = 1.0
    poses = torch.cat([torch.cat([rt, ti[..., None]], dim=-1), bot], dim=-2)
    return frames, poses, k_mat
