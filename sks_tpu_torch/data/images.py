"""Photometric planar image synthesis: a textured plane under exact homographies.

Port of the sequence renderer of ``sks_tpu/data/images.py``: a procedurally
textured plane is rendered under exact plane-induced homographies with
photometric nuisances (gain, bias, gamma, sensor noise), so the feature
pipeline runs on pixels while the ground-truth poses stay available for
scoring.  Random draws come from an explicit ``torch.Generator`` on its own
device, so a program renders its frames without JAX (their pixels differ
from the JAX package's for the same seed; the poses do not depend on the
draw).  Nothing is stored on disk.

``photo_texture``, ``planar_pair``, ``planar_pair_boxes`` and
``gaussian_blur`` are not ported yet (ROADMAP.md Queue A item 10).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor

from sks_tpu_torch.features.descriptors import bilinear_sample
from sks_tpu_torch.geom.homography import apply_homography, homography_from_pose

__all__ = [
    "plane_texture",
    "resize_linear",
    "warp_image",
    "photometric_jitter",
    "planar_sequence",
]


def _uniform(generator, shape, dtype, lo, hi) -> Tensor:
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return lo + (hi - lo) * u


def resize_linear(img: Tensor, shape: tuple) -> Tensor:
    """Linear resize of (H, W) to ``shape`` with half-pixel centers: what
    ``jax.image.resize(img, shape, 'linear')`` computes when upsampling."""
    return F.interpolate(img[None, None], size=tuple(shape), mode="bilinear",
                         align_corners=False, antialias=False)[0, 0]


def plane_texture(generator: torch.Generator, shape: tuple = (480, 640),
                  octaves: int = 5, dtype=torch.float32) -> Tensor:
    """Multi-octave value-noise texture with corner-rich structure in [0, 1].

    Octave 0 is quantized into high-contrast cells (edges and corners for the
    detector); finer octaves add texture the descriptors can discriminate.
    """
    h, w = shape
    img = torch.zeros(shape, dtype=dtype, device=generator.device)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        gh = max(2, (h // 64) * (2 ** o))
        gw = max(2, (w // 64) * (2 ** o))
        grid = torch.rand((gh, gw), generator=generator, dtype=dtype,
                          device=generator.device)
        up = resize_linear(grid, shape)
        if o == 0:
            # Quantize the coarsest octave: sharp edges, strong corners.
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


def warp_image(img: Tensor, h_mat: Tensor, out_shape: tuple | None = None,
               fill: float = 0.5) -> Tensor:
    """Render the views of ``img`` (H, W) under homographies ``h_mat``
    (..., 3, 3): (..., *out_shape).

    ``h_mat`` maps source pixels -> output pixels; rendering inverse-warps:
    out(x') = img(H^{-1} x').  Out-of-source pixels get ``fill``.
    """
    if out_shape is None:
        out_shape = img.shape[-2:]
    hh, ww = out_shape
    hi = torch.linalg.inv_ex(h_mat).inverse
    ys = torch.arange(hh, dtype=img.dtype, device=img.device)
    xs = torch.arange(ww, dtype=img.dtype, device=img.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pts = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    src = apply_homography(hi, pts)  # (..., hh * ww, 2)
    vals = bilinear_sample(img, src)
    h0, w0 = img.shape[-2:]
    inside = ((src[..., 0] >= 0.0) & (src[..., 0] <= w0 - 1.0)
              & (src[..., 1] >= 0.0) & (src[..., 1] <= h0 - 1.0))
    vals = torch.where(inside, vals, torch.full_like(vals, fill))
    return vals.reshape(*vals.shape[:-1], hh, ww)


def photometric_jitter(generator: torch.Generator, img: Tensor,
                       noise: float = 0.01, max_gain: float = 0.25,
                       max_bias: float = 0.1) -> Tensor:
    """Sensor-style nuisances: gain/bias, gamma, additive Gaussian noise.

    ``img`` is (..., H, W): every image of the leading dims draws its own
    gain, bias and gamma.
    """
    batch, dt = img.shape[:-2], img.dtype
    gain = 1.0 + _uniform(generator, batch, dt, -max_gain, max_gain)
    bias = _uniform(generator, batch, dt, -max_bias, max_bias)
    gamma = torch.exp(_uniform(generator, batch, dt, -0.2, 0.2))
    x = torch.clamp(img * gain[..., None, None] + bias[..., None, None],
                    0.0, 1.0) ** gamma[..., None, None]
    x = x + noise * torch.randn(img.shape, generator=generator, dtype=dt,
                                device=generator.device)
    return torch.clamp(x, 0.0, 1.0)


def planar_sequence(generator: torch.Generator, num_frames: int = 16,
                    shape: tuple = (240, 320), focal: float = 300.0,
                    noise: float = 0.005, texture: Tensor | None = None,
                    loop: bool = False):
    """A camera orbiting over a textured plane: frames + GT poses.

    Smooth trajectory (lateral sweep with gentle yaw); every frame is a
    render of the same plane texture under the exact pose-induced
    homography, on the generator's device.  ``texture`` optionally supplies
    the plane pixels.  ``loop=True`` closes the trajectory (the camera
    returns toward its start pose) so frame 0 and frame T-1 overlap — the
    protocol for loop-closure experiments.  Returns (frames (T, H, W),
    poses_gt (T, 4, 4) cam->world, k_mat (3, 3)) with the plane at z = d in
    frame 0 (d = 3).
    """
    if texture is not None and tuple(texture.shape[-2:]) != tuple(shape):
        raise ValueError(f"texture shape {tuple(texture.shape[-2:])} != "
                         f"requested {tuple(shape)}")
    dev = generator.device
    f32 = torch.float32
    h, w = shape
    k_mat = torch.tensor(
        [[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0], [0.0, 0.0, 1.0]],
        dtype=f32, device=dev,
    )
    d = torch.tensor(3.0, dtype=f32, device=dev)
    n = torch.tensor([0.0, 0.0, 1.0], dtype=f32, device=dev)
    base = plane_texture(generator, shape) if texture is None else texture

    ts = torch.arange(num_frames, dtype=f32, device=dev) / max(num_frames - 1,
                                                                1)
    if loop:
        # Closed circuit: sinusoidal out-and-back in x, a y bulge, no net
        # push-in; the final pose nearly coincides with the start.
        tx = 0.5 * torch.sin(ts * 2 * math.pi)
        ty = 0.25 * (1.0 - torch.cos(ts * 2 * math.pi))
        tz = 0.08 * torch.sin(ts * 2 * math.pi)
        yaw = 0.10 * torch.sin(ts * 2 * math.pi)
        roll = 0.05 * torch.sin(ts * 2 * math.pi)
    else:
        # Lateral sweep + slight push-in + gentle yaw/roll ramp.
        tx = 0.8 * ts
        ty = 0.2 * torch.sin(ts * math.pi)
        tz = 0.15 * ts
        yaw = 0.12 * ts
        roll = 0.06 * torch.sin(ts * 2 * math.pi)

    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cr, sr = torch.cos(roll), torch.sin(roll)
    zero, one = torch.zeros_like(cy), torch.ones_like(cy)
    ry = torch.stack([torch.stack([cy, zero, sy], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([-sy, zero, cy], -1)], -2)
    rz = torch.stack([torch.stack([cr, -sr, zero], -1),
                      torch.stack([sr, cr, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    r = ry @ rz  # (T, 3, 3)
    t = torch.stack([tx, ty, tz], dim=-1)  # (T, 3)
    # World (= frame-0 camera) -> camera i: X_c = R X_w + t.
    h_i = homography_from_pose(k_mat, k_mat, r, t, n.expand(num_frames, 3),
                               d.expand(num_frames))
    frames = photometric_jitter(generator, warp_image(base, h_i), noise)
    # cam->world poses for ATE: the inverse of world->cam.
    rt = r.transpose(-1, -2)
    ti = -(rt @ t[..., None])[..., 0]
    bot = torch.zeros((num_frames, 1, 4), dtype=f32, device=dev)
    bot[..., 3] = 1.0
    poses = torch.cat([torch.cat([rt, ti[..., None]], dim=-1), bot], dim=-2)
    return frames, poses, k_mat
