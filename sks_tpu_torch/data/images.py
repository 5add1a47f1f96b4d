"""Photometric planar image synthesis: a textured plane under exact homographies.

Port of ``sks_tpu/data/images.py``: a procedurally textured plane is rendered
under exact plane-induced homographies with photometric nuisances (gain,
bias, gamma, sensor noise, defocus blur), so the feature pipeline runs on
pixels while the ground-truth poses stay available for scoring: sequences
(``planar_sequence``), HPatches-style pairs (``planar_pair``) and pairs with
off-plane boxes (``planar_pair_boxes``, the parallax protocol).  Random
draws come from an explicit ``torch.Generator`` on its own device, so a
program renders its frames without JAX (their pixels differ from the JAX
package's for the same seed; the poses do not depend on the draw).
Nothing is stored on disk.

``photo_texture`` renders a real photograph as the plane instead: one of
the sample photographs that matplotlib and scikit-learn ship, read with
PIL where those packages are installed (``available_photos`` lists them;
on a machine without them it is empty and ``photo_texture`` returns None).
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import Tensor

from sks_tpu_torch.features.descriptors import bilinear_sample
from sks_tpu_torch.geom.homography import apply_homography, homography_from_pose
from sks_tpu_torch.utils.synth import random_rotation

__all__ = [
    "plane_texture",
    "photo_texture",
    "available_photos",
    "resize_linear",
    "warp_image",
    "photometric_jitter",
    "gaussian_blur",
    "planar_pair",
    "planar_pair_boxes",
    "planar_sequence",
]


def _uniform(generator, shape, dtype, lo, hi) -> Tensor:
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return lo + (hi - lo) * u


def resize_linear(img: Tensor, shape: tuple) -> Tensor:
    """Linear resize of (H, W) to ``shape`` with half-pixel centers: what
    ``jax.image.resize(img, shape, 'linear')`` computes.

    Like JAX, it antialiases along an axis that shrinks (the triangle
    kernel widened by the scale) and not along one that grows.  Where no
    axis shrinks it is one bilinear interpolation, as before.
    """
    h, w = img.shape[-2:]
    th, tw = shape
    x = img[None, None]
    if th >= h and tw >= w:
        return F.interpolate(x, size=(th, tw), mode="bilinear",
                             align_corners=False)[0, 0]
    # An axis shrinks: one pass an axis, each under its own rule.
    x = F.interpolate(x, size=(th, w), mode="bilinear", align_corners=False,
                      antialias=th < h)
    return F.interpolate(x, size=(th, tw), mode="bilinear",
                         align_corners=False, antialias=tw < w)[0, 0]


#: Sample photographs shipped inside other packages: name -> (package, path
#: inside it).  A portrait (512 x 600), close-up flora and urban architecture
#: (427 x 640 each), all RGB.
_PHOTO_CANDIDATES = {
    "hopper": ("matplotlib", "mpl-data/sample_data/grace_hopper.jpg"),
    "flower": ("sklearn", "datasets/images/flower.jpg"),
    "china": ("sklearn", "datasets/images/china.jpg"),
}


def _photo_path(name: str) -> str | None:
    """The file of photograph ``name``, or None where its package is absent."""
    import importlib.util

    if name not in _PHOTO_CANDIDATES:
        raise ValueError(
            f"unknown photo {name!r}; candidates: {sorted(_PHOTO_CANDIDATES)}")
    pkg, rel = _PHOTO_CANDIDATES[name]
    # The package's directory, found without importing it.
    spec = importlib.util.find_spec(pkg)
    if spec is None or not spec.submodule_search_locations:
        return None
    path = os.path.join(list(spec.submodule_search_locations)[0], rel)
    return path if os.path.isfile(path) else None


def _has_pil() -> bool:
    import importlib.util

    return importlib.util.find_spec("PIL") is not None


def available_photos() -> tuple:
    """Names of the photographs that can be loaded here (PIL and the file
    both present)."""
    if not _has_pil():
        return ()
    return tuple(name for name in _PHOTO_CANDIDATES
                 if _photo_path(name) is not None)


def photo_texture(shape: tuple = (480, 640), dtype=torch.float32,
                  name: str = "hopper", device="cuda") -> Tensor | None:
    """A real photograph as a [0, 1] grayscale plane texture, or None.

    Loads the named photograph (``_PHOTO_CANDIDATES``) with PIL, converts it
    to luminance, crops its center to the aspect ratio of ``shape`` (no
    anisotropic stretch) and resizes it to ``shape`` with
    :func:`resize_linear` on ``device``, as the JAX package does.  Returns
    None when PIL or the photograph is missing, so that callers can fall back
    to :func:`plane_texture`.
    """
    path = _photo_path(name)
    if path is None or not _has_pil():
        return None
    import numpy as np
    from PIL import Image

    with Image.open(path) as im:
        lum = np.array(im.convert("L"))
    arr = torch.from_numpy(lum).to(device=device, dtype=dtype) / 255.0
    h0, w0 = arr.shape
    th, tw = shape
    if h0 * tw > w0 * th:  # too tall: crop rows
        keep = max(1, (w0 * th) // tw)
        off = (h0 - keep) // 2
        arr = arr[off:off + keep, :]
    elif h0 * tw < w0 * th:  # too wide: crop columns
        keep = max(1, (h0 * tw) // th)
        off = (w0 - keep) // 2
        arr = arr[:, off:off + keep]
    # The linear kernel can overshoot [0, 1] by an ulp at the crop's edges.
    return torch.clamp(resize_linear(arr, shape), 0.0, 1.0)


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


def _pad_edge(x: Tensor, radius: int, dim: int) -> Tensor:
    """Replicate the edge values of ``x`` ``radius`` times along ``dim``."""
    n = x.shape[dim]
    first = x.narrow(dim, 0, 1).repeat_interleave(radius, dim=dim)
    last = x.narrow(dim, n - 1, 1).repeat_interleave(radius, dim=dim)
    return torch.cat([first, x, last], dim=dim)


def gaussian_blur(img: Tensor, sigma: float,
                  radius: int | None = None) -> Tensor:
    """Separable Gaussian blur of (..., H, W) with edge padding (the defocus
    nuisance of the pair renderers)."""
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    xs = torch.arange(-radius, radius + 1, dtype=img.dtype, device=img.device)
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    k = (k / torch.sum(k)).reshape(1, 1, -1)
    h, w = img.shape[-2:]
    # Columns, then rows: each a 1-D convolution over the last dim (the
    # kernel is symmetric, so correlation and convolution agree).
    x = _pad_edge(img, radius, -2).transpose(-1, -2)
    x = F.conv1d(x.reshape(-1, 1, h + 2 * radius), k).reshape(
        *img.shape[:-2], w, h).transpose(-1, -2)
    x = _pad_edge(x, radius, -1)
    return F.conv1d(x.reshape(-1, 1, w + 2 * radius), k).reshape(img.shape)


def _intrinsics(shape: tuple, focal: float, device) -> Tensor:
    h, w = shape
    return torch.tensor(
        [[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device)


def _random_scene(generator: torch.Generator, shape: tuple, focal: float,
                  max_angle: float, max_shift: float):
    """Shared scene draw of the pair renderers: intrinsics, a random camera
    pose, the main plane (frontal, depth 3) and its induced homography."""
    dev = generator.device
    k_mat = _intrinsics(shape, focal, dev)
    r = random_rotation(generator, (), max_angle, torch.float32)
    t = _uniform(generator, (3,), torch.float32, -max_shift, max_shift)
    n = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=dev)
    d = torch.tensor(3.0, dtype=torch.float32, device=dev)
    h_true = homography_from_pose(k_mat, k_mat, r, t, n, d)
    return k_mat, r, t, n, d, h_true


def _check_texture(texture, shape) -> None:
    if texture is not None and tuple(texture.shape[-2:]) != tuple(shape):
        raise ValueError(f"texture shape {tuple(texture.shape[-2:])} != "
                         f"requested {tuple(shape)}")


def planar_pair(generator: torch.Generator, shape: tuple = (480, 640),
                focal: float = 600.0, max_angle: float = 0.15,
                max_shift: float = 0.25, noise: float = 0.01,
                texture: Tensor | None = None, blur_sigma: float = 0.0):
    """One HPatches-style planar pair: (img1, img2, H_true 1->2 pixels).

    img1 is a fronto-parallel view of the textured plane; img2 the same plane
    from a perturbed camera (exact plane-induced homography), with
    independent photometric jitter on both views, on the generator's device.
    ``texture`` optionally supplies the plane's pixels (default
    :func:`plane_texture`); ``blur_sigma`` > 0 defocus-blurs the second view.
    The draws: the pose, then the texture, then each view's jitter.
    """
    _check_texture(texture, shape)
    _, _, _, _, _, h_true = _random_scene(generator, shape, focal, max_angle,
                                          max_shift)
    base = plane_texture(generator, shape) if texture is None else texture
    img1 = photometric_jitter(generator, base, noise)
    img2 = photometric_jitter(generator, warp_image(base, h_true), noise)
    if blur_sigma > 0.0:
        img2 = gaussian_blur(img2, blur_sigma)
    return img1, img2, h_true


def _box_params(generator: torch.Generator, num_boxes: int, shape: tuple,
                plane_depth: float):
    """Random off-plane box geometry: rects in the canonical view + depths.

    Boxes lie in planes parallel to the main plane but closer to the camera
    (depth in [0.55, 0.8] x plane depth), so their between-view motion is a
    different homography: parallax, not noise.
    """
    h, w = shape
    f32 = torch.float32
    bw = _uniform(generator, (num_boxes,), f32, 0.10, 0.22) * w
    bh = _uniform(generator, (num_boxes,), f32, 0.10, 0.22) * h
    x0 = _uniform(generator, (num_boxes,), f32, 0.08, 0.70) * w
    y0 = _uniform(generator, (num_boxes,), f32, 0.08, 0.70) * h
    depth = _uniform(generator, (num_boxes,), f32, 0.55, 0.80) * plane_depth
    return x0, y0, bw, bh, depth


#: Texel resolution of every box sprite (sampled through the warp, so the
#: on-screen size is the traced rect, not this).
_BOX_TEX = 64


def _composite_boxes(img, box_texs, params, k_mat, r, t, n, shape) -> tuple:
    """Composite off-plane boxes over a rendered view; returns (img, mask).

    Each box lives in a plane parallel to the main one at its own depth; its
    canonical->view homography is the plane-induced one at that depth.  Boxes
    are composited far to near (exact occlusion); ``mask`` marks the pixels
    covered by any box in this view.
    """
    x0, y0, bw, bh, depth = params
    h, w = shape
    ys = torch.arange(h, dtype=img.dtype, device=img.device)
    xs = torch.arange(w, dtype=img.dtype, device=img.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    h_box = homography_from_pose(k_mat, k_mat, r, t, n, depth)  # (nb, 3, 3)
    p_canon = apply_homography(torch.linalg.inv_ex(h_box).inverse, pix)
    u = (p_canon[..., 0] - x0[:, None]) / bw[:, None]  # (nb, h * w)
    v = (p_canon[..., 1] - y0[:, None]) / bh[:, None]
    inside = (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)
    vals = bilinear_sample(box_texs, torch.stack(
        [u * (_BOX_TEX - 1), v * (_BOX_TEX - 1)], dim=-1))
    # Far first, near last (near wins an overlap).
    order = torch.argsort(-depth, stable=True)
    inside, vals = inside[order], vals[order]
    for j in range(x0.shape[0]):
        img = torch.where(inside[j].reshape(h, w), vals[j].reshape(h, w), img)
    return img, inside.any(dim=0).reshape(h, w)


def planar_pair_boxes(generator: torch.Generator, shape: tuple = (480, 640),
                      focal: float = 600.0, max_angle: float = 0.15,
                      max_shift: float = 0.25, noise: float = 0.01,
                      texture: Tensor | None = None, blur_sigma: float = 0.0,
                      num_boxes: int = 4):
    """A planar pair with off-plane structure: the parallax protocol.

    Like :func:`planar_pair`, plus ``num_boxes`` textured rectangles floating
    in planes closer to the camera than the main plane.  Matches on a box are
    consistent with that box's own plane-induced homography, not the main
    plane's: structured outliers that form coherent alternative models (the
    case ``slam.tracking.esm_guard`` exists for).

    Returns (img1, img2, h_true, mask1, mask2): ``h_true`` is the main
    plane's homography; ``mask1/2`` are the exact per-view box-coverage
    masks.  The draws: the pose, the texture, the boxes, their textures,
    then each view's jitter.
    """
    _check_texture(texture, shape)
    k_mat, r, t, n, _, h_true = _random_scene(generator, shape, focal,
                                              max_angle, max_shift)
    base = plane_texture(generator, shape) if texture is None else texture
    params = _box_params(generator, num_boxes, shape, 3.0)
    box_texs = torch.stack([plane_texture(generator, (_BOX_TEX, _BOX_TEX),
                                          octaves=3)
                            for _ in range(num_boxes)])
    eye = torch.eye(3, dtype=torch.float32, device=k_mat.device)
    v1, mask1 = _composite_boxes(base, box_texs, params, k_mat, eye,
                                 torch.zeros_like(t), n, shape)
    v2, mask2 = _composite_boxes(warp_image(base, h_true), box_texs, params,
                                 k_mat, r, t, n, shape)
    img1 = photometric_jitter(generator, v1, noise)
    img2 = photometric_jitter(generator, v2, noise)
    if blur_sigma > 0.0:
        img2 = gaussian_blur(img2, blur_sigma)
    return img1, img2, h_true, mask1, mask2


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
    _check_texture(texture, shape)
    dev = generator.device
    f32 = torch.float32
    k_mat = _intrinsics(shape, focal, dev)
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
