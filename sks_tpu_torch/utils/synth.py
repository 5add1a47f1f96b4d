"""Synthetic correspondence generation (port of ``sks_tpu/utils/synth.py``).

Exact plane-induced homographies from random camera geometry, and
correspondences under them, drawn from an explicit ``torch.Generator`` on the
generator's device — so a program can make its data without JAX.  The
streams differ from ``jax.random``'s; tests that compare the two packages
make their inputs with numpy instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

from sks_tpu_torch.geom.homography import apply_homography, homography_from_pose
from sks_tpu_torch.ops.aca_rect import rect_corners

__all__ = [
    "random_rotation",
    "random_plane_homographies",
    "random_correspondences",
    "random_quad_pairs",
    "rect_offset_pairs",
    "adversarial_quad_pairs",
]


def _uniform(generator, shape, dtype, lo, hi) -> Tensor:
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return lo + (hi - lo) * u


def random_rotation(generator: torch.Generator, batch: tuple = (),
                    max_angle: float = 0.4,
                    dtype=torch.float32) -> Tensor:
    """Small random rotations via axis-angle (Rodrigues), (..., 3, 3)."""
    axis = torch.randn((*batch, 3), generator=generator, dtype=dtype,
                       device=generator.device)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    ang = _uniform(generator, batch, dtype, -max_angle, max_angle)
    kx, ky, kz = axis[..., 0], axis[..., 1], axis[..., 2]
    z = torch.zeros_like(kx)
    kmat = torch.stack(
        [
            torch.stack([z, -kz, ky], dim=-1),
            torch.stack([kz, z, -kx], dim=-1),
            torch.stack([-ky, kx, z], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=dtype, device=generator.device)
    s = torch.sin(ang)[..., None, None]
    c = torch.cos(ang)[..., None, None]
    return eye + s * kmat + (1 - c) * (kmat @ kmat)


def random_plane_homographies(
    generator: torch.Generator, batch: tuple = (), focal: float = 600.0,
    dtype=torch.float32,
) -> Tensor:
    """Exact plane-induced homographies from random camera geometry, (..., 3, 3).

    Camera 1 at identity looking at the plane z = d; camera 2 randomly rotated
    and translated.  Every returned H is an exact homography (the oracle).
    """
    dev = generator.device
    k = torch.tensor(
        [[focal, 0.0, 320.0], [0.0, focal, 240.0], [0.0, 0.0, 1.0]],
        dtype=dtype,
    ).to(dev).expand(*batch, 3, 3)
    r = random_rotation(generator, batch, 0.3, dtype)
    t = _uniform(generator, (*batch, 3), dtype, -0.5, 0.5)
    d = _uniform(generator, batch, dtype, 2.0, 6.0)
    n = torch.tensor([0.0, 0.0, 1.0], dtype=dtype).to(dev).expand(*batch, 3)
    return homography_from_pose(k, k, r, t, n, d)


def random_correspondences(
    generator: torch.Generator,
    batch: tuple = (),
    n_points: int = 4,
    noise: float = 0.0,
    dtype=torch.float32,
):
    """(src, tar, H_true): exact-homography correspondences with optional noise.

    src points are drawn well-spread in a [0, 640) x [0, 480) image (one per
    cell of a jittered grid, to avoid near-degenerate quads); tar is their
    exact image under a random plane-induced homography plus Gaussian noise of
    the given pixel sigma.
    """
    dev = generator.device
    h = random_plane_homographies(generator, batch, dtype=dtype)
    gx = math.ceil(math.sqrt(n_points))
    ar = torch.arange(gx, dtype=dtype, device=dev)
    cells = torch.stack(torch.meshgrid(ar, ar, indexing="xy"), dim=-1)
    cells = cells.reshape(-1, 2)[:n_points]
    jit_ = _uniform(generator, (*batch, n_points, 2), dtype, 0.15, 0.85)
    scale = torch.tensor([640.0 / gx, 480.0 / gx], dtype=dtype).to(dev)
    src = (cells + jit_) * scale
    tar = apply_homography(h, src)
    if noise > 0:
        tar = tar + noise * torch.randn(tar.shape, generator=generator,
                                        dtype=dtype, device=dev)
    return src, tar, h


def random_quad_pairs(generator: torch.Generator, batch: int,
                      dtype=torch.float32):
    """Random general-position 4-point pairs, (batch, 4, 2) each."""
    src, tar, _ = random_correspondences(generator, (batch,), 4, 0.0, dtype)
    return src, tar


def rect_offset_pairs(
    generator: torch.Generator | None, batch: tuple = (), size: float = 128.0,
    max_offset: float = 32.0, dtype=torch.float32, *, u=None,
):
    """Deep-homography style input: rect corners + random corner offsets.

    The origin is uniform in [0, 32)^2, the rect ``size`` x ``size``, and
    each target corner the rect's corner plus a uniform offset in
    [0, ``max_offset``) per axis.  ``u=(u_origin (..., 2), u_offset (..., 4,
    2))`` takes the uniforms in [0, 1) in place of the generator's draws
    (given ``jax.random.uniform`` of the JAX package's two split keys, the
    pairs are its own).

    Returns (origin, wh, tar) in the order of :func:`sks_tpu_torch.ops.
    aca_rect`, on the generator's device (the uniforms' when given).
    """
    if u is None:
        u = tuple(torch.rand(shape, generator=generator, dtype=dtype,
                             device=generator.device)
                  for shape in ((*batch, 2), (*batch, 4, 2)))
    u_origin, u_offset = (torch.as_tensor(x, dtype=dtype) for x in u)
    origin = 32.0 * u_origin
    wh = torch.full((*batch, 2), size, dtype=dtype, device=origin.device)
    tar = rect_corners(origin, wh) + max_offset * u_offset.to(origin.device)
    return origin, wh, tar


def adversarial_quad_pairs(seed: int = 0, per_case: int = 6):
    """4-point pairs that reach the branches well-conditioned quads never do.

    Seeded numpy (so both packages can be fed the same arrays): ``per_case``
    random quads in a 640 x 480 image, displaced by ~20 px, are bent into each
    of these cases, in this order:

    ================  ====================================================
    ``general``       left as drawn
    ``collinear``     the 4 source points on one line (G singular: its
                      determinant is 0 up to rounding, its inverse infinite)
    ``collinear3``    3 source points on one line
    ``collinear_y``   the 4 source points on one horizontal line (the
                      determinant of G is exactly 0)
    ``repeated``      source point 1 equal to source point 0
    ``point``         all 4 source points equal (a zero-size quad: the
                      mean distance falls under the scale floor)
    ``point_tar``     all 4 target points equal
    ``subtiny``       source quad of size ~1e-39 (mean distance subnormal,
                      where the float32 and float64 branches floor apart)
    ``small``         every coordinate times 1e-20 (squares underflow)
    ``large``         every coordinate times 1e18 (products overflow)
    ``small_large``   source times 1e-20, target times 1e18
    ``identity``      target equal to source (a zero residual matrix)
    ``nan``           one source coordinate NaN
    ``nan_tar``       one target coordinate NaN
    ``inf``           one source coordinate infinite
    ``inf_tar``       one target coordinate infinite
    ================  ====================================================

    Returns ``(src, tar, labels)``: float64 arrays of shape
    ``(16 * per_case, 4, 2)`` and the case of each pair.
    """
    rng = np.random.default_rng(seed)
    cells = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])

    def draw():
        s = (cells + rng.uniform(0.15, 0.85, (per_case, 4, 2))) * (320.0, 240.0)
        return s, s + rng.normal(0.0, 20.0, (per_case, 4, 2))

    def collinear(s, t, count):
        step = rng.uniform(-40.0, 40.0, (per_case, 1, 2))
        along = np.arange(4.0)[None, :, None]
        line = s[:, :1] + step * along
        s[:, :count] = line[:, :count]
        return s, t

    def poke(which, value):
        def bend(s, t):
            arr = s if which == "src" else t
            arr[np.arange(per_case), rng.integers(0, 4, per_case),
                rng.integers(0, 2, per_case)] = value
            return s, t
        return bend

    def scaled(fs, ft):
        return lambda s, t: (s * fs, t * ft)

    def subtiny(s, t):
        return (s - s.mean(1, keepdims=True)) * (1e-39 / 320.0), t

    def collinear_y(s, t):
        s[..., 1] = np.round(s[:, :1, 1])
        return s, t

    cases = {
        "general": lambda s, t: (s, t),
        "collinear": lambda s, t: collinear(s, t, 4),
        "collinear3": lambda s, t: collinear(s, t, 3),
        "collinear_y": collinear_y,
        "repeated": lambda s, t: (np.concatenate([s[:, :1], s[:, :1],
                                                  s[:, 2:]], 1), t),
        "point": lambda s, t: (np.repeat(s[:, :1], 4, 1), t),
        "point_tar": lambda s, t: (s, np.repeat(t[:, :1], 4, 1)),
        "subtiny": subtiny,
        "small": scaled(1e-20, 1e-20),
        "large": scaled(1e18, 1e18),
        "small_large": scaled(1e-20, 1e18),
        "identity": lambda s, t: (s, s.copy()),
        "nan": poke("src", np.nan),
        "nan_tar": poke("tar", np.nan),
        "inf": poke("src", np.inf),
        "inf_tar": poke("tar", np.inf),
    }
    src, tar, labels = [], [], []
    for name, bend in cases.items():
        s, t = bend(*draw())
        src.append(s)
        tar.append(t)
        labels += [name] * per_case
    return np.concatenate(src), np.concatenate(tar), labels
