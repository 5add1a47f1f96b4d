"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Every input is made with seeded numpy and handed to both packages, since
``jax.random`` and ``torch.Generator`` draw different streams.
"""

import numpy as np
import torch

# The suite runs several pytest-xdist workers; one thread each keeps torch's
# CPU kernels from oversubscribing the cores.
torch.set_num_threads(1)

K_MAT = np.array([[600.0, 0.0, 320.0], [0.0, 600.0, 240.0], [0.0, 0.0, 1.0]])


def plane_h(rng) -> np.ndarray:
    """An exact plane-induced homography from random camera geometry (f64)."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(-0.3, 0.3)
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    r = np.eye(3) + np.sin(ang) * kx + (1 - np.cos(ang)) * kx @ kx
    t = rng.uniform(-0.5, 0.5, 3)
    d = rng.uniform(2.0, 6.0)
    return K_MAT @ (r + np.outer(t, [0.0, 0.0, 1.0]) / d) @ np.linalg.inv(K_MAT)


def apply_h(h: np.ndarray, pts: np.ndarray) -> np.ndarray:
    p = pts @ h[:2, :2].T + h[:2, 2]
    w = pts @ h[2, :2] + h[2, 2]
    return p / w[..., None]


def quads(seed: int, batch: int, dtype=np.float32):
    """(src, tar) general-position 4-point pairs, (batch, 4, 2) each.

    One source point per cell of a jittered 2x2 grid over a 640x480 image (as
    ``sks_tpu.utils.synth`` spreads them), targets displaced by ~20 px: well
    conditioned, so float32 parity holds at the stated tolerance.
    """
    rng = np.random.default_rng(seed)
    cells = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    src = (cells + rng.uniform(0.15, 0.85, (batch, 4, 2))) * (320.0, 240.0)
    tar = src + rng.normal(0.0, 20.0, (batch, 4, 2))
    return src.astype(dtype), tar.astype(dtype)


def contaminated(seed: int, n: int = 256, outlier_frac: float = 0.5,
                 noise: float = 0.5):
    """(src, tar, H_true, true_inlier_mask): the first outlier_frac * n
    targets are replaced by uniform junk; src/tar float32."""
    rng = np.random.default_rng(seed)
    h = plane_h(rng)
    src = rng.uniform((0.0, 0.0), (640.0, 480.0), (n, 2))
    tar = apply_h(h, src) + noise * rng.normal(size=(n, 2))
    n_out = int(n * outlier_frac)
    tar[:n_out] = rng.uniform(0.0, 640.0, (n_out, 2))
    inl = np.arange(n) >= n_out
    return src.astype(np.float32), tar.astype(np.float32), h, inl


def fro(h) -> np.ndarray:
    """Unit-Frobenius, positive-h22 canonical scale of (..., 3, 3) homographies."""
    h = np.asarray(h, np.float64)
    n = np.sqrt(np.sum(h * h, axis=(-2, -1), keepdims=True))
    s = np.sign(h[..., 2:3, 2:3])
    s = np.where(s == 0, 1.0, s)
    return h / (n * s)


def to_np(x) -> np.ndarray:
    """A torch tensor or JAX array as numpy; bfloat16 widens to float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def to_tiles(soa) -> np.ndarray:
    """The port's (C, B) component-major layout as the TPU's (C, B/128, 128)
    lane tiles (B a multiple of 128)."""
    a = to_np(soa) if isinstance(soa, torch.Tensor) else np.asarray(soa)
    c, b = a.shape
    return a.reshape(c, b // 128, 128)


def from_tiles(tiles) -> np.ndarray:
    """The TPU's (C, M, 128) lane tiles as the port's (C, M * 128)."""
    a = to_np(tiles)
    return a.reshape(a.shape[0], -1)
