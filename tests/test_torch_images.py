"""Port parity, the sequence renderer (``data/images.py``) against JAX.

The port draws from a ``torch.Generator``, so its pixels differ from JAX's
for the same seed; what does not depend on the draw is compared: the warp of
one texture under one homography (within 1e-5), the linear resize of one
grid (within 1e-6), and the sequence's ground-truth poses and intrinsics
(within 1e-6).  The JAX side is jitted on the CPU backend.
"""

import jax
import numpy as np
import pytest
import torch

from torch_parity import to_np

import sks_tpu.data.images as ji

import sks_tpu_torch.data.images as ti

T = torch.from_numpy


@pytest.mark.parametrize("shape", [(48, 64), (96, 128)])
def test_resize_matches_jax_linear_resize(shape):
    grid = np.random.default_rng(0).uniform(size=(shape[0] // 16,
                                                  shape[1] // 16))
    grid = grid.astype(np.float32)
    want = np.asarray(jax.jit(lambda g: jax.image.resize(g, shape, "linear"))(
        grid))
    np.testing.assert_allclose(to_np(ti.resize_linear(T(grid), shape)), want,
                               rtol=0, atol=1e-6)


def test_warp_image_matches_jax():
    tex = np.array(jax.jit(lambda k: ji.plane_texture(k, (60, 80)))(
        jax.random.PRNGKey(2)))
    h = np.array([[1.05, 0.03, -4.0], [-0.02, 0.98, 3.0],
                  [1e-4, -2e-4, 1.0]], np.float32)
    want = np.asarray(jax.jit(ji.warp_image)(tex, h))
    got = to_np(ti.warp_image(T(tex), T(h)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # A batch of homographies renders each view.
    both = ti.warp_image(T(tex), T(np.stack([h, np.eye(3, dtype=np.float32)])))
    np.testing.assert_allclose(to_np(both[0]), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(to_np(both[1]), tex, rtol=0, atol=1e-6)


@pytest.mark.parametrize("loop", [False, True])
def test_planar_sequence_geometry_matches_jax(loop):
    frames_j, poses_j, k_j = jax.jit(
        lambda k: ji.planar_sequence(k, 5, (48, 64), focal=60.0, loop=loop))(
            jax.random.PRNGKey(0))
    frames, poses, k_mat = ti.planar_sequence(
        torch.Generator().manual_seed(0), 5, (48, 64), focal=60.0, loop=loop)
    np.testing.assert_allclose(to_np(poses), np.asarray(poses_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(to_np(k_mat), np.asarray(k_j), rtol=0,
                               atol=1e-6)
    assert frames.shape == frames_j.shape == (5, 48, 64)
    assert frames.dtype == torch.float32
    assert 0.0 <= float(frames.min()) and float(frames.max()) <= 1.0
    assert float(frames.std()) > 0.1  # a textured render, not a fill


def test_texture_and_jitter_stay_in_range():
    g = torch.Generator().manual_seed(5)
    tex = ti.plane_texture(g, (32, 48))
    assert tex.shape == (32, 48)
    assert float(tex.min()) == 0.0 and float(tex.max()) == 1.0
    x = ti.photometric_jitter(g, tex.expand(3, 32, 48), noise=0.05)
    assert x.shape == (3, 32, 48)
    assert 0.0 <= float(x.min()) and float(x.max()) <= 1.0
    # Each image of the batch draws its own gain and bias.
    assert not torch.allclose(x[0], x[1], atol=1e-2)
    same = ti.plane_texture(torch.Generator().manual_seed(5), (32, 48))
    assert torch.equal(tex, same)
