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


@pytest.mark.parametrize("sigma, radius", [(0.7, None), (1.5, None),
                                           (1.0, 4)])
def test_gaussian_blur_matches_jax(sigma, radius):
    img = np.random.default_rng(3).uniform(size=(40, 56)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: ji.gaussian_blur(x, sigma, radius))(
        img))
    got = ti.gaussian_blur(T(img), sigma, radius)
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=1e-6)
    # A batch of images blurs each.
    both = ti.gaussian_blur(T(np.stack([img, img[::-1].copy()])), sigma,
                            radius)
    np.testing.assert_allclose(to_np(both[0]), want, rtol=0, atol=1e-6)


def _jax_box_scene(seed, shape):
    """The JAX package's scene, box geometry and box textures as numpy."""
    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    scene = ji._random_scene(k[0], k[1], shape, 60.0, 0.15, 0.25)
    params = ji._box_params(k[2], 3, shape, 3.0)
    texs = jax.vmap(lambda kk: ji.plane_texture(kk, (64, 64), octaves=3))(
        jax.random.split(k[3], 3))
    return ([np.array(x) for x in scene], [np.array(x) for x in params],
            np.array(texs))


def test_box_compositing_matches_jax():
    """Off-plane boxes composited over both views of one scene: the same
    coverage masks and, where a box covers, its texture within 2e-5 (the
    bilinear samples of a texel grid traced through a homography)."""
    shape = (48, 64)
    (k_mat, r, t, n, _, h_true), params, texs = _jax_box_scene(4, shape)
    base = np.array(jax.jit(lambda kk: ji.plane_texture(kk, shape))(
        jax.random.PRNGKey(9)))
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    for view, (rr, tt_) in ((base, (eye, zero)), (
            np.asarray(jax.jit(ji.warp_image)(base, h_true)), (r, t))):
        img_j, mask_j = jax.jit(lambda *a: ji._composite_boxes(*a, shape))(
            view, texs, params, k_mat, rr, tt_, n)
        img_t, mask_t = ti._composite_boxes(
            T(view), T(texs), tuple(T(p) for p in params), T(k_mat), T(rr),
            T(tt_), T(n), shape)
        np.testing.assert_array_equal(to_np(mask_t), np.asarray(mask_j))
        assert 0.02 < float(mask_t.float().mean()) < 0.6
        np.testing.assert_allclose(to_np(img_t), np.asarray(img_j), rtol=0,
                                   atol=2e-5)


def _replay_scene(seed, shape, focal):
    """The port's draws of a pair renderer, replayed from its seed: the
    scene, then the texture, then (boxes) the box geometry."""
    g = torch.Generator().manual_seed(seed)
    scene = ti._random_scene(g, shape, focal, 0.15, 0.25)
    base = ti.plane_texture(g, shape)
    return g, scene, base


@pytest.mark.parametrize("blur", [0.0, 1.2])
def test_planar_pair_geometry(blur):
    """The second view is the texture warped by the returned H_true (the
    JAX package's warp of the port's texture by the port's H), up to the
    view's gain, bias, gamma and noise, and its blur."""
    shape, focal = (96, 128), 120.0
    img1, img2, h_true = ti.planar_pair(torch.Generator().manual_seed(2),
                                        shape, focal=focal, noise=0.0,
                                        blur_sigma=blur)
    _, scene, base = _replay_scene(2, shape, focal)
    assert torch.equal(h_true, scene[-1])
    warped = np.asarray(jax.jit(ji.warp_image)(to_np(base), to_np(h_true)))
    if blur:
        warped = np.asarray(ji.gaussian_blur(warped, blur))
    for got, want in ((img1, to_np(base)), (img2, warped)):
        corr = np.corrcoef(to_np(got).ravel(), want.ravel())[0, 1]
        assert corr > 0.97, corr
    assert img1.shape == img2.shape == shape


def test_planar_pair_boxes_geometry():
    """The coverage masks of both views are the JAX package's compositing of
    the port's own scene and box draws, replayed from the seed."""
    shape, focal = (96, 128), 120.0
    out = ti.planar_pair_boxes(torch.Generator().manual_seed(5), shape,
                               focal=focal, num_boxes=3)
    img1, img2, h_true, mask1, mask2 = out
    g, (k_mat, r, t, n, _, h), base = _replay_scene(5, shape, focal)
    params = [to_np(p) for p in ti._box_params(g, 3, shape, 3.0)]
    texs = np.zeros((3, 64, 64), np.float32)  # the masks need no texels
    assert torch.equal(h_true, h)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    for mask, (rr, tt_) in ((mask1, (eye, zero)), (mask2, (to_np(r),
                                                           to_np(t)))):
        _, want = ji._composite_boxes(to_np(base), texs, params,
                                      to_np(k_mat), rr, tt_, to_np(n), shape)
        np.testing.assert_array_equal(to_np(mask), np.asarray(want))
        assert 0.02 < float(mask.float().mean()) < 0.6
    assert 0.0 <= float(img1.min()) and float(img2.max()) <= 1.0
