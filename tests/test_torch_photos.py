"""Port parity, the photographs and the linear resize (``data/images.py``).

``photo_texture`` against the JAX package's for each photograph present
here (matplotlib's and scikit-learn's sample photographs, read with PIL), at
(240, 320), where the crop shrinks (antialiased), and at (480, 640), where
it grows: within 1e-6.  ``resize_linear`` against ``jax.image.resize(...,
'linear')`` on a 427 x 569 image: 1e-6 where both axes shrink or both grow;
5e-6 where one grows and one shrinks (two passes, one an axis; measured
2.9e-6).  Where no axis shrinks, ``resize_linear`` is the single bilinear
interpolation it was before antialiasing was added, bit for bit.

The JAX side runs as the JAX package does, with 64-bit types off
(``jax.enable_x64(False)``): under the suite's global x64 switch
``jax.image.resize`` computes a float32 image's antialiasing weights in
float64, 1.27e-5 closer to the exact float64 resize than JAX's own float32
path, which the port's float32 resize follows (2.4e-7 apart).
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_parity import to_np

import sks_tpu.data.images as ji

import sks_tpu_torch.data.images as ti

T = torch.from_numpy
PHOTOS = ti.available_photos()


def test_available_photos_match_jax():
    assert PHOTOS == ji.available_photos()


@pytest.mark.skipif(not PHOTOS, reason="no sample photograph or no PIL here")
@pytest.mark.parametrize("shape", [(240, 320), (480, 640)])
@pytest.mark.parametrize("name", ["hopper", "flower", "china"])
def test_photo_texture_matches_jax(name, shape):
    if name not in PHOTOS:
        pytest.skip(f"photograph {name!r} not present here")
    got = ti.photo_texture(shape, name=name, device="cpu")
    with jax.enable_x64(False):
        want = np.asarray(ji.photo_texture(shape, name=name))
    assert got.shape == shape and got.dtype == torch.float32
    assert got.device.type == "cpu"
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=1e-6)


def test_photo_texture_rejects_an_unknown_name():
    with pytest.raises(ValueError, match="unknown photo"):
        ti.photo_texture((48, 64), name="nope", device="cpu")


@pytest.mark.parametrize("shape,tol", [
    ((240, 320), 1e-6),  # both axes shrink
    ((480, 640), 1e-6),  # both grow
    ((600, 300), 5e-6),  # rows grow, columns shrink
    ((200, 700), 5e-6),  # rows shrink, columns grow
])
def test_resize_linear_matches_jax(shape, tol):
    img = np.random.default_rng(0).uniform(size=(427, 569)).astype(
        np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(
            lambda x: jax.image.resize(x, shape, "linear"))(img))
    got = to_np(ti.resize_linear(T(img), shape))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("src,shape", [((3, 5), (48, 64)),
                                       ((7, 10), (480, 640)),
                                       ((12, 9), (12, 40))])
def test_upsampling_stays_one_bilinear_interpolation(src, shape):
    grid = T(np.random.default_rng(1).uniform(size=src).astype(np.float32))
    plain = F.interpolate(grid[None, None], size=shape, mode="bilinear",
                          align_corners=False, antialias=False)[0, 0]
    assert torch.equal(ti.resize_linear(grid, shape), plain)
