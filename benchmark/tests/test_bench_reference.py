"""The plain references: right on exact data, and never raising where a
consensus is degenerate (the lower-precision control meets such cases)."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark.core import gen_fit, ref_fit, ref_vo


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


CONFIG = {"n_points": 300, "image_wh": [640, 480], "corner_shift_px": 96.0,
          "inlier_noise_px": 0.0, "dtype": "float64"}


def test_fit_recovers_an_exact_homography():
    src, tar, h_true, is_out = gen_fit.fit_requests(_gen(1), 1, CONFIG, 0.5)
    h, mask = ref_fit.fit(src[0], tar[0], 3.0, 2048, _gen(2))
    assert ref_fit.corner_gap(h, h_true[0], 640, 480) < 1e-6
    assert torch.equal(mask, ~is_out[0])


def test_generator_sizes_are_fixed():
    src, tar, _, is_out = gen_fit.fit_requests(_gen(3), 4, CONFIG, 0.9)
    assert src.shape == tar.shape == (4, 300, 2)
    assert (is_out.sum(-1) == 270).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_collinear_points_do_not_raise(dtype):
    x = torch.linspace(0, 600, 50, dtype=torch.float64)
    src = torch.stack([x, 0.5 * x + 10], -1)
    tar = src + 3.0
    h, mask = ref_fit.fit(src, tar, 3.0, 256, _gen(), dtype)
    assert h.shape == (3, 3) and mask.shape == (50,)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_empty_mask_does_not_raise(dtype):
    src, tar, _, _ = gen_fit.fit_requests(_gen(4), 1, CONFIG, 0.5)
    valid = torch.zeros(300, dtype=torch.bool)
    h, mask = ref_fit.fit(src[0], tar[0], 3.0, 256, _gen(), dtype, valid)
    assert not mask.any()
    assert ref_fit.corner_gap(h, torch.eye(3, dtype=torch.float64),
                              640, 480) < 1e-3 or not torch.isfinite(h).all()


def test_all_outliers_do_not_raise():
    src, tar, _, _ = gen_fit.fit_requests(_gen(5), 1, CONFIG, 1.0)
    ref_fit.fit(src[0], tar[0], 3.0, 256, _gen(), torch.bfloat16)


def test_corner_gap_of_a_non_finite_model_is_infinite():
    h = torch.full((3, 3), torch.nan, dtype=torch.float64)
    assert ref_fit.corner_gap(h, torch.eye(3), 640, 480) == math.inf


def test_pose_of_an_exact_plane_homography():
    """Camera 2 at (R, t) over the plane z = 3: the decomposition returns
    them, with t scaled by the depth."""
    k = torch.tensor([[300.0, 0, 320], [0, 300.0, 240], [0, 0, 1]],
                     dtype=torch.float64)
    a = 0.05
    r = torch.tensor([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                      [-math.sin(a), 0, math.cos(a)]], dtype=torch.float64)
    t = torch.tensor([0.1, 0.02, 0.03], dtype=torch.float64)
    n = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)
    h = k @ (r + torch.outer(t, n) / 3.0) @ torch.linalg.inv(k)
    p1 = torch.rand((100, 2), generator=_gen(6), dtype=torch.float64) * 400
    p2 = ref_fit.apply_h(h, p1)
    r_est, t_over_d, n_est = ref_vo.pose(h, k, p1, p2,
                                        torch.ones(100, dtype=torch.bool), n)
    assert torch.allclose(r_est, r, atol=1e-9)
    assert torch.allclose(t_over_d * 3.0, t, atol=1e-9)
    assert torch.allclose(n_est, n, atol=1e-9)
