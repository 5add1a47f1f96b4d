"""Port parity, the feature front end: Harris, descriptors and matching.

One JAX-rendered frame pair at (96, 128), 64 corners, one and two octaves;
the JAX side is jitted on the CPU backend.  Tolerances (float32, XLA
contracting multiply-adds on one side only): the Harris response within
1e-5 of its largest value; the corner *sets* (the order of equal responses
is not compared): equal valid counts and >= 98% of JAX's corners within
1e-3 px of one of the port's; descriptors on JAX's keypoints within 1e-4;
the matcher on JAX's descriptors: equal matches and masks; end to end,
>= 95% of JAX's matches found alike by the port.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from torch_parity import to_np

import sks_tpu.features.descriptors as jd
import sks_tpu.features.harris as jh
import sks_tpu.features.matching as jm
from sks_tpu.data.images import planar_sequence as jplanar_sequence

import sks_tpu_torch.features.descriptors as td
import sks_tpu_torch.features.harris as th
import sks_tpu_torch.features.matching as tm

T = torch.from_numpy
K = 64


@pytest.fixture(scope="module")
def pair():
    frames, _, _ = jplanar_sequence(jax.random.PRNGKey(1), 2, (96, 128),
                                    focal=120.0)
    return np.array(frames)


@pytest.fixture(scope="module", params=[1, 2])
def corners(request, pair):
    """JAX's pyramid corners of the first frame, and the port's."""
    octaves = request.param
    jfn = jax.jit(functools.partial(jh.detect_corners_pyramid, num_corners=K,
                                    num_octaves=octaves))
    want = tuple(np.array(x) for x in jfn(pair[0]))
    got = th.detect_corners_pyramid(T(pair[0]), K, octaves)
    return octaves, want, got


def test_harris_response_matches_jax(pair):
    want = np.asarray(jax.jit(jh.harris_response)(pair))
    got = to_np(th.harris_response(T(pair)))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_corner_sets_match_jax(corners):
    _, (xy_j, _, valid_j, scale_j), (xy_t, _, valid_t, scale_t) = corners
    xy_t, valid_t = to_np(xy_t), to_np(valid_t)
    assert valid_t.sum() == valid_j.sum() > 0
    a, b = xy_j[valid_j], xy_t[valid_t]
    dist = np.linalg.norm(a[:, None] - b[None], axis=-1)
    near = dist.min(axis=1) <= 1e-3
    assert near.mean() >= 0.98, near.mean()
    # The matched corners carry the same octave scale.
    nearest = dist.argmin(axis=1)[near]
    np.testing.assert_array_equal(to_np(scale_t)[valid_t][nearest],
                                  scale_j[valid_j][near])


def test_detect_corners_matches_jax(pair):
    jfn = jax.jit(functools.partial(jh.detect_corners, num_corners=K))
    xy_j, score_j, valid_j = (np.array(x) for x in jfn(pair[1]))
    xy_t, score_t, valid_t = th.detect_corners(T(pair[1]), K)
    # Both orders are a stable descending sort of the same responses.
    np.testing.assert_array_equal(to_np(valid_t), valid_j)
    np.testing.assert_allclose(to_np(xy_t)[valid_j], xy_j[valid_j], atol=1e-3)
    np.testing.assert_allclose(to_np(score_t)[valid_j], score_j[valid_j],
                               rtol=1e-4)


@pytest.mark.parametrize("orientation", ["gradient", "centroid"])
def test_descriptors_on_jax_keypoints_match_jax(pair, corners, orientation):
    _, (xy, _, _, scale), _ = corners
    jfn = jax.jit(functools.partial(jd.oriented_patch_descriptors,
                                    orientation=orientation,
                                    sampler="gather"))
    d_j, th_j = (np.asarray(x) for x in jfn(pair[0], xy, scale=scale))
    d_t, th_t = td.oriented_patch_descriptors(T(pair[0]), T(xy),
                                              scale=T(scale),
                                              orientation=orientation)
    np.testing.assert_allclose(to_np(th_t), th_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(to_np(d_t), d_j, rtol=0, atol=1e-4)
    plain_j = np.asarray(jax.jit(functools.partial(
        jd.patch_descriptors, sampler="gather"))(pair[0], xy))
    np.testing.assert_allclose(to_np(td.patch_descriptors(T(pair[0]), T(xy))),
                               plain_j, rtol=0, atol=1e-4)


def _jax_features(frames):
    fn = jax.jit(functools.partial(jm.describe_frames, num_corners=K,
                                   num_octaves=2))
    return {k: np.array(v) for k, v in fn(frames).items()}


def test_matcher_on_jax_descriptors_matches_jax(pair):
    f = _jax_features(pair)
    args = (f["desc"][0], f["desc"][1], f["valid"][0], f["valid"][1])
    idx_j, valid_j = (np.asarray(x) for x in jax.jit(jm.match_descriptors)(
        *args))
    idx_t, valid_t = tm.match_descriptors(*(T(a) for a in args))
    assert idx_t.dtype == torch.int32
    np.testing.assert_array_equal(to_np(valid_t), valid_j)
    np.testing.assert_array_equal(to_np(idx_t), idx_j)
    assert valid_j.sum() > 10
    # A leading pair axis matches each pair as alone.
    idx_b, valid_b = tm.match_descriptors(
        *(T(np.stack([a, a])) for a in args))
    assert torch.equal(idx_b[1], idx_t) and torch.equal(valid_b[1], valid_t)


def test_matching_end_to_end_matches_jax(pair):
    jfn = jax.jit(functools.partial(jm.match_frames_oriented, num_corners=K,
                                    num_octaves=2))
    p1_j, p2_j, v_j, _ = (np.asarray(x) for x in jfn(pair[0], pair[1]))
    p1_t, p2_t, v_t, q_t = (to_np(x) for x in tm.match_frames_oriented(
        T(pair[0]), T(pair[1]), K, 2))
    a = np.concatenate([p1_j, p2_j], -1)[v_j]
    b = np.concatenate([p1_t, p2_t], -1)[v_t]
    same = (np.abs(a[:, None] - b[None]).max(-1) <= 1e-3).any(1)
    assert same.mean() >= 0.95, same.mean()
    assert abs(int(v_t.sum()) - int(v_j.sum())) <= max(1, v_j.sum() // 20)
    # describe_frames + match_features is the same matcher on cached
    # features.
    f = tm.describe_frames(T(pair), K, 2)
    first = {k: v[0] for k, v in f.items()}
    second = {k: v[1] for k, v in f.items()}
    p1_c, p2_c, v_c, q_c = (to_np(x) for x in tm.match_features(first, second))
    np.testing.assert_array_equal(v_c, v_t)
    np.testing.assert_allclose(p2_c[v_c], p2_t[v_t], atol=1e-5)


def test_matmul_sampler_is_not_ported(pair):
    xy = torch.tensor([[40.0, 40.0]])
    with pytest.raises(ValueError, match="matmul"):
        td.patch_descriptors(T(pair[0]), xy, sampler="matmul")
    assert td.patch_descriptors(T(pair[0]), xy, sampler="gather").shape == (
        1, 64)
