"""Port parity, pose recovery: ``geom/pose.py`` against JAX.

Plane-induced homographies from seeded numpy geometry (camera 1 at the
origin, the plane z = d, camera 2 at a random (R, t)), exact and perturbed.
The JAX side is jitted on the CPU backend (its 3 x 3 eigendecomposition is
LAPACK's; the port's is its fixed-sweep Jacobi, whose eigenvector signs may
differ: ``s = det(U) det(V)`` absorbs them).  The selected (R, t/d, n) agree
within 1e-4 and the cheirality score is equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import apply_h, to_np

from sks_tpu.geom.pose import decompose_homography as jdecompose
from sks_tpu.geom.pose import recover_pose as jrecover

from sks_tpu_torch.geom.pose import decompose_homography, recover_pose

T = torch.from_numpy
K = np.array([[300.0, 0.0, 160.0], [0.0, 300.0, 120.0], [0.0, 0.0, 1.0]])


def _rotation(rng, max_angle):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(-max_angle, max_angle)
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(ang) * kx + (1 - np.cos(ang)) * kx @ kx


def _scenes(seed, count, noise):
    """``count`` (H, pts1, pts2, R, t/d) of plane-induced homographies."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        r = _rotation(rng, 0.2)
        t = rng.uniform(-0.4, 0.4, 3)
        d = rng.uniform(2.0, 5.0)
        h = K @ (r + np.outer(t, [0.0, 0.0, 1.0]) / d) @ np.linalg.inv(K)
        pts1 = rng.uniform((20.0, 20.0), (300.0, 220.0), (128, 2))
        pts2 = apply_h(h, pts1)
        h = h * (1.0 + noise * rng.normal(size=(3, 3)))
        out.append((h, pts1, pts2, r, t / d))
    return [np.stack(x).astype(np.float32) for x in zip(*out)]


@pytest.fixture(scope="module")
def jax_recover():
    return jax.jit(jax.vmap(jrecover, in_axes=(0, None, None, 0, 0, None)))


@pytest.mark.parametrize("noise", [0.0, 1e-3])
def test_recover_pose_matches_jax(jax_recover, noise):
    h, p1, p2, r_true, td_true = _scenes(3, 24, noise)
    k = K.astype(np.float32)
    prior = np.array([0.0, 0.0, 1.0], np.float32)
    rj, tj, nj, sj = (np.asarray(x) for x in jax_recover(h, k, k, p1, p2,
                                                          prior))
    rt, tt, nt, st = recover_pose(T(h), T(k), T(k), T(p1), T(p2), T(prior))
    np.testing.assert_allclose(to_np(rt), rj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(to_np(tt), tj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(to_np(nt), nj, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(to_np(st), sj)
    if noise == 0.0:
        # The exact homographies give back the truth.
        np.testing.assert_allclose(to_np(rt), r_true, atol=1e-3)
        np.testing.assert_allclose(to_np(tt), td_true, atol=1e-3)
        np.testing.assert_allclose(to_np(nt), np.broadcast_to(prior, nt.shape),
                                   atol=1e-3)
        assert (to_np(st) == 1.0).all()


def test_decomposition_candidates_and_degenerate_flag():
    """All four candidates reproduce the calibrated homography (R + t n^T
    up to scale), and a pure rotation is flagged degenerate, as in JAX."""
    h, _, _, r_true, _ = _scenes(4, 8, 0.0)
    kinv = np.linalg.inv(K)
    hn = (kinv @ h @ K).astype(np.float32)
    c = decompose_homography(T(hn))
    rec = to_np(c["r"] + c["t"][..., :, None] * c["n"][..., None, :])
    hs = hn / np.linalg.svd(hn, compute_uv=False)[:, 1][:, None, None]
    np.testing.assert_allclose(rec, np.broadcast_to(hs[:, None], rec.shape),
                               atol=1e-4)
    rot = np.stack([_rotation(np.random.default_rng(i), 0.2)
                    for i in range(4)]).astype(np.float32)
    assert to_np(decompose_homography(T(rot))["degenerate"]).all()
    assert np.asarray(jax.jit(jdecompose)(jnp.asarray(rot))["degenerate"]).all()
    assert not to_np(c["degenerate"]).any()
