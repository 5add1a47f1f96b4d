"""Port parity, fp64 scoring: ``residual2_fp64`` and RANSAC with
``df64_scoring=True`` against the JAX package's double-float scoring.

The JAX side runs jitted on the CPU backend; RANSAC parity goes through the
``indices=`` seam, as in tests/test_torch_ransac.py.  Both sides take the
same float32 hypotheses and points and return float32 residuals: the port's
are float64 results rounded once, so they sit within half a float32 ulp
(6e-8 relative) of a float64 oracle.

Raw division-free ACA hypotheses carry entries up to ~1e22.  Both packages
first rescale H by ``2^-ceil(log2 max|H|)``.  The port's factor is an exact
power of two; the JAX package's is not on the CPU (XLA's float32 ``exp2``
is off by an ulp there), so its H moves by ~6e-8 relative, and the reverse
transfers of ill-conditioned hypotheses move with it: measured up to 10x on
a residual near zero, 0.3 at the 99th percentile, 3.4e-7 at the median.
On raw hypotheses the port is therefore held to the float64 oracle and to
JAX's inlier masks and median; on normalised hypotheses to JAX's residuals
at 1e-6 relative (measured 1.8e-7).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_ransac import _hyps, _refine_inputs
from torch_parity import contaminated, fro, to_np

import sks_tpu.robust.ransac as jr
from sks_tpu.ops.df64 import residual2_df64

import sks_tpu_torch
import sks_tpu_torch.robust.ransac as tr
from sks_tpu_torch.ops import aca_h
from sks_tpu_torch.ops.fp64 import residual2_fp64
from sks_tpu_torch.utils.convert import ransac_config_from

T = torch.from_numpy


def _raw_aca_problem(seed=42, b=32, n=96):
    """(raw ACA hypotheses (b, 3, 3) float32, src, tar): distinct-point
    minimal sets of a contaminated point set."""
    src, tar, _, _ = contaminated(seed, n=n, outlier_frac=0.4, noise=0.7)
    rng = np.random.default_rng(seed + 1)
    idx = np.stack([rng.choice(n, 4, replace=False) for _ in range(b)])
    h = to_np(aca_h(T(src[idx]).double(), T(tar[idx]).double()))
    return h.astype(np.float32), src, tar


def _oracle(h, src, tar):
    """float64 symmetric transfer with numpy's inverse."""
    h = h.astype(np.float64) / np.abs(h).max(axis=(1, 2), keepdims=True)
    src, tar = src.astype(np.float64), tar.astype(np.float64)

    def transfer(m, p):
        q = np.einsum("bij,nj->bni", m[:, :2, :2], p) + m[:, None, :2, 2]
        w = np.einsum("bj,nj->bn", m[:, 2, :2], p) + m[:, 2, 2, None]
        return q / w[..., None]

    return (np.sum((transfer(h, src) - tar) ** 2, -1)
            + np.sum((transfer(np.linalg.inv(h), tar) - src) ** 2, -1))


@pytest.mark.parametrize("scale", ["raw", "h22", "fro"])
def test_residual2_fp64_matches_jax_and_float64(scale):
    h, src, tar = _raw_aca_problem()
    assert np.abs(h).max() > 1e20
    if scale == "h22":
        h = (h.astype(np.float64) / h[:, 2:3, 2:3]).astype(np.float32)
    elif scale == "fro":
        h = fro(h).astype(np.float32)
    rt = residual2_fp64(T(h), T(src), T(tar))
    assert rt.dtype == torch.float32 and rt.shape == (32, 96)
    rt = to_np(rt)
    # atol: a minimal set's own 4 points fit to float64 rounding, ~1e-16.
    np.testing.assert_allclose(rt, _oracle(h, src, tar), rtol=1.2e-7,
                               atol=1e-12)
    # Rescaling H by a power of two changes nothing, bit for bit.
    np.testing.assert_array_equal(
        to_np(residual2_fp64(T(np.ldexp(h, -7)), T(src), T(tar))), rt)
    rj = np.asarray(jax.jit(residual2_df64)(h, src, tar))
    for thr in (1.0, 3.0, 4.0):
        np.testing.assert_array_equal(rt < thr * thr, rj < thr * thr)
    if scale == "raw":
        gap = np.abs(rt - rj) / np.maximum(rt, 1e-6)
        assert np.median(gap) <= 1e-6, np.median(gap)
    else:
        np.testing.assert_allclose(rt, rj, rtol=1e-6, atol=1e-9)


def test_residual2_fp64_keeps_float64_points():
    h, src, tar = _raw_aca_problem(seed=44, b=8)
    r = residual2_fp64(T(h), T(src).double(), T(tar).double())
    assert r.dtype == torch.float64
    np.testing.assert_allclose(to_np(r), _oracle(h, src, tar), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("scoring,masked", [
    ("inliers", False), ("msac", True), ("magsac", False), ("lmeds", True),
])
def test_score_hypotheses_df64_matches_jax(scoring, masked):
    h, src, tar, mask = _hyps(seed=1)
    pm = mask if masked else None
    sj, ij = jax.jit(lambda h, s, t, m: jr.score_hypotheses(
        h, s, t, 4.0, m, scoring, df64=True))(h, src, tar, pm)
    st, it = tr.score_hypotheses(T(h), T(src), T(tar), 4.0,
                                 None if pm is None else T(pm), scoring,
                                 df64=True)
    np.testing.assert_array_equal(to_np(it), np.asarray(ij))
    # Soft scores sum float32 residuals that differ by <= 1.8e-7 relative
    # (module docstring): measured <= 7.6e-6 absolute on scores ~40.
    np.testing.assert_allclose(to_np(st), np.asarray(sj), rtol=1e-6,
                               atol=5e-5)
    assert np.all(to_np(st)[:2] == (-np.inf if scoring == "lmeds" else -1.0))


def test_irls_refine_df64_matches_jax():
    h0, src, tar = _refine_inputs()
    hj = jax.jit(jax.vmap(lambda h: jr._irls_refine(
        h, src, tar, 2, 4.0, None, "inliers", df64=True)))(h0)
    ht = tr._irls_refine(T(h0), T(src), T(tar), 2, 4.0, None, "inliers",
                         df64=True)
    # The same weights from the same residuals, then float32 NDLT refits
    # (FMA-level differences, as in test_torch_ransac): measured 7.5e-8.
    np.testing.assert_allclose(fro(to_np(ht)), fro(hj), atol=1e-5)


def test_ransac_general_df64_scoring_matches_jax():
    n, b = 128, 256
    src, tar, h_true, _ = contaminated(5, n=n, outlier_frac=0.5, noise=0.5)
    key = jax.random.PRNGKey(0)
    idx = np.asarray(jr.sample_minimal_sets(key, n, b))
    # Solve, score and re-score in float64; the refinement and polish that
    # follow are held above and in test_torch_ransac.py.
    jcfg = jr.RansacConfig(num_hypotheses=b, threshold=4.0, df64_scoring=True,
                           refine_iters=0, final_polish=False)
    res_j = jr.ransac_homography(key, src, tar, jcfg)
    res_t = tr.ransac_homography(None, T(src), T(tar),
                                 ransac_config_from(dataclasses.asdict(jcfg)),
                                 indices=T(idx))
    np.testing.assert_array_equal(to_np(res_t.inlier_mask),
                                  np.asarray(res_j.inlier_mask))
    assert int(res_t.num_inliers) == int(res_j.num_inliers)
    # Measured 1.4e-7 after fro normalisation.
    np.testing.assert_allclose(fro(to_np(res_t.h)), fro(res_j.h), atol=1e-5)


def test_find_homography_float64_on_cpu_stays_float64():
    src, tar, h_true, inl = contaminated(13, n=200, outlier_frac=0.4)
    h, mask = sks_tpu_torch.find_homography(T(src).double(), T(tar).double(),
                                            solver="sks", max_iters=256)
    assert h.dtype == torch.float64
    c = np.array([[0.0, 0.0], [640.0, 0.0], [640.0, 480.0], [0.0, 480.0]])

    def warp(m):
        p = c @ m[:2, :2].T + m[:2, 2]
        return p / (c @ m[2, :2] + m[2, 2])[:, None]

    assert np.abs(warp(to_np(h)) - warp(h_true)).max() < 1.0
    assert np.mean(to_np(mask) == inl) >= 0.95
