"""Port parity, robust fitting: ransac, polish, api and the whole slice.

The JAX side runs jitted on the CPU backend (the fused path in Pallas
interpret mode).  RANSAC parity goes through the ``indices=`` seam: the port
scores exactly the minimal sets that ``sks_tpu``'s own draw produces from the
same key.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_parity import apply_h, contaminated, fro, plane_h, to_np

import sks_tpu.robust.polish as jpolish
import sks_tpu.robust.ransac as jr
from sks_tpu.robust.api import find_homography as jfind

import sks_tpu_torch
import sks_tpu_torch.robust.polish as tpolish
import sks_tpu_torch.robust.ransac as tr
from sks_tpu_torch.utils.convert import ransac_config_from, result_to_numpy

T = torch.from_numpy


def test_config_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jr.RansacConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tr.RansacConfig)]
    assert tf == jf
    jcfg = jr.RansacConfig(num_hypotheses=384, threshold=2.5, scoring="msac",
                           lo_candidates=3, bf16_hypotheses=True)
    cfg = ransac_config_from(dataclasses.asdict(jcfg))
    assert cfg == tr.RansacConfig(num_hypotheses=384, threshold=2.5,
                                  scoring="msac", lo_candidates=3,
                                  bf16_hypotheses=True)
    assert ransac_config_from({}) == tr.RansacConfig()


def test_config_from_rejects_unknown_fields():
    with pytest.raises(ValueError, match="iterations"):
        ransac_config_from({"threshold": 3.0, "iterations": 10})


def test_magsac_weights_match_jax():
    r2 = np.concatenate([np.linspace(0.0, 200.0, 97), [np.inf, np.nan, -0.0]])
    r2 = r2.astype(np.float32)
    wj = np.asarray(jax.jit(lambda r: jr.magsac_weights(r, 3.0))(r2))
    wt = to_np(tr.magsac_weights(T(r2), 3.0))
    np.testing.assert_allclose(wt, wj, rtol=1e-6, atol=1e-7)
    assert wt[-3] == 0 and wt[-2] == 0 and wt[0] == 1


def test_minimal_set_draws():
    g = torch.Generator().manual_seed(0)
    idx = tr.sample_minimal_sets(g, 50, 300)
    assert idx.shape == (300, 4) and int(idx.min()) >= 0 and int(idx.max()) < 50
    mask = torch.zeros(50, dtype=torch.bool)
    mask[[3, 17, 41]] = True
    cfg = tr.RansacConfig(num_hypotheses=200)
    drawn = tr._sample_chunk(g, 50, cfg, point_mask=mask)
    assert drawn.shape == (200, 4)
    assert set(drawn.flatten().tolist()) == {3, 17, 41}


def _hyps(seed=0, b=64, n=96):
    """f32 hypotheses at unit Frobenius scale (their adjugate stays well in
    float32 range) and a contaminated point set, identical for both sides."""
    src, tar, _, _ = contaminated(seed, n=n, outlier_frac=0.4, noise=0.7)
    rng = np.random.default_rng(seed + 100)
    idx = rng.integers(0, n, (b, 4))
    from sks_tpu_torch.ops import aca_h

    h = to_np(aca_h(T(src[idx]).double(), T(tar[idx]).double()))
    h = fro(h).astype(np.float32)
    h[:2] = np.nan  # degenerate hypotheses score -1 / -inf
    mask = rng.uniform(size=n) > 0.15
    return h, src, tar, mask


def test_residual2_matches_jax():
    h, src, tar, _ = _hyps()
    rj = np.asarray(jax.jit(jr._residual2)(h[2:], src, tar))
    rt = to_np(tr._residual2(T(h[2:]), T(src), T(tar)))
    # float32 residuals differ at FMA level (XLA contracts, the port does
    # not).  Near-degenerate minimal sets amplify that: their reverse
    # transfer through the adjugate moves a residual by up to 0.2 px^2
    # (measured), and near a hypothesis' line at infinity without bound, so
    # compare in the range any threshold (< 100 px) can see.
    np.testing.assert_allclose(np.minimum(rt, 1e4), np.minimum(rj, 1e4),
                               rtol=1e-3, atol=0.25)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("scoring", ["inliers", "msac", "magsac", "lmeds"])
def test_score_hypotheses_matches_jax(scoring, masked):
    h, src, tar, mask = _hyps(seed=1)
    pm = mask if masked else None
    sj, ij = jax.jit(
        lambda h, s, t, m: jr.score_hypotheses(h, s, t, 4.0, m, scoring)
    )(h, src, tar, pm)
    st, it = tr.score_hypotheses(T(h), T(src), T(tar), 4.0,
                                 None if pm is None else T(pm), scoring)
    np.testing.assert_array_equal(to_np(it), np.asarray(ij))
    # Soft scores sum FMA-level residual differences (see
    # test_residual2_matches_jax) over every point: measured <= 4.5e-3.
    # LMedS medians of residuals up to 1e6 px^2: 2e-5 relative.
    tol = dict(rtol=1e-4, atol=0) if scoring == "lmeds" else \
        dict(rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(to_np(st), np.asarray(sj), **tol)
    assert np.all(to_np(st)[:2] == (-np.inf if scoring == "lmeds" else -1.0))


def _refine_inputs(seed=2, n=120):
    src, tar, h_true, _ = contaminated(seed, n=n, outlier_frac=0.3, noise=0.5)
    rng = np.random.default_rng(seed)
    h0 = np.stack([h_true @ (np.eye(3) + rng.normal(0, s, (3, 3)) * [1, 1, 0.002])
                   for s in (1e-3, 3e-3, 1e-2)])
    return fro(h0).astype(np.float32), src, tar


@pytest.mark.parametrize("scoring", ["inliers", "magsac"])
def test_irls_refine_matches_jax(scoring):
    h0, src, tar = _refine_inputs()
    hj = jax.jit(jax.vmap(lambda h: jr._irls_refine(
        h, src, tar, 2, 4.0, None, scoring)))(h0)
    ht = tr._irls_refine(T(h0), T(src), T(tar), 2, 4.0, None, scoring)
    np.testing.assert_allclose(fro(to_np(ht)), fro(hj), atol=1e-4)


def test_forward_normal_eqs_match_jax():
    h0, src, tar = _refine_inputs()
    w = (np.arange(src.shape[0]) % 3 != 0).astype(np.float32)
    hn = (h0[0] / h0[0, 2, 2]).astype(np.float32)
    sn = ((src - 320.0) / 200.0).astype(np.float32)
    tn = ((tar - 320.0) / 200.0).astype(np.float32)
    aj, gj, cj = jax.jit(jpolish._forward_normal_eqs)(hn, sn, tn, w)
    at, gt, ct = tpolish._forward_normal_eqs(T(hn), T(sn), T(tn), T(w))
    for a, b in ((at, aj), (gt, gj), (ct, cj)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_gn_refine_h_matches_jax():
    h0, src, tar = _refine_inputs(seed=3)
    _, _, _, inl = contaminated(3, n=120, outlier_frac=0.3, noise=0.5)
    w = inl.astype(np.float32)
    hj = jax.jit(jpolish.gn_refine_h)(h0[2], src, tar, w)
    ht = tpolish.gn_refine_h(T(h0[2]), T(src), T(tar), T(w))
    np.testing.assert_allclose(fro(to_np(ht)), fro(hj), atol=1e-4)


def test_anneal_polish_matches_jax():
    h0, src, tar = _refine_inputs(seed=4)
    mask = np.arange(src.shape[0]) < 110
    hj = jax.jit(lambda h, m: jpolish.anneal_polish(h, src, tar, 4.0, m))(
        h0[1], mask)
    ht = tpolish.anneal_polish(T(h0[1]), T(src), T(tar), 4.0, T(mask))
    np.testing.assert_allclose(fro(to_np(ht)), fro(hj), atol=1e-4)


# --- the whole fixed-batch fit, general and fused, on JAX's own draw --------

N, B = 128, 256
_JCFG = jr.RansacConfig(num_hypotheses=B, threshold=4.0)


@pytest.fixture(scope="module")
def fit_problem():
    src, tar, h_true, inl = contaminated(5, n=N, outlier_frac=0.5, noise=0.5)
    key = jax.random.PRNGKey(0)
    idx = np.asarray(jr.sample_minimal_sets(key, N, B))
    return key, src, tar, h_true, inl, idx


def _assert_same_fit(res_t, res_j):
    np.testing.assert_allclose(fro(to_np(res_t.h)), fro(res_j.h), atol=1e-4)
    agree = np.mean(to_np(res_t.inlier_mask) == np.asarray(res_j.inlier_mask))
    assert agree >= 0.995, agree
    assert abs(int(res_t.num_inliers) - int(res_j.num_inliers)) <= 1


@pytest.mark.parametrize("scoring", ["inliers", "msac", "magsac", "lmeds"])
def test_ransac_general_matches_jax(fit_problem, scoring):
    key, src, tar, _, _, idx = fit_problem
    jcfg = dataclasses.replace(_JCFG, scoring=scoring)
    res_j = jr.ransac_homography(key, src, tar, jcfg)
    res_t = tr.ransac_homography(None, T(src), T(tar),
                                 ransac_config_from(dataclasses.asdict(jcfg)),
                                 indices=T(idx))
    _assert_same_fit(res_t, res_j)
    assert res_t.num_inliers.dtype == torch.int32
    np.testing.assert_allclose(to_np(res_t.h)[2, 2], 1.0)


def test_ransac_fused_matches_jax(fit_problem):
    key, src, tar, _, _, idx = fit_problem
    with pltpu.force_tpu_interpret_mode():
        res_j = jr.ransac_homography_fused(key, src, tar, _JCFG)
    res_t = tr.ransac_homography_fused(None, T(src), T(tar),
                                       tr.RansacConfig(num_hypotheses=B,
                                                       threshold=4.0),
                                       indices=T(idx))
    _assert_same_fit(res_t, res_j)


def test_port_fused_equals_port_general(fit_problem):
    _, src, tar, _, _, idx = fit_problem
    cfg = tr.RansacConfig(num_hypotheses=B, threshold=4.0)
    res_g = tr.ransac_homography(None, T(src), T(tar), cfg, indices=T(idx))
    res_f = tr.ransac_homography(None, T(src), T(tar),
                                 dataclasses.replace(cfg, fused=True),
                                 indices=T(idx))
    np.testing.assert_allclose(fro(to_np(res_f.h)), fro(to_np(res_g.h)),
                               atol=1e-6)
    assert torch.equal(res_f.inlier_mask, res_g.inlier_mask)
    out = result_to_numpy(res_f)
    assert set(out) == {"h", "inlier_mask", "num_inliers", "score"}
    assert out["h"].shape == (3, 3) and out["inlier_mask"].dtype == bool


def _corner_err(h, h_true):
    c = np.array([[0.0, 0.0], [640.0, 0.0], [640.0, 480.0], [0.0, 480.0]])
    return float(np.mean(np.linalg.norm(apply_h(h, c) - apply_h(h_true, c),
                                        axis=-1)))


# 'lmeds' is held against JAX above, not against the truth: on some draws
# the reference's post-refine LMedS selection keeps a refit whose huge median
# makes every point a robust-sigma inlier (ROADMAP.md Queue C), and the port
# reproduces that exactly.
@pytest.mark.parametrize("method", ["ransac", "msac", "magsac", "fused"])
def test_find_homography_recovers_the_truth(method):
    src, tar, h_true, inl = contaminated(6, n=200, outlier_frac=0.4)
    h, mask = sks_tpu_torch.find_homography(T(src), T(tar), method=method,
                                            ransac_reproj_threshold=3.0,
                                            max_iters=512)
    assert h.shape == (3, 3) and mask.shape == (200,) and mask.dtype == torch.bool
    np.testing.assert_allclose(to_np(h)[2, 2], 1.0)
    assert _corner_err(to_np(h).astype(np.float64), h_true) < 1.0
    assert np.mean(to_np(mask) == inl) >= 0.95


@pytest.mark.parametrize("solver", ["aca", "sks", "rho_ge", "gpt_lu", "ho",
                                    "ndlt"])
def test_find_homography_fits_with_every_solver(solver):
    src, tar, h_true, inl = contaminated(12, n=200, outlier_frac=0.4)
    h, mask = sks_tpu_torch.find_homography(T(src), T(tar), solver=solver,
                                            max_iters=256)
    assert _corner_err(to_np(h).astype(np.float64), h_true) < 1.0
    assert np.mean(to_np(mask) == inl) >= 0.95


def test_find_homography_agrees_with_jax():
    """Independent draws on each side; both recover the same consensus."""
    src, tar, h_true, inl = contaminated(7, n=200, outlier_frac=0.5)
    hj, mj = jax.jit(lambda s, t: jfind(s, t, max_iters=256))(src, tar)
    ht, mt = sks_tpu_torch.find_homography(src, tar, max_iters=256)
    np.testing.assert_allclose(fro(to_np(ht)), fro(hj), atol=2e-3)
    assert np.mean(to_np(mt) == np.asarray(mj)) >= 0.98


def test_find_homography_batched_and_padded():
    pairs = [contaminated(s, n=100, outlier_frac=0.3) for s in (8, 9)]
    src = np.stack([p[0] for p in pairs])
    tar = np.stack([p[1] for p in pairs])
    pm = np.ones((2, 100), bool)
    pm[1, 80:] = False
    tar[1, 80:] = 9999.0  # padding: never scored, never drawn
    h, mask = sks_tpu_torch.find_homography(T(src), T(tar), max_iters=256,
                                            point_mask=T(pm))
    assert h.shape == (2, 3, 3) and mask.shape == (2, 100)
    assert not to_np(mask)[1, 80:].any()
    for i, p in enumerate(pairs):
        assert _corner_err(to_np(h[i]).astype(np.float64), p[2]) < 1.5


def test_paths_not_ported_yet_raise():
    src, tar, _, _ = contaminated(10, n=40)
    s, t = T(src), T(tar)
    with pytest.raises(NotImplementedError, match="adaptive"):
        sks_tpu_torch.find_homography(s, t, confidence=0.99)
    with pytest.raises(NotImplementedError, match="prosac"):
        sks_tpu_torch.find_homography(s, t, sampling="prosac")
    # df64_scoring fits now (native float64 scoring, ops/fp64.py).
    res = tr.ransac_homography(None, s, t, tr.RansacConfig(
        num_hypotheses=64, df64_scoring=True))
    assert res.h.shape == (3, 3) and torch.isfinite(res.h).all()
    assert res.inlier_mask.shape == (40,) and int(res.num_inliers) >= 4
    # 'sks' fits now (K3 and ops/sks.py are ported); an unknown name raises.
    h, mask = sks_tpu_torch.find_homography(s, t, solver="sks", max_iters=64)
    assert h.shape == (3, 3) and mask.shape == (40,)
    with pytest.raises(KeyError, match="unknown solver"):
        sks_tpu_torch.find_homography(s, t, solver="dlt")
    with pytest.raises(ValueError, match="multiple of 128"):
        tr.ransac_homography_fused(None, s, t, tr.RansacConfig(num_hypotheses=100))
    with pytest.raises(ValueError, match="indices"):
        tr.ransac_homography(None, s, t, tr.RansacConfig(num_hypotheses=8),
                             indices=torch.zeros((8, 3), dtype=torch.long))


# --- the other five solvers on the general path, on JAX's own draw ----------

@pytest.mark.parametrize("solver", ["sks", "rho_ge", "gpt_lu", "ho", "ndlt"])
def test_ransac_general_matches_jax_for_every_solver(fit_problem, solver):
    key, src, tar, _, _, idx = fit_problem
    # Solve and score only: the refinement and polish that follow do not
    # depend on the solver and are held above (each costs a JAX compile).
    jcfg = dataclasses.replace(_JCFG, solver=solver, refine_iters=0,
                               final_polish=False)
    res_j = jr.ransac_homography(key, src, tar, jcfg)
    res_t = tr.ransac_homography(None, T(src), T(tar),
                                 ransac_config_from(dataclasses.asdict(jcfg)),
                                 indices=T(idx))
    _assert_same_fit(res_t, res_j)


def _sks_degenerate_problem(n=48):
    """Half of the points lie on one line, so about one minimal set in eight
    puts M, N and P on it: P on the line MN is an SKS degeneracy, which only
    sks_valid_mask catches (the SKS H stays finite, huge and wrong)."""
    src, tar, _, _ = contaminated(11, n=n, outlier_frac=0.25)
    t = np.linspace(0.0, 1.0, n // 2)
    src[: n // 2] = np.stack([50.0 + 500.0 * t, 60.0 + 300.0 * t], -1)
    return src.astype(np.float32), tar


def test_general_path_masks_sks_degeneracies_as_jax():
    """The SKS mask in _eval_chunk: same minimal sets (the ``indices=``
    seam), same scores for every hypothesis, same masked set, same mask of
    the winner."""
    src, tar = _sks_degenerate_problem()
    b = 256
    key = jax.random.PRNGKey(3)
    idx = np.asarray(jr.sample_minimal_sets(key, src.shape[0], b))
    jcfg = jr.RansacConfig(num_hypotheses=b, threshold=4.0, solver="sks",
                           lo_candidates=b)
    _, sj, ij = jax.jit(lambda s, t: jr._eval_chunk(key, s, t, jcfg, None))(
        src, tar)
    _, st, it = tr._eval_chunk(None, T(src), T(tar),
                               ransac_config_from(dataclasses.asdict(jcfg)),
                               None, indices=T(idx))
    masked = ~to_np(sks_tpu_torch.ops.sks_valid_mask(T(src[idx]),
                                                     T(tar[idx])))
    h = to_np(sks_tpu_torch.sks_h(T(src[idx]), T(tar[idx])))
    # The mask does work here: degenerate sets whose SKS H is finite.
    assert (masked & np.isfinite(h).all(axis=(1, 2))).sum() >= 5
    st, sj = to_np(st), np.asarray(sj)
    n_t, n_j = np.sum(st == -1.0), np.sum(sj == -1.0)
    assert n_t >= masked.sum() >= 64
    # The rule's eps sits in the roundoff of P's canonical y for points on
    # the line, where XLA's FMA contraction can decide one set the other
    # way: measured 102 against 101 masked of 256.
    assert abs(int(n_t) - int(n_j)) <= 2, (n_t, n_j)
    # The hypotheses that RANSAC keeps score alike (an inlier at the
    # threshold may flip), and the winner's inliers are the same.
    np.testing.assert_allclose(st[:16], sj[:16], atol=1.0)
    np.testing.assert_array_equal(to_np(it), np.asarray(ij))
