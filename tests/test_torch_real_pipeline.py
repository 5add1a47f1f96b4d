"""Port parity, ``bench/real_pipeline.py``: pixels to a scored answer.

The JAX side's renders and draws go through the port's seam (``images=`` /
``frames=`` and ``indices=``), and the JAX functions are given the port's
matches of the same pixels (their matcher patched), so both sides fit the
same matches with the same minimal sets; the front ends' own parity is
``tests/test_torch_features.py``'s.  Tolerances:

* ``pair_parity`` on one JAX-rendered pair at (240, 320), 128 corners on 3
  levels (the renderer's focal length is the (480, 640) one, so at
  (120, 160) the views barely overlap: 3-6 matches): equal match and inlier counts under both rules and equal cv2
  columns (cv2 fits the same matches); the ground-truth corner error within
  0.02 px of JAX's: float32 fits with XLA's contracted multiply-adds on one
  side only (ROADMAP Queue C).  At this size the corner errors are 3.6 px
  (easy, 51 matches) and 220 px (hard, 19 matches: both fits fail alike);
  measured gaps 8.5e-5 and 1.8e-3 px.
* ``sequence_ate`` on JAX's 6-frame sweep at (240, 320): equal mean inlier
  counts, the path length within 1e-6 (JAX sums it in float32) and the ATE
  within 1e-5: an ATE of 0.0182 on a 0.932 path, measured gap 2.4e-7 (the
  float32 fits' contraction, as above, carried through the chained poses).
* ``loop_closure_ate``, the counterpart of ``tests/test_odometry.py``'s
  slow loop-closure test at its 12 frames and strides (4, 6), on the port's
  own render: smoothing with closures under 0.95 x the odometry's ATE.
* ``_summarize`` and ``pair_parity`` without cv2: its columns None, the
  ground-truth corner error present.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_np

import sks_tpu.bench.real_pipeline as jrp
import sks_tpu.data.images as ji
import sks_tpu.robust.ransac as jr
from sks_tpu.utils.rng import fold_in_stream

import sks_tpu_torch.bench.real_pipeline as trp
import sks_tpu_torch.features.matching as tm
from sks_tpu_torch.slam.pipeline import _match_pairs_cached

T = torch.from_numpy
PAIR_SHAPE, PAIR_CORNERS = (240, 320), 128


def _port_pair_matches(img1, img2):
    """The port's matches of two JAX images, as the JAX matcher returns."""
    out = tm.match_frames_oriented(T(np.array(img1)), T(np.array(img2)),
                                   PAIR_CORNERS, 3)
    return tuple(jnp.asarray(to_np(x)) for x in out)


@pytest.mark.parametrize("protocol", ["easy", "hard"])
def test_pair_parity_row_matches_jax(monkeypatch, protocol):
    monkeypatch.setattr(jrp, "match_frames_oriented",
                        lambda a, b, *args: _port_pair_matches(a, b))
    want = jrp.pair_parity(0, 1, shape=PAIR_SHAPE, protocol=protocol)[0]
    # What JAX rendered and drew for pair 0.
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    kw = jrp._HARD_KW if protocol == "hard" else {}
    views = tuple(np.array(x) for x in ji.planar_pair(key, PAIR_SHAPE, **kw))
    valid = _port_pair_matches(*views[:2])[2]
    cfg = jr.RansacConfig(num_hypotheses=2048, threshold=3.0)
    idx = np.array(jr._sample_chunk(jax.random.fold_in(key, 99),
                                    PAIR_CORNERS, cfg, None, valid))
    got = trp.pair_parity(0, 1, shape=PAIR_SHAPE, protocol=protocol,
                          device="cpu", num_corners=PAIR_CORNERS,
                          images=[views], indices=[idx])[0]
    assert "skipped" not in got and got["matches"] >= 15, got
    for k in ("matches", "inliers_ours", "inliers_ours_native_symmetric",
              "inliers_cv2", "inliers_cv2_native", "inlier_agreement",
              "inlier_jaccard"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["corner_err_cv2_px"] == pytest.approx(want["corner_err_cv2_px"],
                                                     abs=1e-5)
    assert abs(got["corner_err_ours_px"] - want["corner_err_ours_px"]) < 0.02


def test_sequence_ate_matches_jax_on_its_frames(monkeypatch):
    frames_n = 6
    key = jax.random.PRNGKey(0)
    seq = tuple(np.array(x) for x in ji.planar_sequence(key, frames_n,
                                                        (240, 320)))
    frames = T(seq[0])
    pairs = torch.arange(frames_n - 1)
    p1, p2, m = (to_np(x) for x in _match_pairs_cached(
        frames, pairs, pairs + 1, 384, 2))
    calls = []

    def port_matches(a, b, *args):
        i = len(calls)
        calls.append(i)
        return jnp.asarray(p1[i]), jnp.asarray(p2[i]), jnp.asarray(m[i]), None

    monkeypatch.setattr(jrp, "match_frames_oriented", port_matches)
    want = jrp.sequence_ate(0, frames_n)
    assert len(calls) == frames_n - 1
    # The JAX package's draws: pair i from fold_in(fold_in(key, 7), i).
    cfg = jr.RansacConfig(num_hypotheses=2048, threshold=2.0, refine_iters=3)
    keys = fold_in_stream(jax.random.fold_in(key, 7), frames_n - 1)
    draw = jax.jit(jax.vmap(lambda k, mm: jr._sample_chunk(k, 384, cfg, None,
                                                           mm)))
    idx = np.array(draw(keys, jnp.asarray(m)))
    got = trp.sequence_ate(0, frames_n, device="cpu", frames=seq,
                           indices=idx)
    assert got["frames"] == want["frames"] == frames_n
    assert got["mean_inliers"] == want["mean_inliers"]
    assert got["path_length"] == pytest.approx(want["path_length"], abs=1e-6)
    assert abs(got["ate_rmse"] - want["ate_rmse"]) < 1e-5, (got, want)
    assert got["ate_rmse"] < 0.12 * got["path_length"] + 0.02


def test_loop_closures_reduce_ate():
    out = trp.loop_closure_ate(0, num_frames=12, strides=(4, 6),
                               device="cpu")
    assert out["closure_edges"] == 8 + 6
    assert np.isfinite(out["ate_smooth_with_closures"])
    assert out["ate_smooth_with_closures"] < 0.95 * out["ate_odometry"], out


def test_without_cv2_its_columns_are_none(monkeypatch):
    monkeypatch.setattr(trp, "_cv2", lambda: None)
    rows = trp.pair_parity(3, 1, shape=PAIR_SHAPE, device="cpu",
                           num_corners=PAIR_CORNERS, protocol="parallax")
    row = rows[0]
    for k in trp._CV2_COLUMNS + ("offplane_inlier_leak_cv2",):
        assert row[k] is None, k
    assert row["corner_err_ours_px"] >= 0.0 and row["inliers_ours"] > 0
    assert 0.0 <= row["offplane_match_frac"] <= 1.0
    summary = trp._summarize(rows + [{"pair": 1, "matches": 3,
                                      "skipped": "too few matches"}])
    assert summary["n"] == 1
    assert summary["mean_corner_err_ours_px"] == row["corner_err_ours_px"]
    for k in ("mean_inlier_agreement", "mean_inlier_jaccard",
              "mean_corner_err_cv2_px", "max_corner_err_ratio_vs_cv2"):
        assert summary[k] is None, k
