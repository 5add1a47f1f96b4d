"""Port parity, ``bench/wall_real.py`` on the synthetic wall fixture
(2,000 matches, a known ``GT_H``, 15% outliers; the reference's real file is
not in the repository).

``solver_accuracy`` against the JAX package's solvers on the same 4,096
resampled quads (``resample_quads`` seed 11).  float32: the residual of an
exact quad is rounding error, and XLA on the CPU contracts multiply-adds
where the port does not (ROADMAP Queue C), so the statistics are held to
what float32 can promise: per solver, the median within 2x of JAX's and
under 1e-3 px on both sides (measured ratios 1.06-1.8), the 99th percentile
under 3 px on both (JAX's RHO-GE reads 2.19, the port's 0.43), and the
finite fractions within 0.25% (10 of 4,096 sets; 3 at most measured) and
at least 0.99.  float64: the port's native float64 solves and JAX's float64
solvers both under 1e-9 px at the median (both read ~1e-13) and finite on at
least 0.99 of the sets.  The JAX package's own ``solver_accuracy`` is not
called: its double-float twins take many minutes to compile on the CPU.

``robust_parity`` on the JAX package's draws (``indices=``, replayed from
``PRNGKey(0)``): equal inlier counts under both rules, equal cv2 columns
where cv2 imports, and the corner-transfer disagreement within 1e-3 px of
JAX's (measured 8e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sks_tpu.bench.wall_real as jwr
import sks_tpu.robust.ransac as jr
from sks_tpu.ops import SOLVERS as JSOLVERS

import sks_tpu_torch.bench.wall_real as twr
from sks_tpu_torch.data.fixture import load_correspondences
from sks_tpu_torch.data.wall import resample_quads


@pytest.fixture(scope="module")
def fixture():
    return load_correspondences()


@pytest.fixture(scope="module")
def port_accuracy(fixture):
    return twr.solver_accuracy(*fixture, device="cpu")


def _jax_residuals(fn, sq, tq, dtype):
    s, t = jnp.asarray(sq.astype(dtype)), jnp.asarray(tq.astype(dtype))
    r = np.array(jwr._quad_residual(jax.jit(fn)(s, t), s, t), np.float64)
    r[~np.isfinite(r)] = np.nan
    return r


@pytest.mark.parametrize("name", sorted(JSOLVERS))
def test_solver_accuracy_float32_as_jax(fixture, port_accuracy, name):
    sq, tq = resample_quads(*fixture, 4096, 11)
    r = _jax_residuals(JSOLVERS[name], sq, tq, np.float32)
    row = port_accuracy[name]
    med_j, med_t = np.nanmedian(r), row["f32_median_px"]
    assert max(med_j, med_t) < 1e-3 and 0.5 <= med_t / med_j <= 2.0, (
        med_t, med_j)
    assert max(np.nanpercentile(r, 99), row["f32_p99_px"]) < 3.0
    fin_j = float(np.mean(np.isfinite(r)))
    assert abs(row["finite_frac"] - fin_j) <= 10 / 4096, (row, fin_j)
    assert min(row["finite_frac"], fin_j) >= 0.99


@pytest.mark.parametrize("name", sorted(JSOLVERS))
def test_solver_accuracy_float64_is_exact_as_jax(fixture, port_accuracy,
                                                 name):
    sq, tq = resample_quads(*fixture, 4096, 11)
    r = _jax_residuals(JSOLVERS[name], sq, tq, np.float64)
    row = port_accuracy[name]
    assert np.nanmedian(r) < 1e-9 and row["f64_median_px"] < 1e-9, row
    assert row["f64_finite_frac"] >= 0.99
    assert float(np.mean(np.isfinite(r))) >= 0.99


def test_robust_parity_on_jax_draws(fixture):
    src, tar = fixture
    want = jwr.robust_parity(src, tar, threshold=3.0, seed=0)
    cfg = jr.RansacConfig(num_hypotheses=2048, threshold=3.0)
    idx = np.array(jr._sample_chunk(jax.random.PRNGKey(0), src.shape[0],
                                    cfg, None, None))
    got = twr.robust_parity(src, tar, threshold=3.0, device="cpu",
                            indices=idx)
    for key in ("matches", "inliers_ours", "inliers_ours_native_symmetric"):
        assert got[key] == want[key], key
    # The fixture's 1,700 true inliers, within 5%.
    assert abs(got["inliers_ours"] - 1700) <= 85
    if want.get("cv2") == "unavailable":
        assert got["cv2"] == "unavailable" and got["inliers_cv2"] is None
        return
    assert got["inliers_cv2"] == want["inliers_cv2"]
    assert got["inlier_jaccard"] == pytest.approx(want["inlier_jaccard"])
    assert abs(got["corner_transfer_disagreement_px"]
               - want["corner_transfer_disagreement_px"]) < 1e-3


def test_cv2_columns_are_none_without_cv2(fixture, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("cv2 hidden")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    src, tar = fixture
    got = twr.robust_parity(src[:400], tar[:400], device="cpu")
    assert got["cv2"] == "unavailable"
    assert got["inliers_cv2"] is None and got["inlier_jaccard"] is None
    assert got["inliers_ours"] > 300


def test_throughput_real_needs_a_card(fixture):
    assert twr.throughput_real(*fixture, batch=1024, device="cpu") is None


def test_main_skips_cleanly_without_the_real_file(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setenv("SKS_WALL_POINTS", str(tmp_path / "absent.txt"))
    assert twr.main([]) is None
    assert "skipping" in capsys.readouterr().out
