"""Port parity, the correspondence fixture and the wall loader
(``data/fixture.py``, ``data/wall.py``): numpy on both sides, so equality is
exact: the fixture file byte for byte, the loaders' arrays and the
``resample_quads`` draws element for element."""

from pathlib import Path

import numpy as np
import pytest

import sks_tpu.data.fixture as jf
import sks_tpu.data.wall as jw

import sks_tpu_torch.data.fixture as tf
import sks_tpu_torch.data.wall as tw


def test_shipped_fixture_is_the_jax_packages_byte_for_byte():
    assert tf.DEFAULT_FIXTURE.read_bytes() == jf.DEFAULT_FIXTURE.read_bytes()
    np.testing.assert_array_equal(tf.GT_H, jf.GT_H)


def test_make_fixture_rewrites_the_shipped_file(tmp_path):
    path = tf.make_fixture(tmp_path / "w.txt")
    assert path.read_bytes() == tf.DEFAULT_FIXTURE.read_bytes()


@pytest.mark.parametrize("kw", [dict(n=50, seed=3), dict(
    n=40, noise=0.0, outlier_frac=0.5, seed=1)])
def test_make_fixture_matches_jax_at_other_settings(tmp_path, kw):
    a = tf.make_fixture(tmp_path / "t.txt", **kw)
    b = jf.make_fixture(tmp_path / "j.txt", **kw)
    assert a.read_bytes() == b.read_bytes()


def test_loader_matches_jax_and_the_truth():
    src, tar = tf.load_correspondences()
    js, jt = jf.load_correspondences()
    np.testing.assert_array_equal(src, js)
    np.testing.assert_array_equal(tar, jt)
    assert src.shape == tar.shape == (2000, 2) and src.dtype == np.float64
    # 85% of the targets are GT_H's images of their sources plus 0.6 px of
    # noise; the other 15% are uniform outliers.
    p = np.concatenate([src, np.ones((2000, 1))], 1) @ tf.GT_H.T
    err = np.linalg.norm(p[:, :2] / p[:, 2:] - tar, axis=1)
    assert 1650 <= int((err < 3.0).sum()) <= 1720


@pytest.mark.parametrize("batch,seed", [(64, 11), (1000, 3)])
def test_resample_quads_draws_as_jax(batch, seed):
    src, tar = tf.load_correspondences()
    a = tw.resample_quads(src, tar, batch, seed)
    b = jw.resample_quads(src, tar, batch, seed)
    for x, y in zip(a, b):
        assert x.shape == (batch, 4, 2)
        np.testing.assert_array_equal(x, y)


def test_wall_path_environment_rule(tmp_path, monkeypatch):
    real = tmp_path / "orig_pts_wall.txt"
    tf.make_fixture(real, n=30)
    monkeypatch.setenv("SKS_WALL_POINTS", str(real))
    assert tw.wall_path() == jw.wall_path() == real
    src, tar = tw.load_wall()
    np.testing.assert_array_equal(src, jw.load_wall()[0])
    assert src.shape == tar.shape == (30, 2)
    # A variable that names a missing file is the answer: no fallback.
    monkeypatch.setenv("SKS_WALL_POINTS", str(tmp_path / "absent.txt"))
    assert tw.wall_path() is None and tw.load_wall() is None
    assert jw.wall_path() is None
    # Unset: the file inside the package, and nothing outside it.
    monkeypatch.delenv("SKS_WALL_POINTS")
    assert tw.DEFAULT_WALL.parent == Path(tf.__file__).resolve().parent
    assert tw.wall_path() == (tw.DEFAULT_WALL if tw.DEFAULT_WALL.exists()
                              else None)
    monkeypatch.setattr(tw, "DEFAULT_WALL", real)
    assert tw.wall_path() == real
    monkeypatch.setattr(tw, "DEFAULT_WALL", tmp_path / "absent.txt")
    assert tw.wall_path() is None and tw.load_wall() is None
