"""Port parity, the sharded VO entry points (``slam.pipeline.
sharded_frames_to_poses``, ``sharded_planar_slam``), on gloo ranks on the
CPU.

One group of world size 2 and one of 4 run the ``pipeline`` suite of
``tests/torch_ranks.py`` at once, on the 9-frame closed circuit at
(120, 160) of ``tests/test_pipeline.py`` (strides (2, 3): 8 consecutive
pairs and 13 closures, padded to 22 and 24 items), rendered by the JAX
package.  While they run, this process computes the references.

* Each sharded form equals the port's single-device form on the same
  draws: equal inlier counts and poses within 1e-5 (a rank's fits are the
  single form's own per-pair fits, each pair drawing from the stream of its
  global index): ``sharded_frames_to_poses`` fused (one K2 launch a rank,
  its plain version here) and general from seed 5, and
  ``sharded_planar_slam`` (its default ESM polish, 8 iterations) on the
  JAX package's draws, injected through ``indices=``.
* ``sharded_planar_slam`` also stands against the JAX package's own
  sharded form on its 8-device mesh, from the same pixels and draws: inlier
  counts within 2 and poses within 5e-3, the bound
  ``tests/test_torch_pipeline.py`` allows the two feature pipelines.  JAX's
  sharded ``frames_to_poses`` test is ``slow``, so that form is held to the
  port's single form only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_np
from torch_ranks import launch

import sks_tpu.robust.ransac as jr
import sks_tpu.slam.pipeline as jpipe
from sks_tpu.data.images import planar_sequence as jplanar_sequence
from sks_tpu.parallel import make_mesh as jmake_mesh
from sks_tpu.utils.rng import CLOSURE_STREAM_OFFSET, fold_in_stream

import sks_tpu_torch
from sks_tpu_torch.slam.odometry import closure_candidates
from sks_tpu_torch.utils.convert import ransac_config_from

T = torch.from_numpy
KEY = jax.random.PRNGKey(0)
WORLDS = (2, 4)
FRAMES, SHAPE, CORNERS, STRIDES = 9, (120, 160), 192, (2, 3)
JCFG = jr.RansacConfig(num_hypotheses=512, refine_iters=2)


def _cfg(**kw):
    return dataclasses.replace(ransac_config_from(dataclasses.asdict(JCFG)),
                               **kw)


def _jax_draws(masks, offset):
    keys = fold_in_stream(KEY, masks.shape[0], offset=offset)
    n = masks.shape[-1]
    draw = jax.jit(jax.vmap(lambda k, m: jr._sample_chunk(k, n, JCFG, None,
                                                          m)))
    return np.asarray(draw(keys, jnp.asarray(masks)))


@pytest.fixture(scope="module")
def problem():
    """The JAX-rendered circuit and the JAX package's draws of every pair
    (consecutive first, then the closures; from its own matches)."""
    frames, _, k_mat = (np.array(x) for x in jplanar_sequence(
        KEY, FRAMES, SHAPE, loop=True))
    consec = [(i, i + 1) for i in range(FRAMES - 1)]
    pairs = jnp.asarray(consec + closure_candidates(FRAMES, STRIDES))
    match = jax.jit(lambda f, i1, i2: jpipe._match_pairs_cached(
        f, i1, i2, CORNERS, 2))
    masks = np.asarray(match(frames, pairs[:, 0], pairs[:, 1])[2])
    nc = FRAMES - 1
    draws = np.concatenate([_jax_draws(masks[:nc], 0),
                            _jax_draws(masks[nc:], CLOSURE_STREAM_OFFSET)])
    return {"frames": frames, "k_mat": k_mat, "draws": draws,
            "num_hypotheses": np.array(JCFG.num_hypotheses),
            "num_corners": np.array(CORNERS), "strides": np.array(STRIDES)}


@pytest.fixture(scope="module")
def launched(problem, tmp_path_factory):
    return {w: launch("pipeline", w, problem,
                      tmp_path_factory.mktemp(f"pipeline{w}"))
            for w in WORLDS}


@pytest.fixture(scope="module")
def refs(problem, launched):
    """The port's single-device forms and JAX's sharded planar_slam,
    computed while the ranks run."""
    frames, k_mat = T(problem["frames"]), T(problem["k_mat"])
    out = {}
    for route, fused in (("fused", True), ("general", False)):
        out[f"f2p_{route}"] = sks_tpu_torch.frames_to_poses(
            5, frames, k_mat, _cfg(fused=fused), num_corners=CORNERS)
    out["slam"] = sks_tpu_torch.planar_slam(
        None, frames, k_mat, _cfg(), num_corners=CORNERS, strides=STRIDES,
        indices=T(problem["draws"]))
    out["jax_slam"] = {k: np.asarray(v) for k, v in jpipe.sharded_planar_slam(
        jmake_mesh({"pair": 8}), KEY, problem["frames"], problem["k_mat"],
        JCFG, num_corners=CORNERS, strides=STRIDES).items()}
    return out


@pytest.fixture(scope="module")
def ranks(launched, refs):
    return {w: g.wait() for w, g in launched.items()}


def _ranks_of(ranks, prefix):
    """(world, rank, {key: value}) of the outputs named ``prefix_*``; the
    ranks agree bit for bit (the outputs are replicated)."""
    for w, outs in ranks.items():
        for r, out in enumerate(outs):
            got = {k[len(prefix) + 1:]: v for k, v in out.items()
                   if k.startswith(prefix + "_")}
            for k, v in got.items():
                np.testing.assert_array_equal(
                    v, outs[0][f"{prefix}_{k}"],
                    err_msg=f"{prefix}_{k} world {w} rank {r}")
            yield w, r, got


def _same_fits(got, want):
    assert set(got) == set(want)
    for name in ("num_inliers", "closure_inliers"):
        if name in want:
            np.testing.assert_array_equal(got[name], to_np(want[name]))
    np.testing.assert_allclose(got["poses"], to_np(want["poses"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["rel"], to_np(want["rel"]), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("route", ["fused", "general"])
def test_sharded_frames_to_poses_matches_single_device(ranks, refs, route):
    for w, r, got in _ranks_of(ranks, f"f2p_{route}"):
        _same_fits(got, refs[f"f2p_{route}"])


def test_sharded_planar_slam_matches_single_device(ranks, refs):
    for w, r, got in _ranks_of(ranks, "slam"):
        _same_fits(got, refs["slam"])
        assert got["closure_inliers"].shape == (13,)


def test_sharded_planar_slam_matches_jax_sharded_from_pixels(ranks, refs):
    want = refs["jax_slam"]
    assert bool(np.isfinite(want["poses"]).all())
    for w, r, got in _ranks_of(ranks, "slam"):
        np.testing.assert_allclose(got["poses"], want["poses"], atol=5e-3)
        for name in ("num_inliers", "closure_inliers"):
            gap = np.abs(got[name].astype(np.int64)
                         - want[name].astype(np.int64))
            assert gap.max() <= 2, (name, gap)
