"""Port parity, the planar-VO pipeline: vo_trajectory, frames_to_poses and
planar_slam, from JAX-rendered pixels.

The JAX side runs jitted on the CPU backend (the fused route with its Pallas
kernel in interpret mode).  Parity goes through the draws: pair i of a batch
draws its minimal sets in the JAX package from ``fold_in(key, i)`` (closure e
from ``fold_in(key, 10_000 + e)``) through the mask-aware
``sks_tpu.robust.ransac._sample_chunk``; the tests replay that and hand the
indices to the port through ``indices=``.

Tolerances: on the same matches and draws, equal inlier counts, relative
poses within 1e-4 and chained poses within 1e-3 (float32, with XLA's
contracted multiply-adds on one side only).  The sequence is the lateral
sweep (``planar_sequence(loop=False)``): at this test size the closed
circuit's first pair keeps 9 inliers, and its refit amplifies the float32
differences to 6e-4 in the relative pose.
From pixels, where the two feature pipelines may flip a borderline match,
poses within 5e-3 and inlier counts within 2: the bound the JAX package
allows its sharded form (``tests/test_pipeline.py``).
The guarded ESM polish (``esm_iters > 0``) is held on matches drawn from the
true plane homography between two rendered frames (160 of them with 0.6 px
of noise: at test size the detected matches are too few for the guard to
ever take the polished model): equal inlier counts and poses within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_parity import to_np

import sks_tpu.robust.ransac as jr
import sks_tpu.slam.odometry as jodo
import sks_tpu.slam.pipeline as jpipe
from sks_tpu.data.images import planar_sequence as jplanar_sequence
from sks_tpu.utils.rng import CLOSURE_STREAM_OFFSET, fold_in_stream

import sks_tpu_torch
import sks_tpu_torch.robust.ransac as tr
from sks_tpu_torch.data.images import planar_sequence
from sks_tpu_torch.slam import odometry as todo
from sks_tpu_torch.slam.posegraph import ate_rmse
from sks_tpu_torch.utils.convert import ransac_config_from
from sks_tpu_torch.utils.streams import pair_generators

T = torch.from_numpy
KEY = jax.random.PRNGKey(0)
FRAMES, SHAPE, CORNERS, OCTAVES = 6, (96, 128), 64, 1
STRIDES = (2,)
JCFG = jr.RansacConfig(num_hypotheses=128, threshold=2.0, refine_iters=1)
KW = dict(num_corners=CORNERS, num_octaves=OCTAVES, plane_depth=3.0)


def _cfg(jcfg):
    return ransac_config_from(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def seq():
    """A JAX-rendered lateral sweep: (frames, poses_gt, k_mat) as numpy."""
    out = jplanar_sequence(KEY, FRAMES, SHAPE, focal=120.0)
    return tuple(np.array(x) for x in out)


def _pairs():
    """The pairs planar_slam fits: consecutive, then the closures."""
    consec = [(i, i + 1) for i in range(FRAMES - 1)]
    return np.asarray(consec + todo.closure_candidates(FRAMES, STRIDES))


@pytest.fixture(scope="module")
def jmatches(seq):
    """The JAX package's padded matches of every pair of ``_pairs()`` (the
    consecutive pairs first: as ``frames_to_poses`` matches them)."""
    pairs = jnp.asarray(_pairs())
    match = jax.jit(lambda f, i1, i2: jpipe._match_pairs_cached(
        f, i1, i2, CORNERS, OCTAVES))
    return tuple(np.array(x) for x in match(seq[0], pairs[:, 0],
                                             pairs[:, 1]))


def _jax_draws(masks, offset=0, cfg=JCFG):
    """(P, B, 4): the minimal sets the JAX package draws for P pairs."""
    keys = fold_in_stream(KEY, masks.shape[0], offset=offset)
    n = masks.shape[-1]
    draw = jax.jit(jax.vmap(lambda k, m: jr._sample_chunk(k, n, cfg, None,
                                                          m)))
    return np.asarray(draw(keys, jnp.asarray(masks)))


@pytest.fixture(scope="module")
def draws(jmatches):
    """JAX's draws of every pair: the consecutive stream, then the closures'."""
    m = jmatches[2]
    p = FRAMES - 1
    return np.concatenate([_jax_draws(m[:p]),
                           _jax_draws(m[p:], CLOSURE_STREAM_OFFSET)])


@pytest.mark.parametrize("route", ["general", "fused"])
def test_vo_trajectory_matches_jax_on_its_matches_and_draws(
        seq, jmatches, draws, route):
    k_mat, p = seq[2], FRAMES - 1
    p1, p2, m = (x[:p] for x in jmatches)
    jcfg = dataclasses.replace(JCFG, fused=route == "fused")
    with pltpu.force_tpu_interpret_mode():
        out_j = jodo.vo_trajectory(KEY, p1, p2, k_mat, jcfg, plane_depth=3.0,
                                   point_mask=m)
    out_t = todo.vo_trajectory(None, T(p1), T(p2), T(k_mat), _cfg(jcfg),
                               plane_depth=3.0, point_mask=T(m),
                               indices=T(draws[:p]))
    np.testing.assert_array_equal(to_np(out_t["num_inliers"]),
                                  np.asarray(out_j["num_inliers"]))
    np.testing.assert_allclose(to_np(out_t["rel"]), np.asarray(out_j["rel"]),
                               atol=1e-4)
    np.testing.assert_allclose(to_np(out_t["poses"]),
                               np.asarray(out_j["poses"]), atol=1e-3)


def test_frames_to_poses_matches_jax_from_pixels(seq, draws):
    frames, poses_gt, k_mat = seq
    out_j = jpipe.frames_to_poses(KEY, frames, k_mat, JCFG, **KW)
    out_t = sks_tpu_torch.frames_to_poses(
        None, T(frames), T(k_mat), _cfg(JCFG), **KW,
        indices=T(draws[:FRAMES - 1]))
    assert set(out_t) == set(out_j) == {"poses", "rel", "num_inliers"}
    np.testing.assert_allclose(to_np(out_t["poses"]),
                               np.asarray(out_j["poses"]), atol=5e-3)
    gap = np.abs(to_np(out_t["num_inliers"]).astype(np.int64)
                 - np.asarray(out_j["num_inliers"], np.int64))
    assert gap.max() <= 2, gap


def test_planar_slam_matches_jax_from_pixels(seq, draws):
    frames, poses_gt, k_mat = seq
    out_j = jpipe.planar_slam(KEY, frames, k_mat, JCFG, strides=STRIDES,
                              esm_iters=0, **KW)
    out_t = sks_tpu_torch.planar_slam(None, T(frames), T(k_mat), _cfg(JCFG),
                                      strides=STRIDES, esm_iters=0, **KW,
                                      indices=T(draws))
    assert set(out_t) == set(out_j) == {"poses", "rel", "num_inliers",
                                        "closure_inliers"}
    assert out_t["closure_inliers"].shape == out_j["closure_inliers"].shape
    np.testing.assert_allclose(to_np(out_t["poses"]),
                               np.asarray(out_j["poses"]), atol=5e-3)
    for name in ("num_inliers", "closure_inliers"):
        gap = np.abs(to_np(out_t[name]).astype(np.int64)
                     - np.asarray(out_j[name], np.int64))
        assert gap.max() <= 2, (name, gap)


@pytest.mark.parametrize("fused", [False, True])
def test_a_pairs_fit_in_its_batch_equals_its_fit_alone(seq, jmatches,
                                                        fused):
    """Each pair draws from its own stream: inside the batch (one K2 launch
    on the fused route) it is fitted as alone with its own generator."""
    k_mat = seq[2]
    p1, p2, m = (T(x) for x in jmatches)
    cfg = dataclasses.replace(_cfg(JCFG), fused=fused)
    normal = torch.tensor([0.0, 0.0, 1.0])
    r, t, n, ninl = todo.fit_pairs(pair_generators(7, p1.shape[0]), p1, p2,
                                   m, T(k_mat), cfg, normal)
    for i, g in enumerate(pair_generators(7, p1.shape[0])):
        r_i, t_i, n_i, ninl_i = todo.fit_pair(g, p1[i], p2[i], m[i],
                                              T(k_mat), cfg, normal)
        assert int(ninl_i) == int(ninl[i])
        torch.testing.assert_close(r_i, r[i], rtol=0, atol=1e-6)
        torch.testing.assert_close(t_i, t[i], rtol=0, atol=1e-6)
    # The batched draw with one generator per pair keeps those streams.
    results = tr.ransac_homography_fused_batch(
        pair_generators(7, 3), p1[:3], p2[:3], dataclasses.replace(
            cfg, fused=True), m[:3])
    alone = tr.ransac_homography_fused(pair_generators(7, 3)[2], p1[2], p2[2],
                                       cfg, m[2])
    assert torch.equal(results[2].h, alone.h)
    assert torch.equal(results[2].inlier_mask, alone.inlier_mask)
    with pytest.raises(ValueError, match="2 generators for 3 pairs"):
        tr.ransac_homography_fused_batch(pair_generators(7, 2), p1[:3],
                                         p2[:3], cfg, m[:3])


def test_pair_generators_are_streams_of_the_seed():
    a = [torch.randint(0, 1 << 30, (4,), generator=g)
         for g in pair_generators(5, 3)]
    b = [torch.randint(0, 1 << 30, (4,), generator=g)
         for g in pair_generators(torch.Generator().manual_seed(5), 3)]
    c = [torch.randint(0, 1 << 30, (4,), generator=g)
         for g in pair_generators(5, 2, offset=1)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(a[1], c[0]) and torch.equal(a[2], c[1])
    assert not torch.equal(a[0], a[1])


def test_pipeline_recovers_a_rendered_trajectory():
    """The port alone from its own rendering, at the size and bound of the
    JAX package's ``tests/test_pipeline.py``."""
    frames, poses_gt, k_mat = planar_sequence(torch.Generator().manual_seed(3),
                                              9, (240, 320))
    cfg = tr.RansacConfig(num_hypotheses=1024, threshold=2.0, refine_iters=2)
    out = sks_tpu_torch.frames_to_poses(1, frames, k_mat, cfg,
                                        plane_depth=3.0)
    ate = float(ate_rmse(out["poses"], poses_gt))
    path = float(torch.linalg.norm(torch.diff(poses_gt[:, :3, 3], dim=0),
                                   dim=-1).sum())
    assert torch.isfinite(out["poses"]).all()
    assert ate < 0.12 * path + 0.02, (ate, path)
    # Fewer frames than the smallest stride: no closure pairs.
    few = sks_tpu_torch.planar_slam(1, frames[:3], k_mat, cfg, strides=(4,),
                                    plane_depth=3.0, esm_iters=0)
    assert few["closure_inliers"].shape == (0,)
    assert few["poses"].shape == (3, 4, 4)


@pytest.mark.parametrize("fused", [False, True])
def test_trace_split_reads_the_stage_ranges(seq, fused):
    """The stage split of ``bench/pipeline_fps.py`` comes from the path's own
    ``record_function`` ranges in one trace (host side here: no device)."""
    from torch.profiler import ProfilerActivity, profile

    from sks_tpu_torch.bench.pipeline_fps import STAGES, trace_split

    frames, _, k_mat = (T(x) for x in seq)
    cfg = dataclasses.replace(_cfg(JCFG), fused=fused)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sks_tpu_torch.frames_to_poses(0, frames[:2], k_mat, cfg, **KW)
    split = trace_split(prof.profiler.kineto_results.events())
    fit = (["ransac/draw", "ransac/k2", "ransac/tail"] if fused
           else ["ransac/general"])
    assert set(split["stages_host_ms"]) == {
        "vo/describe", "vo/match", "vo/pose", "vo/chain", *fit
    } <= set(STAGES)
    assert all(ms > 0 for ms in split["stages_host_ms"].values())
    assert split["device_kernels"] == 0 and split["stages_device_ms"] == {}
    assert split["idle_share"] is None


def test_trace_split_assigns_device_time_to_stages():
    """Device events of a made-up trace: a kernel goes to the stage of the
    operation that launched it, a kernel no operation launched (K2, through
    ``ctypes``) to the stage whose device-side copy holds it; those copies,
    and the device-side copy of any other host range (Adam's step), are not
    device work."""
    from sks_tpu_torch.bench.pipeline_fps import trace_split

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    class Evt:
        def __init__(self, name, start, end, device, cid=0, linked=0):
            self._v = (name, start, end, device, cid, linked)

        def name(self): return self._v[0]
        def start_ns(self): return self._v[1]
        def end_ns(self): return self._v[2]
        def device_type(self): return self._v[3]
        def correlation_id(self): return self._v[4]
        def linked_correlation_id(self): return self._v[5]

    ms = 1_000_000
    events = [
        Evt("vo/describe", 0, 10 * ms, cpu, cid=1),
        Evt("aten::conv", 2 * ms, 3 * ms, cpu, cid=2),
        Evt("cudaLaunchKernel", 2 * ms, 3 * ms, cpu, cid=2),
        Evt("ransac/k2", 20 * ms, 30 * ms, cpu, cid=3),
        Evt("vo/describe", 5 * ms, 14 * ms, cuda),
        Evt("conv_kernel", 5 * ms, 7 * ms, cuda, linked=2),
        Evt("ransac/k2", 31 * ms, 35 * ms, cuda),
        Evt("aca_solve_score_kernel", 31 * ms, 34 * ms, cuda, linked=99),
        Evt("sum_chunks_kernel", 34 * ms, 35 * ms, cuda, linked=99),
        Evt("memset", 36 * ms, 40 * ms, cuda),
        Evt("Optimizer.step#Adam.step", 36 * ms, 37 * ms, cpu, cid=4),
        Evt("Optimizer.step#Adam.step", 36 * ms, 40 * ms, cuda),
    ]
    split = trace_split(events)
    assert split["stages_host_ms"] == {"vo/describe": 10.0, "ransac/k2": 10.0}
    assert split["stages_device_ms"] == {"vo/describe": 2.0,
                                         "ransac/k2": 4.0, "other": 4.0}
    assert split["device_kernels"] == 4
    assert split["busy_ms"] == 10.0 and split["span_ms"] == 40.0
    assert split["idle_share"] == 0.75
    assert split["top_kernels_ms"] == [
        ("memset", 4.0), ("aca_solve_score_kernel", 3.0),
        ("conv_kernel", 2.0), ("sum_chunks_kernel", 1.0)]


def test_esm_polish_raises_until_it_is_ported(seq, jmatches):
    """The dense ESM polish is ported: every entry point that takes
    ``esm_iters`` runs it (``planar_slam`` by default, ``esm_iters=8``) and
    returns finite poses, where it used to raise ``NotImplementedError``."""
    frames, _, k_mat = (T(x) for x in seq)
    p1, p2, m = (T(x) for x in jmatches)
    cfg = _cfg(JCFG)
    normal = torch.tensor([0.0, 0.0, 1.0])
    p = FRAMES - 1
    r, t, _, ninl = todo.fit_pair(None, p1[0], p2[0], m[0], k_mat, cfg,
                                  normal, frames[0], frames[1], esm_iters=4)
    assert torch.isfinite(r).all() and torch.isfinite(t).all()
    assert int(ninl) >= 4
    outs = [
        todo.vo_trajectory(None, p1[:p], p2[:p], k_mat, cfg, frames=frames,
                           point_mask=m[:p], esm_iters=8),
        sks_tpu_torch.frames_to_poses(None, frames, k_mat, cfg, esm_iters=8,
                                      **KW),
        sks_tpu_torch.planar_slam(None, frames, k_mat, cfg, **KW),
    ]
    for out in outs:
        assert out["poses"].shape == (FRAMES, 4, 4)
        assert torch.isfinite(out["poses"]).all()


def _esm_matches(seq, i, n=160, noise=0.6):
    """Matches of frames i -> i+1 of ``seq`` drawn from the true plane
    homography with ``noise`` px: enough inliers for the guard to judge."""
    frames, poses, k_mat = (x.astype(np.float64) for x in seq)
    w2c_i, w2c_j = np.linalg.inv(poses[i]), np.linalg.inv(poses[i + 1])
    rel = w2c_j @ poses[i]  # cam_i -> cam_{i+1}
    n_i = w2c_i[:3, :3] @ [0.0, 0.0, 1.0]
    d_i = 3.0 + n_i @ w2c_i[:3, 3]
    h = k_mat @ (rel[:3, :3] + np.outer(rel[:3, 3], n_i) / d_i) @ \
        np.linalg.inv(k_mat)
    rng = np.random.default_rng(i)
    p1 = rng.uniform([8.0, 8.0], [120.0, 88.0], (n, 2))
    q = np.c_[p1, np.ones(n)] @ h.T
    p2 = q[:, :2] / q[:, 2:] + rng.normal(0.0, noise, (n, 2))
    return p1.astype(np.float32), p2.astype(np.float32), np.ones(n, bool)


@pytest.mark.parametrize("pair", [1, 2])
def test_fit_pair_with_esm_matches_jax(seq, pair):
    """``fit_pair(esm_iters=8)`` on the JAX package's draws (``indices=``):
    the same inlier count and pose (1e-4).  On pair 1 the guard keeps the
    RANSAC model, on pair 2 it takes the polished one (the JAX side's pose
    moves)."""
    frames, _, k_mat = seq
    p1, p2, m = _esm_matches(seq, pair)
    draws = np.asarray(jr._sample_chunk(KEY, p1.shape[0], JCFG, None,
                                        jnp.asarray(m)))
    normal = np.array([0.0, 0.0, 1.0], np.float32)
    f1, f2 = frames[pair], frames[pair + 1]
    r_j, t_j, _, n_j = jodo.fit_pair(KEY, p1, p2, m, k_mat, JCFG, normal,
                                     f1, f2, 8)
    r_0 = jodo.fit_pair(KEY, p1, p2, m, k_mat, JCFG, normal)[0]
    r_t, t_t, _, n_t = todo.fit_pair(
        None, T(p1), T(p2), T(m), T(k_mat), _cfg(JCFG), T(normal), T(f1),
        T(f2), 8, indices=T(draws))
    assert int(n_t) == int(n_j)
    np.testing.assert_allclose(to_np(r_t), np.asarray(r_j), atol=1e-4)
    np.testing.assert_allclose(to_np(t_t), np.asarray(t_j), atol=1e-4)
    moved = np.abs(np.asarray(r_j) - np.asarray(r_0)).max()
    assert (moved > 1e-3) == (pair == 2), moved


def test_a_batch_of_esm_fits_equals_its_fits_alone(seq):
    """``fit_pairs`` polishes all pairs in one ESM batch; each pair's result
    is its ``fit_pair`` alone (inliers equal, poses within 1e-4: the CPU's
    batched products round otherwise than single ones)."""
    frames, _, k_mat = (T(x) for x in seq)
    m3 = [_esm_matches(seq, i) for i in range(3)]
    p1, p2, m = (T(np.stack(x)) for x in zip(*m3))
    cfg = _cfg(JCFG)
    normal = torch.tensor([0.0, 0.0, 1.0])
    r, t, _, ninl = todo.fit_pairs(pair_generators(4, 3), p1, p2, m, k_mat,
                                   cfg, normal, None, frames[:3],
                                   frames[1:4], esm_iters=8)
    for i, g in enumerate(pair_generators(4, 3)):
        r_i, t_i, _, n_i = todo.fit_pair(g, p1[i], p2[i], m[i], k_mat, cfg,
                                         normal, frames[i], frames[i + 1],
                                         esm_iters=8)
        assert int(n_i) == int(ninl[i])
        torch.testing.assert_close(r_i, r[i], rtol=0, atol=1e-4)
        torch.testing.assert_close(t_i, t[i], rtol=0, atol=1e-4)
