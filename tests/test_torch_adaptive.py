"""Port parity, the confidence early-exit loop and PROSAC.

``sks_tpu.robust.ransac.ransac_homography_adaptive`` splits its key once a
chunk and draws that chunk's minimal sets from the sub-key.  The tests replay
that chain outside the jit, for the whole schedule, and hand the draws to the
port through ``indices=``: both packages then score the same hypotheses chunk
for chunk, and must stop after the same chunk.  The JAX side runs jitted on
the CPU backend, its fused stages in Pallas interpret mode; its chunks are
counted by a ``jax.debug.callback`` wrapped around its ``_eval_chunk``.

Stopping alike needs ``done`` clear of ``needed``: both are float32 in both
packages, but ``log1p`` may differ by an ulp between XLA and PyTorch.  Every
parity problem here keeps them at least 1% apart at every chunk, and
:func:`_assert_margins` holds the problems to that.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_parity import apply_h, contaminated, fro, to_np

import sks_tpu.robust.ransac as jr

import sks_tpu_torch
import sks_tpu_torch.robust.ransac as tr
from sks_tpu_torch.utils.convert import ransac_config_from

T = torch.from_numpy

N = 128
CHUNK = 128
#: The fused gate of both packages in these tests: the second stage's size,
#: so a fused fit runs an eager stage and then fused ones, and their top-K
#: merge.  (The packages' own constants are measurements of their devices.)
GATE = 512


# --- the schedule and the samplers -------------------------------------------

@pytest.mark.parametrize("n,b", [(4, 16), (5, 64), (50, 300), (200, 1024),
                                 (2000, 4096), (128, 3328)])
def test_prosac_prefix_sizes_equal_jax(n, b):
    want = jr.prosac_prefix_sizes(n, b)
    got = tr.prosac_prefix_sizes(n, b)
    assert got.dtype == np.int32 and got.shape == (b,)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 4 and got.max() <= n and (np.diff(got) >= 0).all()


@pytest.mark.parametrize("args", [
    (256, 16, 1, 2, 4096), (256, 64, 4, 2, 131072), (256, 4096, 4, 2, 4096),
    (512, 8, 4, 2, 256), (128, 16, 4, 2, 131072), (128, 4, 4, 2, 131072),
    (256, 1, 4, 2, 131072), (100, 7, 2, 3, 1000), (256, 8192, 4, 2, 131072),
    (128, 16, 4, 1, 512),
])
def test_chunk_schedule_equals_jax(args):
    got = tr._chunk_schedule(*args)
    assert got == jr._chunk_schedule(*args)
    assert sum(c * k for c, k in got) >= args[0] * args[1]


def test_schedule_constants():
    assert tr.ADAPTIVE_MAX_CHUNK == jr.ADAPTIVE_MAX_CHUNK == 131072
    # The fused gate is the port's own measurement: a fused stage needs a
    # multiple of 128.
    assert tr.FUSED_ADAPTIVE_MIN_CHUNK % 128 == 0
    assert tr.FUSED_ADAPTIVE_MIN_CHUNK >= 128


@pytest.mark.parametrize("n,b", [(100, 512), (7, 64), (2000, 1024)])
def test_prosac_sampler_equals_jax_given_its_uniforms(n, b):
    """The index arithmetic (the floors, the shifted distinct picks, the last
    column ``sizes - 1``) on the JAX package's own uniforms: equal index for
    index."""
    key = jax.random.PRNGKey(n)
    want = np.asarray(jr.sample_minimal_sets_prosac(key, n, b))
    u = np.array(jax.random.uniform(key, (b, 3)))  # a writable copy
    got = tr.sample_minimal_sets_prosac(None, n, b, u=T(u))
    assert got.shape == (b, 4) and got.dtype == torch.long
    np.testing.assert_array_equal(to_np(got), want)
    # A schedule slice, as the adaptive loop hands over.
    sizes = jr.prosac_prefix_sizes(n, 4 * b)[b:2 * b]
    want = np.asarray(jr.sample_minimal_sets_prosac(key, n, b,
                                                    jnp.asarray(sizes)))
    got = tr.sample_minimal_sets_prosac(None, n, b, T(sizes), u=T(u))
    np.testing.assert_array_equal(to_np(got), want)


def test_prosac_sampler_draws_distinct_indices_inside_the_prefix():
    n, b = 100, 512
    g = torch.Generator().manual_seed(3)
    idx = to_np(tr.sample_minimal_sets_prosac(g, n, b))
    sizes = tr.prosac_prefix_sizes(n, b)
    assert idx.shape == (b, 4)
    assert (idx >= 0).all() and (idx < sizes[:, None]).all()
    np.testing.assert_array_equal(idx[:, 3], sizes - 1)
    assert all(len(set(row.tolist())) == 4 for row in idx)
    # The generator moves on: a second draw differs.
    again = to_np(tr.sample_minimal_sets_prosac(g, n, b))
    assert (again[:, :3] != idx[:, :3]).any()


def test_sample_chunk_routes_prosac_and_rejects_unknown_sampling():
    g = torch.Generator().manual_seed(0)
    cfg = tr.RansacConfig(num_hypotheses=64, sampling="prosac")
    sizes = torch.full((64,), 9)
    idx = tr._sample_chunk(g, 50, cfg, prosac_sizes=sizes)
    assert idx.shape == (64, 4) and int(idx[:, :3].max()) < 8
    assert (idx[:, 3] == 8).all()
    with pytest.raises(ValueError, match="unknown sampling"):
        tr._sample_chunk(g, 50, dataclasses.replace(cfg, sampling="napsac"))


# --- the loop on the JAX package's own draws ----------------------------------

@pytest.fixture(scope="module")
def jax_fit():
    """The module's one jit of the JAX adaptive loop, its chunk counter, and
    the counting ``_eval_chunk`` that tests patch in while they call it.

    The jit is of a new function object: jax keys its traces on the function,
    so a trace made by the package's own jit (or another module) would count
    into another counter, or not at all.  Made once for the module, its
    compiles are shared by the tests whose static configuration and shapes
    agree; every call resets the one counter that every trace bumps.
    """
    count = [0]
    real = jr._eval_chunk

    def counted(*args, **kwargs):
        jax.debug.callback(lambda: count.__setitem__(0, count[0] + 1))
        return real(*args, **kwargs)

    def fresh(*args, **kwargs):
        return jr.ransac_homography_adaptive.__wrapped__(*args, **kwargs)

    return (jax.jit(fresh, static_argnames=("config", "max_chunks")), count,
            counted)


@pytest.fixture(scope="module")
def draw_fns():
    """Jitted ``_sample_chunk`` per (points, sampling, chunk size), shared by
    the module's replays."""
    return {}


def _jax_adaptive(monkeypatch, jax_fit, key, src, tar, jcfg, confidence,
                  max_chunks, point_mask=None):
    """The JAX fit and the number of chunks it evaluated."""
    fit, count, counted = jax_fit
    monkeypatch.setattr(jr, "_eval_chunk", counted)
    monkeypatch.setattr(jr, "FUSED_ADAPTIVE_MIN_CHUNK", GATE)
    count[0] = 0
    with pltpu.force_tpu_interpret_mode():
        res = fit(key, src, tar, config=jcfg, confidence=confidence,
                  max_chunks=max_chunks, point_mask=point_mask)
        jax.block_until_ready(res)
    jax.effects_barrier()
    return res, count[0]


def _replay_draws(draw_fns, key, n, jcfg, max_chunks, point_mask=None):
    """(total_budget, 4): the minimal sets of every chunk of the schedule, as
    the JAX loop draws them (one key split a chunk, PROSAC on one global
    schedule sliced at the running offset)."""
    stages = jr._chunk_schedule(jcfg.num_hypotheses, max_chunks, 4, 2,
                                jr.ADAPTIVE_MAX_CHUNK)
    total = sum(c * k for c, k in stages)
    all_sizes = (jnp.asarray(jr.prosac_prefix_sizes(n, total))
                 if jcfg.sampling == "prosac" else None)
    pm = None if point_mask is None else jnp.asarray(point_mask)
    out, done, k = [], 0, key
    for c_s, n_s in stages:
        # _sample_chunk reads only the sampling and the chunk size.
        draw_key = (n, jcfg.sampling, c_s)
        if draw_key not in draw_fns:
            cfg_s = jr.RansacConfig(num_hypotheses=c_s,
                                    sampling=jcfg.sampling)
            draw_fns[draw_key] = jax.jit(
                lambda sub, sizes, mask, cfg_s=cfg_s: jr._sample_chunk(
                    sub, n, cfg_s, sizes, mask))
        for _ in range(n_s):
            k, sub = jax.random.split(k)
            sizes = None if all_sizes is None else all_sizes[done:done + c_s]
            out.append(np.asarray(draw_fns[draw_key](sub, sizes, pm)))
            done += c_s
    return np.concatenate(out), [c for c, k in stages for _ in range(k)]


def _port_adaptive(monkeypatch, src, tar, jcfg, confidence, max_chunks, idx,
                   point_mask=None):
    """The port's fit on ``idx``; per evaluated chunk its size, whether it
    ran fused and its champion's inlier count; and the host reads."""
    chunks, reads = [], [0]
    real_eval, real_read = tr._eval_chunk, tr._read_flag

    def eval_chunk(gen, s, t, cfg, *args, **kwargs):
        out = real_eval(gen, s, t, cfg, *args, **kwargs)
        chunks.append((cfg.num_hypotheses, cfg.fused, float(out[1][0]),
                       int(out[2].sum())))
        return out

    def read_flag(flag):
        reads[0] += 1
        return real_read(flag)

    monkeypatch.setattr(tr, "_eval_chunk", eval_chunk)
    monkeypatch.setattr(tr, "_read_flag", read_flag)
    monkeypatch.setattr(tr, "FUSED_ADAPTIVE_MIN_CHUNK", GATE)
    res = tr.ransac_homography_adaptive(
        None, T(src), T(tar), ransac_config_from(dataclasses.asdict(jcfg)),
        confidence, max_chunks,
        None if point_mask is None else T(point_mask), indices=T(idx))
    return res, chunks, reads[0]


def _assert_margins(chunks, n_valid, confidence, n_scheduled):
    """``done`` stays at least 1% away from ``needed`` at every stop test, so
    an ulp of ``log1p`` cannot move the stop."""
    conf = min(max(confidence, 0.0), 1.0 - 1e-7)
    done, best, ninl = 0, -math.inf, 0
    for i, (size, _, score, inliers) in enumerate(chunks):
        if score > best:
            best, ninl = score, inliers
        done += size
        if i + 1 == n_scheduled:
            break  # no stop test follows the schedule's last chunk
        p_good = min(max((ninl / max(n_valid, 1)) ** 4, 1e-12), 1.0 - 1e-7)
        needed = math.log1p(-conf) / math.log1p(-p_good)
        assert abs(done / needed - 1.0) > 0.01, (done, needed)


def _assert_same_adaptive_fit(res_t, res_j):
    # float32 against XLA's contracted multiply-adds: 5e-5 on the normalized
    # H; the masks are equal.
    np.testing.assert_allclose(fro(to_np(res_t.h)), fro(res_j.h), rtol=0,
                               atol=5e-5)
    np.testing.assert_array_equal(to_np(res_t.inlier_mask),
                                  np.asarray(res_j.inlier_mask))
    assert int(res_t.num_inliers) == int(res_j.num_inliers)


def _problem(sampling, masked, outlier_frac, seed=21):
    src, tar, h_true, inl = contaminated(seed, n=N, outlier_frac=outlier_frac)
    pm = None
    if sampling == "prosac":
        # Quality-sorted: inliers first, as a matcher's scores would put them.
        src, tar, inl = src[::-1].copy(), tar[::-1].copy(), inl[::-1].copy()
    if masked:
        pm = np.ones(N, bool)
        pm[-16:] = False
        tar[-16:] = 9999.0  # padding: never scored, never drawn
        inl = inl & pm
    return src, tar, h_true, inl, pm


@pytest.mark.parametrize("fused", [False, True], ids=["general", "fused"])
@pytest.mark.parametrize("sampling,masked,outlier_frac",
                         [("uniform", False, 0.5), ("uniform", True, 0.5),
                          ("prosac", False, 0.65)],
                         ids=["uniform", "masked", "prosac"])
def test_adaptive_matches_jax_on_replayed_draws(monkeypatch, jax_fit,
                                                draw_fns, sampling, masked,
                                                outlier_frac, fused):
    """Confidence 0.999 and a budget of five chunks: the loop leaves its
    first stage and stops inside the schedule, after the third chunk.
    (PROSAC's head draws among the sorted inliers and needs more outliers to
    get that far.)"""
    src, tar, h_true, inl, pm = _problem(sampling, masked, outlier_frac)
    key = jax.random.PRNGKey(4)
    jcfg = jr.RansacConfig(num_hypotheses=CHUNK, threshold=4.0, fused=fused,
                           sampling=sampling)
    idx, scheduled = _replay_draws(draw_fns, key, N, jcfg, 16, pm)
    assert scheduled == [128, 128, 512, 512, 2048]
    res_j, chunks_j = _jax_adaptive(monkeypatch, jax_fit, key, src, tar,
                                    jcfg, 0.999, 16, pm)
    res_t, chunks, reads = _port_adaptive(monkeypatch, src, tar, jcfg, 0.999,
                                          16, idx, pm)
    assert len(chunks) == chunks_j
    assert len(chunks) == 3
    assert [c[0] for c in chunks] == scheduled[:len(chunks)]
    assert [c[1] for c in chunks] == [fused and c[0] >= GATE for c in chunks]
    assert reads == len(chunks) + 1
    _assert_margins(chunks, N if pm is None else int(pm.sum()), 0.999,
                    len(scheduled))
    _assert_same_adaptive_fit(res_t, res_j)
    assert np.mean(to_np(res_t.inlier_mask) == inl) >= 0.95
    if pm is not None:
        assert not to_np(res_t.inlier_mask)[~pm].any()


def test_adaptive_exits_in_the_first_chunk(monkeypatch, jax_fit, draw_fns):
    """40% outliers at confidence 0.99 need ~33 draws: one chunk of 128."""
    src, tar, _, inl, _ = _problem("uniform", False, 0.4, seed=22)
    key = jax.random.PRNGKey(5)
    jcfg = jr.RansacConfig(num_hypotheses=CHUNK, threshold=4.0)
    idx, scheduled = _replay_draws(draw_fns, key, N, jcfg, 16)
    res_j, chunks_j = _jax_adaptive(monkeypatch, jax_fit, key, src, tar,
                                    jcfg, 0.99, 16)
    res_t, chunks, reads = _port_adaptive(monkeypatch, src, tar, jcfg, 0.99,
                                          16, idx)
    assert chunks_j == len(chunks) == 1 and reads == 2
    _assert_margins(chunks, N, 0.99, len(scheduled))
    _assert_same_adaptive_fit(res_t, res_j)
    # One chunk is the fixed-batch fit on the same draws.
    one = tr.ransac_homography(
        None, T(src), T(tar), tr.RansacConfig(num_hypotheses=CHUNK,
                                              threshold=4.0),
        indices=T(idx[:CHUNK]))
    assert torch.equal(one.h, res_t.h)
    assert torch.equal(one.inlier_mask, res_t.inlier_mask)


@pytest.mark.parametrize("fused", [False, True], ids=["general", "fused"])
def test_adaptive_exhausts_its_budget(monkeypatch, jax_fit, draw_fns, fused):
    """70% outliers at confidence 0.999 need ~850 draws; a budget of four
    chunks schedules 768, so the budget ends the loop: no read says stop."""
    src, tar, _, inl, _ = _problem("uniform", False, 0.7, seed=23)
    key = jax.random.PRNGKey(6)
    jcfg = jr.RansacConfig(num_hypotheses=CHUNK, threshold=4.0, fused=fused)
    idx, scheduled = _replay_draws(draw_fns, key, N, jcfg, 4)
    assert scheduled == [128, 128, 512]
    res_j, chunks_j = _jax_adaptive(monkeypatch, jax_fit, key, src, tar,
                                    jcfg, 0.999, 4)
    res_t, chunks, reads = _port_adaptive(monkeypatch, src, tar, jcfg, 0.999,
                                          4, idx)
    assert chunks_j == len(chunks) == 3 and reads == 3
    assert [c[1] for c in chunks] == [False, False, fused]
    _assert_margins(chunks, N, 0.999, len(scheduled))
    _assert_same_adaptive_fit(res_t, res_j)
    assert np.mean(to_np(res_t.inlier_mask) == inl) >= 0.95


def test_adaptive_with_confidence_zero_falls_back_to_the_identity(
        monkeypatch, jax_fit, draw_fns):
    """Confidence 0 needs 0 draws: no chunk runs, the running top-K is still
    NaN, and every candidate falls back to the identity, whole."""
    src, tar, _, _, _ = _problem("uniform", False, 0.4)
    key = jax.random.PRNGKey(7)
    jcfg = jr.RansacConfig(num_hypotheses=CHUNK, threshold=4.0,
                           refine_iters=0, final_polish=False)
    idx, _ = _replay_draws(draw_fns, key, N, jcfg, 4)
    res_j, chunks_j = _jax_adaptive(monkeypatch, jax_fit, key, src, tar,
                                    jcfg, 0.0, 4)
    res_t, chunks, reads = _port_adaptive(monkeypatch, src, tar, jcfg, 0.0, 4,
                                          idx)
    assert chunks_j == 0 and chunks == [] and reads == 1
    np.testing.assert_array_equal(to_np(res_t.h), np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(np.asarray(res_j.h), to_np(res_t.h))
    assert not to_np(res_t.inlier_mask).any() and int(res_t.num_inliers) == 0
    assert float(res_t.score) == float(res_j.score) == -math.inf


def test_adaptive_replaces_non_finite_candidates_whole(monkeypatch):
    """Two valid minimal sets among 126 repeated points: the top-K holds two
    NaN hypotheses, which become the identity and not a blend; the fit is the
    valid champion's."""
    src, tar, h_true, inl, _ = _problem("uniform", False, 0.0)
    idx = np.zeros((CHUNK, 4), np.int64)
    idx[5] = [3, 40, 77, 120]
    idx[9] = [10, 50, 90, 125]
    cfg = tr.RansacConfig(num_hypotheses=CHUNK, threshold=4.0)
    seen = {}
    real = tr._refine_and_pack

    def refine(h_top, *args):
        seen["h_top"] = h_top.clone()
        return real(h_top, *args)

    monkeypatch.setattr(tr, "_refine_and_pack", refine)
    res = tr.ransac_homography_adaptive(None, T(src), T(tar), cfg, 0.5, 1,
                                        indices=T(idx))
    h_top = seen["h_top"]
    assert h_top.shape == (4, 3, 3) and torch.isfinite(h_top).all()
    eye = torch.eye(3)
    assert torch.equal(h_top[2], eye) and torch.equal(h_top[3], eye)
    assert not torch.equal(h_top[0], eye)
    assert torch.isfinite(res.h).all() and int(res.num_inliers) >= 120


def test_adaptive_rejects_indices_of_the_wrong_size():
    src, tar, _, _, _ = _problem("uniform", False, 0.4)
    cfg = tr.RansacConfig(num_hypotheses=CHUNK)
    with pytest.raises(ValueError, match=r"\(768, 4\)"):
        tr.ransac_homography_adaptive(
            None, T(src), T(tar), cfg, 0.99, 4,
            indices=torch.zeros((CHUNK, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="integer"):
        tr.ransac_homography_adaptive(None, T(src), T(tar), cfg, 0.99, 4,
                                      indices=torch.zeros((768, 4)))


@pytest.mark.parametrize("sampling", ["uniform", "prosac"])
@pytest.mark.parametrize("fused", [False, True], ids=["general", "fused"])
def test_adaptive_draws_from_its_generator(monkeypatch, fused, sampling):
    """Without ``indices=`` the draws come from the generator: the same seed
    gives the same fit, reads stay at one a chunk, and no stage evaluates a
    chunk once the bound is met."""
    monkeypatch.setattr(tr, "FUSED_ADAPTIVE_MIN_CHUNK", GATE)
    src, tar, h_true, inl, _ = _problem(sampling, False, 0.6, seed=24)
    cfg = tr.RansacConfig(num_hypotheses=CHUNK, threshold=4.0, fused=fused,
                          sampling=sampling)
    reads, sizes = [], []
    real_read, real_eval = tr._read_flag, tr._eval_chunk

    def read_flag(flag):
        reads.append(real_read(flag))
        return reads[-1]

    def eval_chunk(gen, s, t, chunk_cfg, *args, **kwargs):
        sizes.append(chunk_cfg.num_hypotheses)
        return real_eval(gen, s, t, chunk_cfg, *args, **kwargs)

    monkeypatch.setattr(tr, "_read_flag", read_flag)
    monkeypatch.setattr(tr, "_eval_chunk", eval_chunk)
    fits = [tr.ransac_homography_adaptive(
        torch.Generator().manual_seed(9), T(src), T(tar), cfg, 0.999, 64)
        for _ in range(2)]
    assert torch.equal(fits[0].h, fits[1].h)
    # Two equal fits: each read True once a chunk, then False once and
    # stopped, short of the nine chunks that 64 x 128 schedules.
    assert reads.count(False) == 2 and reads.count(True) == len(sizes)
    assert sizes[:len(sizes) // 2] == sizes[len(sizes) // 2:]
    assert len(sizes) // 2 < 9
    assert np.mean(to_np(fits[0].inlier_mask) == inl) >= 0.95
    err = np.linalg.norm(apply_h(to_np(fits[0].h).astype(np.float64),
                                 src[inl]) - apply_h(h_true, src[inl]), axis=-1)
    assert err.mean() < 1.0


# --- PROSAC on the fixed-batch fits -------------------------------------------

@pytest.mark.parametrize("entry", ["general", "fused", "fused_batch"])
def test_prosac_fits_on_the_fixed_batch_paths(entry):
    """Quality-sorted points, 60 inliers before 140 outliers, a budget of 128:
    PROSAC's head of the schedule draws among the inliers."""
    src, tar, h_true, inl = contaminated(25, n=200, outlier_frac=0.7)
    src, tar, inl = src[::-1].copy(), tar[::-1].copy(), inl[::-1].copy()
    cfg = tr.RansacConfig(num_hypotheses=128, threshold=4.0,
                          sampling="prosac", fused=entry != "general")
    g = torch.Generator().manual_seed(2)
    if entry == "fused_batch":
        res = tr.ransac_homography_fused_batch(
            g, T(src)[None], T(tar)[None], cfg)[0]
    elif entry == "fused":
        res = tr.ransac_homography_fused(g, T(src), T(tar), cfg)
    else:
        res = tr.ransac_homography(g, T(src), T(tar), cfg)
    assert np.mean(to_np(res.inlier_mask) == inl) >= 0.95
    err = np.linalg.norm(apply_h(to_np(res.h).astype(np.float64), src[inl])
                         - apply_h(h_true, src[inl]), axis=-1)
    assert err.mean() < 1.0


def test_prosac_fixed_batch_matches_jax_on_its_draws():
    src, tar, _, _, _ = _problem("prosac", False, 0.5, seed=26)
    key = jax.random.PRNGKey(8)
    jcfg = jr.RansacConfig(num_hypotheses=256, threshold=4.0,
                           sampling="prosac")
    idx = np.asarray(jr.sample_minimal_sets_prosac(key, N, 256))
    res_j = jr.ransac_homography(key, src, tar, jcfg)
    res_t = tr.ransac_homography(None, T(src), T(tar),
                                 ransac_config_from(dataclasses.asdict(jcfg)),
                                 indices=T(idx))
    _assert_same_adaptive_fit(res_t, res_j)


# --- find_homography(confidence=) ----------------------------------------------

def _corner_err(h, h_true):
    c = np.array([[0.0, 0.0], [640.0, 0.0], [640.0, 480.0], [0.0, 480.0]])
    return float(np.mean(np.linalg.norm(
        apply_h(to_np(h).astype(np.float64), c) - apply_h(h_true, c), axis=-1)))


@pytest.mark.parametrize("method", ["ransac", "msac", "magsac", "lmeds",
                                    "fused"])
def test_find_homography_with_confidence_recovers_the_truth(method):
    src, tar, h_true, inl = contaminated(27, n=200, outlier_frac=0.5)
    h, mask = sks_tpu_torch.find_homography(
        T(src), T(tar), method=method, confidence=0.995, max_iters=4096)
    assert h.shape == (3, 3) and float(h[2, 2]) == 1.0
    assert mask.shape == (200,) and mask.dtype == torch.bool
    if method != "lmeds":  # see test_torch_ransac: held against JAX only
        assert _corner_err(h, h_true) < 1.0
        assert np.mean(to_np(mask) == inl) >= 0.95


def test_find_homography_confidence_routing(monkeypatch):
    """Chunks of min(256, max_iters), a multiple of 128 when fused, and
    ceil(max_iters / chunk) of them; eager chunks unless method='fused'."""
    calls = []

    def fake(generator, src, tar, config, **kwargs):
        calls.append((config, kwargs))
        return tr.RansacResult(torch.eye(3), torch.zeros(40, dtype=torch.bool),
                               torch.tensor(0), torch.tensor(0.0))

    monkeypatch.setattr(sks_tpu_torch.robust.api, "ransac_homography_adaptive",
                        fake)
    src, tar, _, _ = contaminated(28, n=40)
    find = sks_tpu_torch.find_homography
    find(T(src), T(tar), confidence=0.995, max_iters=4096)
    find(T(src), T(tar), confidence=0.9, max_iters=100, method="fused",
         sampling="prosac")
    find(T(src), T(tar), confidence=0.9, max_iters=1000, method="magsac",
         solver="sks")
    (c0, k0), (c1, k1), (c2, k2) = calls
    assert (c0.num_hypotheses, c0.fused, k0["max_chunks"]) == (256, False, 16)
    assert k0["confidence"] == 0.995 and k0["point_mask"] is None
    assert (c1.num_hypotheses, c1.fused, k1["max_chunks"]) == (128, True, 1)
    assert c1.solver == "aca" and c1.sampling == "prosac"
    assert (c2.num_hypotheses, c2.fused, k2["max_chunks"]) == (256, False, 4)
    assert c2.scoring == "magsac" and c2.solver == "sks"


def test_find_homography_with_confidence_batched_and_padded():
    """Leading batch dims fit pair after pair, each with its own early exit:
    the results of single fits drawing from the same generator in turn."""
    pairs = [contaminated(s, n=100, outlier_frac=f)
             for s, f in ((29, 0.3), (30, 0.6), (31, 0.3))]
    src = T(np.stack([p[0] for p in pairs]))
    tar = T(np.stack([p[1] for p in pairs]))
    pm = torch.ones((3, 100), dtype=torch.bool)
    pm[2, 85:] = False
    tar[2, 85:] = 9999.0
    kwargs = dict(confidence=0.999, max_iters=8192)
    h, mask = sks_tpu_torch.find_homography(
        src.reshape(3, 1, 100, 2), tar.reshape(3, 1, 100, 2),
        generator=torch.Generator().manual_seed(31),
        point_mask=pm.reshape(3, 1, 100), **kwargs)
    assert h.shape == (3, 1, 3, 3) and mask.shape == (3, 1, 100)
    g = torch.Generator().manual_seed(31)
    for i, p in enumerate(pairs):
        hi, mi = sks_tpu_torch.find_homography(
            src[i], tar[i], generator=g, point_mask=pm[i], **kwargs)
        assert torch.equal(hi, h[i, 0]) and torch.equal(mi, mask[i, 0])
        assert _corner_err(hi, p[2]) < 1.5
    assert not mask[2, 0, 85:].any()


def test_find_homography_prosac_with_confidence():
    src, tar, h_true, inl = contaminated(32, n=200, outlier_frac=0.7)
    src, tar, inl = src[::-1].copy(), tar[::-1].copy(), inl[::-1].copy()
    for method in ("ransac", "fused"):
        h, mask = sks_tpu_torch.find_homography(
            T(src), T(tar), method=method, sampling="prosac",
            confidence=0.999, max_iters=8192)
        assert _corner_err(h, h_true) < 1.0
        assert np.mean(to_np(mask) == inl) >= 0.95
