"""Port parity, kernels: the plain versions of K1-K4 against the Pallas kernels.

On CPU tensors each wrapper in ``sks_tpu_torch.kernels.aca_cuda`` runs its
kernel's plain PyTorch version; here that is held against the JAX package's
Pallas kernel run in interpret mode, on one seeded numpy input.  The CUDA
kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py), where both round every op on its
own and agree bit for bit.

XLA on the CPU contracts multiply-adds into FMAs; the plain versions do not.
For K1 that moves the normalized H by up to 4e-5.  For K2 it moves more: the
reverse transfer goes through the adjugate of the unnormalized ACA H, whose
entries reach 1e38-1e42 at pixel scale (past float32's range for about half
of all minimal sets) and whose residuals for near-degenerate sets are
roundoff.  There the two float32 evaluations differ whatever the order, so K2
is held exactly on the hypotheses RANSAC keeps (the best 16) and
statistically on the rest.

K3 (SKS) and the K4 instances GE, GPT and HO are held against their Pallas
kernels in interpret mode at the tolerances of tests/test_torch_solvers.py
(the same cores; the FMA differences, after ``normalize_h('fro')``): 5e-5,
and 2e-4 for HO.  K4-NDLT is held against its jitted core there.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_parity import apply_h, fro, from_tiles, plane_h, quads, to_np
from torch_parity import to_tiles

from sks_tpu.kernels import aca_pallas as jk
from sks_tpu.kernels import baselines_pallas as jb
from sks_tpu.kernels import sks_pallas as js
from sks_tpu.robust.ransac import fused_kernel_threshold as jthreshold
from sks_tpu.robust.ransac import RansacConfig as JConfig

from sks_tpu_torch.kernels import aca_cuda as tk
from sks_tpu_torch.kernels import baselines_cuda as tb
from sks_tpu_torch.kernels import sks_cuda as ts
from sks_tpu_torch.kernels import _build
from sks_tpu_torch.kernels.fp64_cuda import fp64_solve_soa
from sks_tpu_torch.kernels.irls_cuda import irls_refine
from sks_tpu_torch.kernels.polish_cuda import anneal_polish
from sks_tpu_torch.ops import aca_h
from sks_tpu_torch.robust.ransac import RansacConfig, fused_kernel_threshold

B = 256  # two 128-lane rows of the TPU layout
T = torch.from_numpy


def _soa_pair(dtype=np.float32, b=B, seed=0):
    src, tar = quads(seed, b)
    return src, tar, tk.to_soa(torch.from_numpy(src)), \
        tk.to_soa(torch.from_numpy(tar))


def test_soa_layout_matches_tpu_layout():
    src, _, s_soa, _ = _soa_pair()
    assert s_soa.shape == (8, B) and s_soa.is_contiguous()
    # The TPU's (8, M, 128) is the same component-major order, lane-tiled.
    j_soa = np.asarray(jk.to_soa(src)).reshape(8, B)
    np.testing.assert_array_equal(to_np(s_soa), j_soa)
    h9 = torch.arange(9 * B, dtype=torch.float32).reshape(9, B)
    np.testing.assert_array_equal(
        to_np(tk.from_soa_h(h9)),
        np.asarray(jk.from_soa_h(to_np(h9).reshape(9, B // 128, 128))),
    )


def test_k1_plain_matches_pallas_f32():
    src, tar, s_soa, t_soa = _soa_pair()
    with pltpu.force_tpu_interpret_mode():
        hj = jk.aca_solve_soa(jk.to_soa(src), jk.to_soa(tar), tile=1)
    ht = tk.aca_solve_soa(s_soa, t_soa)
    assert ht.shape == (9, B) and ht.dtype == torch.float32
    # XLA contracts multiply-adds into FMAs, the plain version (like the
    # kernel, built with -fmad=false) does not: 5e-5 after normalize_h('fro')
    # (see test_torch_ops.py); exact against the eager op.
    np.testing.assert_allclose(
        fro(to_np(tk.from_soa_h(ht))), fro(jk.from_soa_h(hj)), atol=5e-5
    )
    np.testing.assert_array_equal(
        to_np(tk.from_soa_h(ht)),
        to_np(aca_h(torch.from_numpy(src), torch.from_numpy(tar))),
    )


def test_k1_plain_matches_pallas_bf16_storage():
    src, tar, s_soa, t_soa = _soa_pair()
    s16, t16 = s_soa.to(torch.bfloat16), t_soa.to(torch.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        hj = jk.aca_solve_soa(
            jk.to_soa(to_np(s16).T.reshape(B, 4, 2)).astype("bfloat16"),
            jk.to_soa(to_np(t16).T.reshape(B, 4, 2)).astype("bfloat16"),
            tile=1,
        )
    ht = tk.aca_solve_soa(s16, t16)
    assert ht.dtype == torch.bfloat16
    # Both store the f32 result rounded to bf16 (8 mantissa bits): at most one
    # bf16 step apart where the f32 results straddle a rounding boundary.
    a = fro(to_np(tk.from_soa_h(ht)))
    b = fro(to_np(jk.from_soa_h(hj)))
    np.testing.assert_allclose(a, b, atol=8e-3)
    # Exactly the f32 plain result of the bf16 inputs, rounded to bf16.
    ref = tk.aca_solve_soa(s16.float(), t16.float()).to(torch.bfloat16)
    assert torch.equal(ht, ref)


def test_k1_takes_a_ragged_batch():
    """No 128-lane padding: any B, and B = 0."""
    src, tar = quads(1, 1000)
    h = tk.aca_h_cuda(torch.from_numpy(src), torch.from_numpy(tar))
    assert h.shape == (1000, 3, 3)
    np.testing.assert_array_equal(
        to_np(h), to_np(aca_h(torch.from_numpy(src), torch.from_numpy(tar)))
    )
    empty = torch.zeros((8, 0))
    assert tk.aca_solve_soa(empty, empty).shape == (9, 0)


def _score_inputs(n=200, seed=3):
    """B minimal sets and N points: the first hypotheses see many inliers."""
    rng = np.random.default_rng(seed)
    h = plane_h(rng)
    ps = rng.uniform((0.0, 0.0), (640.0, 480.0), (n, 2))
    pt = apply_h(h, ps) + rng.normal(0.0, 1.0, (n, 2))
    pt[: n // 3] = rng.uniform(0.0, 640.0, (n // 3, 2))
    idx = rng.integers(0, n, (B, 4))
    s4 = ps[idx].astype(np.float32)
    t4 = pt[idx].astype(np.float32)
    pts = np.stack([ps[:, 0], ps[:, 1], pt[:, 0], pt[:, 1]]).astype(np.float32)
    w = (rng.uniform(size=n) > 0.1).astype(np.float32)  # 10% zero weights
    return s4, t4, pts, w


@pytest.mark.parametrize("scoring", ["inliers", "msac", "magsac"])
def test_k2_plain_matches_pallas(scoring):
    s4, t4, pts, w = _score_inputs()
    # The kernels' own threshold convention, from the same config on each side.
    t2 = fused_kernel_threshold(RansacConfig(threshold=4.0, scoring=scoring))
    assert t2 == jthreshold(JConfig(threshold=4.0, scoring=scoring))
    with pltpu.force_tpu_interpret_mode():
        # point_block 128 < N = 200: the TPU kernel pads N and accumulates
        # over two point blocks; the plain version takes N as it is.
        sj = jk.aca_solve_score_soa(
            jk.to_soa(s4), jk.to_soa(t4), pts, t2, point_weights=w,
            scoring=scoring, tile=1, point_block=128,
        )
    st = tk.aca_solve_score_soa(
        tk.to_soa(torch.from_numpy(s4)), tk.to_soa(torch.from_numpy(t4)),
        torch.from_numpy(pts), t2, torch.from_numpy(w), scoring,
    )
    assert st.shape == (B,) and st.dtype == torch.float32
    _assert_scores_agree(to_np(st), np.asarray(sj).reshape(B), scoring)


def _assert_scores_agree(st, sj, scoring):
    """K2 scores of the plain version against the Pallas kernel's (see the
    module docstring for why the tail of ill-conditioned hypotheses differs).
    """
    assert sj.max() > 10  # some hypotheses do find the consensus
    top = np.argsort(-sj, kind="stable")[:16]
    if scoring == "inliers":
        np.testing.assert_array_equal(st[top], sj[top])
        assert np.mean(st == sj) >= 0.97, np.mean(st == sj)
    else:
        # Summation order, and FMA-level residual differences over ~100
        # inliers: measured <= 1.3e-4 relative on the best 16.
        np.testing.assert_allclose(st[top], sj[top], rtol=5e-4)
        close = np.abs(st - sj) <= 1e-4 + 1e-5 * np.abs(sj)
        assert np.mean(close) >= 0.8, np.mean(close)


def test_k2_plain_matches_pallas_bf16_storage():
    s4, t4, pts, w = _score_inputs(seed=4)
    s16 = tk.to_soa(torch.from_numpy(s4)).to(torch.bfloat16)
    t16 = tk.to_soa(torch.from_numpy(t4)).to(torch.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        sj = jk.aca_solve_score_soa(
            jk.to_soa(s4).astype("bfloat16"), jk.to_soa(t4).astype("bfloat16"),
            pts, 16.0, point_weights=w, tile=1,
        )
    st = tk.aca_solve_score_soa(s16, t16, torch.from_numpy(pts), 16.0,
                                torch.from_numpy(w))
    _assert_scores_agree(to_np(st), np.asarray(sj).reshape(B), "inliers")


def test_k2_default_weights_are_ones():
    s4, t4, pts, _ = _score_inputs(seed=5)
    args = (tk.to_soa(torch.from_numpy(s4)), tk.to_soa(torch.from_numpy(t4)),
            torch.from_numpy(pts), 16.0)
    ones = torch.ones(pts.shape[1])
    assert torch.equal(tk.aca_solve_score_soa(*args),
                       tk.aca_solve_score_soa(*args, point_weights=ones))


def _pair_inputs(pairs=3):
    """``pairs`` independent K2 problems of one shape, stacked on a pair axis."""
    per = [_score_inputs(n=150, seed=20 + i) for i in range(pairs)]
    s = torch.stack([tk.to_soa(T(p[0])) for p in per])
    t = torch.stack([tk.to_soa(T(p[1])) for p in per])
    pts = torch.stack([T(p[2]) for p in per])
    w = torch.stack([T(p[3]) for p in per])
    return per, s, t, pts, w


@pytest.mark.parametrize("scoring", ["inliers", "msac", "magsac"])
def test_k2_pair_axis_equals_the_two_dimensional_call(scoring):
    """(P, 8, B) x (P, 4, N) x (P, N) -> (P, B): pair p of one call is the
    two-dimensional call on pair p, value for value (the same elementwise
    ops, each row summed over its own N points)."""
    _, s, t, pts, w = _pair_inputs()
    t2 = fused_kernel_threshold(RansacConfig(threshold=4.0, scoring=scoring))
    batched = tk.aca_solve_score_soa(s, t, pts, t2, w, scoring)
    assert batched.shape == (3, B) and batched.dtype == torch.float32
    assert torch.equal(
        batched, tk.aca_solve_score_soa_plain(s, t, pts, t2, w, scoring))
    for p in range(3):
        single = tk.aca_solve_score_soa(s[p], t[p], pts[p], t2, w[p], scoring)
        assert torch.equal(batched[p], single)
    # Default weights on the pair axis are ones, as without it.
    assert torch.equal(tk.aca_solve_score_soa(s, t, pts, t2, None, scoring),
                       tk.aca_solve_score_soa(s, t, pts, t2,
                                              torch.ones_like(w), scoring))


@pytest.mark.parametrize("scoring", ["inliers", "msac", "magsac"])
def test_k2_pair_axis_matches_pallas_pair_by_pair(scoring):
    """The pair axis is what ``jax.vmap`` of the TPU kernel gives: held
    against the Pallas kernel in interpret mode, called pair by pair (one
    shape, so one trace), at the tolerances of the two-dimensional test."""
    per, s, t, pts, w = _pair_inputs(pairs=2)
    t2 = fused_kernel_threshold(RansacConfig(threshold=4.0, scoring=scoring))
    st = to_np(tk.aca_solve_score_soa(s, t, pts, t2, w, scoring))
    with pltpu.force_tpu_interpret_mode():
        for p, (s4, t4, pts_p, w_p) in enumerate(per):
            sj = jk.aca_solve_score_soa(
                jk.to_soa(s4), jk.to_soa(t4), pts_p, t2, point_weights=w_p,
                scoring=scoring, tile=1, point_block=128,
            )
            _assert_scores_agree(st[p], np.asarray(sj).reshape(B), scoring)


def _kernel_point_cover(n, chunks, chunk_points, tile=512, slices=8, unroll=4):
    """How often K2's blocks visit each of n points, following the kernel's
    own arithmetic (csrc/aca.cu): chunks on grid y, tiles of ``tile`` points
    per chunk, the tile's points dealt over ``slices`` warps in runs that are
    multiples of ``unroll`` (positions at or beyond the tile's count are
    zero-weight padding)."""
    seen = np.zeros(n, np.int64)
    for c in range(chunks):
        begin, end = c * chunk_points, min(n, (c + 1) * chunk_points)
        for base in range(begin, end, tile):
            cnt = min(tile, end - base)
            run = -(-(-(-cnt // slices)) // unroll) * unroll
            padded = -(-cnt // unroll) * unroll
            assert padded <= tile
            for w in range(slices):
                for j in range(w * run, min(w * run + run, padded)):
                    if j < cnt:
                        seen[base + j] += 1
    return seen


@pytest.mark.parametrize("pairs,b,n", [
    (1, 2048, 2000), (1, 65536, 2000), (8, 2048, 2000), (1, 2048, 1999),
    (1, 2048, 20), (1, 128, 1), (1, 128, 0), (3, 1000, 513), (1, 32, 100_003),
    (1, 128, 30_000_000), (65535, 32, 7), (1, 1 << 24, 2001),
])
def test_k2_grid_covers_every_point_once(pairs, b, n):
    hyp_blocks, chunks, chunk_points = tk.score_grid(pairs, b, n)
    # Every grid axis in range: x < 2^31, y and z <= 65,535.
    assert hyp_blocks == -(-b // 32) and 1 <= hyp_blocks < 2 ** 31
    assert 1 <= chunks <= 65535 and pairs <= 65535
    assert chunk_points >= 1 and chunks * chunk_points >= n
    # No empty chunk, so no block is launched for nothing.
    assert n == 0 or (chunks - 1) * chunk_points < n
    if n <= 200_000:
        assert (_kernel_point_cover(n, chunks, chunk_points) == 1).all()
    # A pure function of the shapes.
    assert tk.score_grid(pairs, b, n) == (hyp_blocks, chunks, chunk_points)


def test_k2_grid_fills_the_card_and_stops():
    """2,048 hypotheses alone are 64 blocks on 132 SMs: chunks are added, but
    never past 32 points a warp; 65,536 hypotheses are 2,048 blocks and take
    a single chunk.  The pair count changes nothing: the chunks fix the order
    of each score's sum, which a shared launch must not change."""
    _, chunks_small, cp_small = tk.score_grid(1, 2048, 2000)
    assert chunks_small > 1 and 64 * chunks_small >= 2 * 132
    assert cp_small >= 8 * 32
    assert tk.score_grid(1, 65536, 2000)[1] == 1
    for b, n in ((2048, 2000), (65536, 2000), (1000, 513), (128, 30_000)):
        assert len({tk.score_grid(p, b, n) for p in (1, 2, 8, 500)}) == 1
    assert tk.score_grid(1, 2048, 100)[1] == 1  # too few points to split


# K3 and the K4 instances that interpret mode runs in seconds; the Pallas
# NDLT is marked slow in the JAX package's own tests.
_SOLVE = {
    "sks": (js.sks_solve_soa, ts.sks_solve_soa, 5e-5),
    "rho_ge": (jb.ge_solve_soa, tb.ge_solve_soa, 5e-5),
    "gpt_lu": (jb.gpt_solve_soa, tb.gpt_solve_soa, 5e-5),
    "ho": (jb.ho_solve_soa, tb.ho_solve_soa, 2e-4),
}


@pytest.mark.parametrize("name", list(_SOLVE))
def test_k3_k4_plain_matches_pallas_f32(name):
    jfn, tfn, atol = _SOLVE[name]
    src, tar, s_soa, t_soa = _soa_pair(seed=6)
    with pltpu.force_tpu_interpret_mode():
        hj = jfn(to_tiles(s_soa), to_tiles(t_soa), tile=1)
    ht = tfn(s_soa, t_soa)
    assert ht.shape == (9, B) and ht.dtype == torch.float32
    np.testing.assert_allclose(fro(to_np(tk.from_soa_h(ht))),
                               fro(to_np(tk.from_soa_h(T(from_tiles(hj))))),
                               atol=atol)


@pytest.mark.parametrize("name", ["sks", "rho_ge"])
def test_k3_k4_plain_matches_pallas_bf16_storage(name):
    jfn, tfn, _ = _SOLVE[name]
    _, _, s_soa, t_soa = _soa_pair(seed=7)
    s16, t16 = s_soa.to(torch.bfloat16), t_soa.to(torch.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        hj = jfn(to_tiles(s16).astype("bfloat16"),
                 to_tiles(t16).astype("bfloat16"), tile=1)
    ht = tfn(s16, t16)
    assert ht.dtype == torch.bfloat16
    # Both store the f32 result rounded to bf16: at most one bf16 step apart
    # (8 mantissa bits) where the f32 results straddle a rounding boundary.
    np.testing.assert_allclose(fro(to_np(tk.from_soa_h(ht))),
                               fro(to_np(tk.from_soa_h(T(from_tiles(hj))))),
                               atol=8e-3)
    # Exactly the f32 plain result of the bf16 inputs, rounded to bf16.
    assert torch.equal(ht, tfn(s16.float(), t16.float()).to(torch.bfloat16))


def test_soa_tiles_round_trip():
    _, _, s_soa, _ = _soa_pair()
    tiles = to_tiles(s_soa)
    assert tiles.shape == (8, B // 128, 128)
    np.testing.assert_array_equal(from_tiles(tiles), to_np(s_soa))


def test_k3_k4_take_a_ragged_batch():
    src, tar = quads(8, 1000)
    s, t = T(src), T(tar)
    for name in tb.SOA_SOLVERS:
        h = tb.baseline_h_cuda(name, s, t)
        assert h.shape == (1000, 3, 3) and bool(torch.isfinite(h).all())
    assert ts.sks_h_cuda(s, t).shape == (1000, 3, 3)
    empty = torch.zeros((8, 0))
    for fn in (ts.sks_solve_soa, *tb.SOA_SOLVERS.values()):
        assert fn(empty, empty).shape == (9, 0)


def _bad_call(case):
    s = torch.zeros((8, 16))
    p = torch.zeros((4, 10))
    w = torch.ones(10)
    return {
        "f64": (tk.aca_solve_soa, (s.double(), s.double())),
        "mixed_dtype": (tk.aca_solve_soa, (s, s.to(torch.bfloat16))),
        "not_soa": (tk.aca_solve_soa, (torch.zeros((16, 8)),) * 2),
        "non_contiguous": (tk.aca_solve_soa, (torch.zeros((16, 8)).T,) * 2),
        "pts_f64": (tk.aca_solve_score_soa, (s, s, p.double(), 1.0)),
        "pts_shape": (tk.aca_solve_score_soa, (s, s, p.T.contiguous(), 1.0)),
        "weights_shape": (tk.aca_solve_score_soa, (s, s, p, 1.0, w[:5])),
        "scoring": (tk.aca_solve_score_soa, (s, s, p, 1.0, w, "lmeds")),
        "pair_pts_without_axis": (tk.aca_solve_score_soa,
                                  (torch.stack([s, s]), torch.stack([s, s]),
                                   p, 1.0)),
        "pair_weights_without_axis": (tk.aca_solve_score_soa,
                                      (torch.stack([s, s]),
                                       torch.stack([s, s]),
                                       torch.stack([p, p]), 1.0, w)),
        "pair_counts_differ": (tk.aca_solve_score_soa,
                               (torch.stack([s, s]), torch.stack([s, s]),
                                torch.stack([p, p, p]), 1.0)),
        "pair_tar_without_axis": (tk.aca_solve_score_soa,
                                  (torch.stack([s, s]), s,
                                   torch.stack([p, p]), 1.0)),
        "two_pair_axes": (tk.aca_solve_score_soa,
                          (s[None, None], s[None, None], p[None, None], 1.0)),
        "pair_non_contiguous": (tk.aca_solve_score_soa,
                                (torch.stack([s, s])[:, :, ::2],
                                 torch.stack([s, s])[:, :, ::2],
                                 torch.stack([p, p]), 1.0)),
        "sks_f64": (ts.sks_solve_soa, (s.double(), s.double())),
        "ge_shape": (tb.ge_solve_soa, (s, s[:, :8].contiguous())),
        "gpt_non_contiguous": (tb.gpt_solve_soa,
                               (torch.zeros((16, 8)).T,) * 2),
        "ho_mixed_dtype": (tb.ho_solve_soa, (s, s.to(torch.bfloat16))),
        "ndlt_not_soa": (tb.ndlt_solve_soa, (torch.zeros((9, 16)),) * 2),
    }[case]


@pytest.mark.parametrize("case", [
    "f64", "mixed_dtype", "not_soa", "non_contiguous", "pts_f64", "pts_shape",
    "weights_shape", "scoring", "pair_pts_without_axis",
    "pair_weights_without_axis", "pair_counts_differ",
    "pair_tar_without_axis", "two_pair_axes", "pair_non_contiguous", "sks_f64", "ge_shape", "gpt_non_contiguous",
    "ho_mixed_dtype", "ndlt_not_soa",
])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    fn, args = _bad_call(case)
    with pytest.raises((TypeError, ValueError)):
        fn(*args)


def test_cpu_calls_run_the_plain_version_and_count_nothing():
    before = dict(tk.LAUNCHES)
    _, _, s_soa, t_soa = _soa_pair(b=128)
    tk.aca_solve_soa(s_soa, t_soa)
    tk.aca_solve_score_soa(s_soa, t_soa, torch.zeros((4, 3)), 1.0)
    ts.sks_solve_soa(s_soa, t_soa)
    for fn in tb.SOA_SOLVERS.values():
        fn(s_soa, t_soa)
    for kind in ("aca", "sks", "ge", "gpt", "ho", "ndlt"):
        fp64_solve_soa(s_soa, t_soa, kind)
    irls_refine(torch.eye(3)[None], torch.zeros((6, 2)), torch.zeros((6, 2)),
                2, 3.0)
    anneal_polish(torch.eye(3), torch.zeros((6, 2)), torch.zeros((6, 2)),
                  3.0, None, (1.0,), 1)
    assert tk.LAUNCHES == before
    assert set(tk.LAUNCHES) == {"aca_solve", "aca_solve_score", "sks_solve",
                                "ge_solve", "gpt_solve", "ho_solve",
                                "ndlt_solve", "fp64_aca", "fp64_sks",
                                "fp64_ge", "fp64_gpt", "fp64_ho",
                                "fp64_ndlt", "irls_refine", "anneal_polish"}


def test_build_flags_keep_ieee_scoring():
    flags = _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    sources = _build._sources()
    assert [p.name for p in sources] == ["aca.cu", "angle_check.cu",
                                         "baselines.cu", "fp64.cu",
                                         "irls.cu", "polish.cu", "sks.cu"]
    assert 'extern "C" int sks_angle_check(' in sources[1].read_text()
    # The library name follows the sources: an edit rebuilds.
    assert len(_build._digest()) == 16


def test_build_digest_covers_headers(tmp_path):
    """An edit to a shared header, not only to a .cu, names a new library."""
    import shutil

    shutil.copytree(_build._CSRC, tmp_path, dirs_exist_ok=True)
    before = _build._digest(tmp_path)
    assert before == _build._digest()
    header = tmp_path / "soa.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _build._digest(tmp_path) != before
    (tmp_path / "sks.cu").write_bytes(b"// edited")
    assert len({before, _build._digest(tmp_path)}) == 2


def test_every_solve_kernel_has_its_c_entry_points():
    from sks_tpu_torch.kernels import SOLVE_KERNELS

    text = "".join(p.read_text() for p in _build._sources())
    for kernel in _build.SOLVE_KERNELS:
        assert f"SKS_EXPORT_SOLVE({kernel}," in text
    # The solver registry names each of them once, with a source that has it.
    keys = [solve.key for solve in SOLVE_KERNELS.values()]
    assert sorted(keys) == sorted(_build.SOLVE_KERNELS)
    for solve in SOLVE_KERNELS.values():
        source = (_build._PKG.parent / solve.source).read_text()
        assert f"SKS_EXPORT_SOLVE({solve.key}," in source


def test_roofline_counts_operations_from_the_plain_versions():
    """bench/roofline.py: one operation per element an arithmetic op
    produces, under the type of the element, so a straight-line core counts
    its own lines: ACA's 101 float32 operations (the SoA core's) beside 4
    sign flips that take no part in the bound; K5 adds its 9 divisions by
    h22; K2 scales with N; K5-ndlt's float32 seed is held to the float32
    rate and only its LDL^T part to the float64 rate."""
    from sks_tpu_torch.bench import roofline
    from sks_tpu_torch.kernels import FP64_SOLVE_KERNELS, SOLVE_KERNELS

    assert roofline.solve_ops(SOLVE_KERNELS["aca"].plain) == {
        "float32": 101, "other": 4}
    assert roofline.solve_ops(FP64_SOLVE_KERNELS["aca"].plain,
                              torch.float64) == {"float64": 110, "other": 4}
    counts = {name: roofline.solve_ops(solve.plain)["float32"]
              for name, solve in SOLVE_KERNELS.items()}
    assert counts["aca"] < counts["sks"] < counts["rho_ge"] \
        < counts["gpt_lu"] < counts["ho"] < counts["ndlt"]
    per_hyp, per_pair = roofline.score_ops(tk.aca_solve_score_soa_plain,
                                           "inliers")
    # Solve + adjugate a hypothesis; a pair is 23 multiplies (two of them by
    # the 1.0 of ``1.0 / w``), 19 adds and subtracts, 2 reciprocals and its
    # term of the sum, beside 5 compares and selects.
    assert per_hyp == {"float32": 101 + 27, "other": 4}
    assert per_pair == {"float32": 45, "other": 5}
    assert roofline.score_ops(tk.aca_solve_score_soa_plain,
                              "magsac")[1]["float32"] > per_pair["float32"]
    # 2^20 ACA solves: 100 B each at 3.35 TB/s outlast 101 ops at 67 TFLOP/s.
    ms, by = roofline.bound_ms(100 * 2 ** 20, {"float32": 101 * 2 ** 20})
    assert by == "bytes" and abs(ms - 0.0313) < 1e-4
    assert roofline.bound_ms(100.0, {"float32": 1e9})[1] == "operations"
    # Compares and selects are no arithmetic; each type has its own rate.
    assert roofline.bound_ms(0.0, {"other": 1e12}) == (0.0, "bytes")
    mixed = roofline.bound_ms(0.0, {"float32": 67e9, "float64": 34e9})
    assert mixed[1] == "operations" and abs(mixed[0] - 2.0) < 1e-9
    ndlt64 = roofline.solve_ops(FP64_SOLVE_KERNELS["ndlt"].plain,
                                torch.float64)
    assert ndlt64["float32"] > 10 * ndlt64["float64"] > 0
    ho64 = roofline.solve_ops(FP64_SOLVE_KERNELS["ho"].plain, torch.float64)
    assert ho64["float32"] > 0 and ho64["float64"] > 0


def test_sass_listing_is_parsed_into_opcodes_and_loops():
    from sks_tpu_torch.bench import sass

    listing = """
        /*0000*/                   MOV R1, c[0x0][0x28] ;     /* 0x0 */
                                                              /* 0x1 */
        /*0010*/               @P0 BRA 0x50 ;                 /* 0x2 */
        /*0020*/                   FMUL R2, R4, R30 ;
        /*0030*/                   FADD.FTZ R0, -R0, -RZ ;
        /*0040*/              @!P0 BRA 0x20 ;
        /*0050*/                   EXIT ;
        /*0060*/                   BRA 0x60;
    """
    ops, loops = sass.parse_kernel(listing)
    assert ops == {"MOV": 1, "BRA": 3, "FMUL": 1, "FADD": 1, "EXIT": 1}
    assert loops == [("0x20", 3), ("0x60", 1)]
