"""Port parity, kernels: the plain versions of K1 and K2 against the Pallas kernels.

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
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_parity import apply_h, fro, plane_h, quads, to_np

from sks_tpu.kernels import aca_pallas as jk
from sks_tpu.robust.ransac import fused_kernel_threshold as jthreshold
from sks_tpu.robust.ransac import RansacConfig as JConfig

from sks_tpu_torch.kernels import aca_cuda as tk
from sks_tpu_torch.kernels import _build
from sks_tpu_torch.ops import aca_h
from sks_tpu_torch.robust.ransac import RansacConfig, fused_kernel_threshold

B = 256  # two 128-lane rows of the TPU layout


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
    }[case]


@pytest.mark.parametrize("case", [
    "f64", "mixed_dtype", "not_soa", "non_contiguous", "pts_f64", "pts_shape",
    "weights_shape", "scoring",
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
    assert tk.LAUNCHES == before


def test_build_flags_keep_ieee_scoring():
    flags = _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    sources = _build._sources()
    assert [p.name for p in sources] == ["aca.cu"]
    # The library name follows the sources: an edit rebuilds.
    assert len(_build._digest(sources)) == 16
