"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (decided inside the
fixture, never at import).  The file imports nothing of JAX, so it runs on a
GPU machine without it, from the repository root:

    python -m pytest tests/test_torch_cuda.py -q -o addopts="" --noconftest

Sizes are the main path's: K1, K3 and the K4 instances at B = 2^18, a
ragged B and B = 1 (K4-NDLT also at 2^20); K2 at B = 8192 minimal sets
against N = 2,047 points, and at 2,048 and 65,536 against 2,000, 1,999 and 20
points with one pair and a pair axis of 8; the six K5 kinds at B = 2^20 and
1,000, from float32 and float64 storage.  The VO pipeline at the JAX
package's benchmark configuration on 6 frames rendered at (240, 320): one K2
launch a fused batch, the card against the CPU, and no host sync; with the
dense ESM polish too (``planar_slam``'s default), and the batched polish of
5 pairs against the CPU.  The pose graph's captured solve and a fused
batch's captured tail against their eager runs.  Bundle adjustment in float64 against the CPU.
The image-grounded benchmark (``bench/real_pipeline.py``): K2 once a pair
fit and once a ``sequence_ate``; the headline's fields, every bandwidth
fraction at most 1.05 of the card's spec.
"""

import copy
from functools import partial

import pytest
import torch

from sks_tpu_torch.geom.homography import normalize_h
from sks_tpu_torch.kernels import FP64_SOLVE_KERNELS, SOLVE_KERNELS
from sks_tpu_torch.kernels import aca_cuda as K
from sks_tpu_torch.robust.ransac import RansacConfig, fused_kernel_threshold
from sks_tpu_torch.robust.ransac import sample_minimal_sets
from sks_tpu_torch.utils.synth import (
    adversarial_quad_pairs,
    random_correspondences,
    random_quad_pairs,
)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def quads(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    src, tar = random_quad_pairs(g, 1 << 18)
    return K.to_soa(src), K.to_soa(tar)


@pytest.mark.parametrize("b", [1 << 18, 1000, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_kernel_equals_plain(quads, b, dtype):
    s = quads[0][:, :b].contiguous().to(dtype)
    t = quads[1][:, :b].contiguous().to(dtype)
    before = K.LAUNCHES["aca_solve"]
    hk = K.aca_solve_soa(s, t)
    torch.cuda.synchronize()
    assert K.LAUNCHES["aca_solve"] == before + 1
    hp = K.aca_solve_soa_plain(s, t)
    assert hk.dtype == dtype and hk.shape == (9, b)
    # -fmad=false: the kernel rounds each op as the plain version does.
    assert torch.equal(hk, hp)
    diff = (normalize_h(K.from_soa_h(hk.float()), "fro")
            - normalize_h(K.from_soa_h(hp.float()), "fro")).abs().max()
    assert diff.item() <= 1e-6


@pytest.fixture
def score_inputs(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    n = 2047
    src, tar, _ = random_correspondences(g, (), n, 0.5)
    out = torch.randperm(n, generator=g, device=dev)[: n // 2]
    tar = tar.clone()
    tar[out] = torch.rand((out.numel(), 2), generator=g, device=dev) * 640.0
    idx = sample_minimal_sets(g, n, 8192)
    pts = torch.cat([src.T, tar.T]).contiguous()
    w = (torch.rand(n, generator=g, device=dev) >= 0.1).float()
    return K.to_soa(src[idx]), K.to_soa(tar[idx]), pts, w


@pytest.mark.parametrize("scoring", ["inliers", "msac", "magsac"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_kernel_matches_plain(score_inputs, scoring, dtype):
    s, t, pts, w = score_inputs
    s, t = s.to(dtype), t.to(dtype)
    thr = fused_kernel_threshold(RansacConfig(threshold=3.0, scoring=scoring))
    before = K.LAUNCHES["aca_solve_score"]
    sk = K.aca_solve_score_soa(s, t, pts, thr, w, scoring)
    torch.cuda.synchronize()
    assert K.LAUNCHES["aca_solve_score"] == before + 1
    sp = K.aca_solve_score_soa_plain(s, t, pts, thr, w, scoring)
    assert sk.shape == (8192,) and sk.dtype == torch.float32
    assert sk.max().item() > 100  # the consensus is found
    if scoring == "inliers":
        # Identical residuals; integer sums are exact in any order.
        assert torch.equal(sk, sp)
    else:
        # The kernel sums points in order, the plain version pairwise.
        torch.testing.assert_close(sk, sp, rtol=1e-5, atol=1e-4)


def _k2_problem(dev, b, n, pairs, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(pairs):
        src, tar, _ = random_correspondences(g, (), n, 0.5)
        tar = tar.clone()
        tar[:n // 2] = torch.rand((n // 2, 2), generator=g, device=dev) * 640.0
        idx = sample_minimal_sets(g, n, b)
        out.append((K.to_soa(src[idx]), K.to_soa(tar[idx]),
                    torch.cat([src.T, tar.T]).contiguous(),
                    (torch.rand(n, generator=g, device=dev) >= 0.1).float()))
    return tuple(torch.stack(x) for x in zip(*out))


@pytest.mark.parametrize("b,n,pairs", [
    (2048, 2000, 1), (65536, 2000, 1), (2048, 1999, 1), (2048, 20, 1),
    (2048, 2000, 8), (2048, 1999, 8), (1000, 513, 3),
])
@pytest.mark.parametrize("scoring", ["inliers", "msac", "magsac"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_grid_kernel_matches_plain(dev, b, n, pairs, scoring, dtype):
    """Split points, pair axis, ragged N, dropped points: 'inliers' equal
    (integer sums), soft scores within summation order of the plain
    version's, and the same launch twice the same bits (no atomics)."""
    s, t, pts, w = _k2_problem(dev, b, n, pairs, seed=b + n + pairs)
    s, t = s.to(dtype), t.to(dtype)
    thr = fused_kernel_threshold(RansacConfig(threshold=3.0, scoring=scoring))
    before = K.LAUNCHES["aca_solve_score"]
    sk = K.aca_solve_score_soa(s, t, pts, thr, w, scoring)
    torch.cuda.synchronize()
    assert K.LAUNCHES["aca_solve_score"] == before + 1  # one for all pairs
    assert torch.equal(sk, K.aca_solve_score_soa(s, t, pts, thr, w, scoring))
    sp = K.aca_solve_score_soa_plain(s, t, pts, thr, w, scoring)
    assert sk.shape == (pairs, b)
    if scoring == "inliers":
        assert torch.equal(sk, sp)
    else:
        torch.testing.assert_close(sk, sp, rtol=1e-5, atol=1e-4)
    # The two-dimensional call, pair by pair: the same bits in every scoring
    # (the order of a score's sum does not depend on the pair count).
    for p in range(pairs):
        assert torch.equal(sk[p], K.aca_solve_score_soa(
            s[p], t[p], pts[p], thr, w[p], scoring))


def test_k2_refused_launch_raises_and_does_not_fall_back(dev):
    """65,536 pairs put grid z over the 65,535 a launch takes: the launch is
    refused, the wrapper raises from check_launch, and nothing is counted."""
    pairs = 65536
    s = torch.zeros((pairs, 8, 32), device=dev)
    pts = torch.zeros((pairs, 4, 4), device=dev)
    before = K.LAUNCHES["aca_solve_score"]
    with pytest.raises(RuntimeError, match="launch failed"):
        K.aca_solve_score_soa(s, s, pts, 1.0)
    assert K.LAUNCHES["aca_solve_score"] == before
    # The card is still usable: the error was the launch's, not sticky.
    ok = K.aca_solve_score_soa(s[:2], s[:2], pts[:2], 1.0)
    torch.cuda.synchronize()
    assert ok.shape == (2, 32)


@pytest.mark.parametrize("method", ["ransac", "msac", "magsac"])
def test_batched_find_homography_launches_k2_once(dev, method):
    import sks_tpu_torch

    g = torch.Generator(device=dev).manual_seed(6)
    src, tar, h_true = random_correspondences(g, (4,), 400, 0.5)
    before = K.LAUNCHES["aca_solve_score"]
    h, mask = sks_tpu_torch.find_homography(
        src, tar, method=method,
        generator=torch.Generator(device=dev).manual_seed(7))
    torch.cuda.synchronize()
    assert K.LAUNCHES["aca_solve_score"] == before + 1
    assert h.shape == (4, 3, 3) and mask.shape == (4, 400)
    g7 = torch.Generator(device=dev).manual_seed(7)
    for i in range(4):  # the per-pair loop on the same generator
        hi, mi = sks_tpu_torch.find_homography(src[i], tar[i], method=method,
                                               generator=g7)
        assert torch.equal(hi, h[i]) and torch.equal(mi, mask[i])


def test_array_inputs_are_computed_on_the_card(dev):
    import sks_tpu_torch

    g = torch.Generator(device=dev).manual_seed(9)
    src, tar, _ = random_correspondences(g, (), 300, 0.5)
    h, mask = sks_tpu_torch.find_homography(src.cpu().numpy(),
                                            tar.cpu().numpy())
    assert h.device.type == "cuda" and mask.device.type == "cuda"
    quad = sks_tpu_torch.get_perspective_transform(src[:4].cpu().numpy(),
                                                   tar[:4].cpu().numpy())
    tri = sks_tpu_torch.get_affine_transform(src[:3].cpu().numpy(),
                                             tar[:3].cpu().numpy())
    assert quad.device.type == "cuda" and tri.device.type == "cuda"
    # CPU tensors stay on the CPU.
    assert sks_tpu_torch.get_perspective_transform(
        src[:4].cpu(), tar[:4].cpu()).device.type == "cpu"


def test_ndlt_kernels_equal_plain_at_full_batch(dev):
    """K4-NDLT (Jacobi seed's v in shared memory) and K5-ndlt (rolled seed,
    capped registers) at B = 2^20 and 1,000: bit-equal to their plain
    versions, as before their redesign."""
    g = torch.Generator(device=dev).manual_seed(11)
    src, tar = random_quad_pairs(g, 1 << 20, torch.float64)
    s64, t64 = K.to_soa(src), K.to_soa(tar)
    for b in (1 << 20, 1000):
        s, t = s64[:, :b].contiguous(), t64[:, :b].contiguous()
        k4, k5 = SOLVE_KERNELS["ndlt"], FP64_SOLVE_KERNELS["ndlt"]
        assert _equal_nan(k4.kernel(s.float(), t.float()),
                          k4.plain(s.float(), t.float()))
        assert _equal_nan(k5.kernel(s, t), k5.plain(s, t))


@pytest.mark.parametrize("solver", ["ho", "ndlt"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_jacobi_kernels_equal_plain_on_adversarial_quads(dev, solver, dtype):
    """Collinear, repeated and zero-size quads, squares that underflow or
    overflow, NaN and infinity: the kernels that share the Jacobi rotation
    (K4-HO, K4-NDLT from float32 and bfloat16 storage; K5-ho, K5-ndlt from
    float32 and float64) equal their plain versions value for value, a NaN
    where the plain version has one."""
    src, tar, labels = adversarial_quad_pairs(0, 64)
    s = K.to_soa(torch.from_numpy(src).to(dev)).to(dtype)
    t = K.to_soa(torch.from_numpy(tar).to(dev)).to(dtype)
    registries = {torch.bfloat16: (SOLVE_KERNELS,),
                  torch.float32: (SOLVE_KERNELS, FP64_SOLVE_KERNELS),
                  torch.float64: (FP64_SOLVE_KERNELS,)}[dtype]
    for registry in registries:
        solve = registry[solver]
        hk, hp = solve.kernel(s, t), solve.plain(s, t)
        torch.cuda.synchronize()
        differ = ~((hk == hp) | (torch.isnan(hk) & torch.isnan(hp))).all(0)
        assert not differ.any(), (
            solve.key, sorted({labels[i] for i in differ.nonzero()[:, 0]}))
        # The set reaches both outcomes: NaN columns and finite ones.
        assert torch.isnan(hk).any() and torch.isfinite(hk).all(0).any()


def test_rotation_square_root_and_reciprocal_are_correctly_rounded(dev):
    """``csrc/baselines.cuh``: ``sqrt_1to2`` and ``rcp_1to2`` equal ``sqrtf``
    and ``1.0f / x`` on every float32 of [1, 2] and on NaN; ``DivTiny``
    equals ``num / den`` on 2^28 pairs, a good part of them with a subnormal
    quotient; and the shipped rotations
    equal the rotation as the plain version writes it on every triple of the
    special values (zeros, subnormals, values whose squares underflow or
    overflow, infinities, NaN)."""
    from sks_tpu_torch.kernels.baselines_cuda import angle_check

    res = angle_check()
    assert res["unit_range_arguments"] == 2 ** 23 + 2
    assert res["angle_triples"] >= 75 ** 3
    assert res["division_pairs"] == 2 ** 28
    assert res["subnormal_quotients"] >= 2 ** 20
    assert (res["sqrt_mismatches"], res["rcp_mismatches"],
            res["division_mismatches"], res["angle_mismatches"]) == (0,) * 4


def test_cuda_wrappers_raise_on_mixed_devices(dev):
    s = torch.zeros((8, 16), device=dev)
    with pytest.raises(ValueError):
        K.aca_solve_soa(s, s.cpu())
    with pytest.raises(ValueError):
        K.aca_solve_score_soa(s, s, torch.zeros((4, 5)), 1.0)


def test_find_homography_on_cuda_runs_the_fused_kernel(score_inputs, dev):
    import sks_tpu_torch

    g = torch.Generator(device=dev).manual_seed(2)
    src, tar, h_true = random_correspondences(g, (), 500, 0.5)
    before = K.LAUNCHES["aca_solve_score"]
    h, mask = sks_tpu_torch.find_homography(src, tar)
    torch.cuda.synchronize()
    assert K.LAUNCHES["aca_solve_score"] == before + 1
    assert h.device == src.device and mask.all()
    torch.testing.assert_close(normalize_h(h, "fro"),
                               normalize_h(h_true, "fro"), atol=2e-3, rtol=0)


def _equal_nan(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


# K3 and the four K4 instances (K1 has its own test above).
@pytest.mark.parametrize("name", ["sks", "rho_ge", "gpt_lu", "ho", "ndlt"])
@pytest.mark.parametrize("b", [1 << 18, 1000, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_k4_kernel_equals_plain(quads, name, b, dtype):
    key, kern, plain = SOLVE_KERNELS[name][:3]
    s = quads[0][:, :b].contiguous().to(dtype)
    t = quads[1][:, :b].contiguous().to(dtype)
    before = dict(K.LAUNCHES)
    hk = kern(s, t)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {**before, key: before[key] + 1}
    hp = plain(s, t)
    assert hk.dtype == dtype and hk.shape == (9, b)
    # Each body follows its PyTorch core op for op (-fmad=false, IEEE
    # division and sqrt): equal, a NaN where the plain version has one.
    assert _equal_nan(hk, hp)


def test_find_homography_sks_on_cuda_runs_k3(dev):
    import sks_tpu_torch

    g = torch.Generator(device=dev).manual_seed(4)
    src, tar, h_true = random_correspondences(g, (), 500, 0.5)
    before = dict(K.LAUNCHES)
    h, mask = sks_tpu_torch.find_homography(src, tar, solver="sks")
    torch.cuda.synchronize()
    assert K.LAUNCHES["sks_solve"] == before["sks_solve"] + 1
    assert K.LAUNCHES["aca_solve_score"] == before["aca_solve_score"]
    assert h.device == src.device and mask.all()
    torch.testing.assert_close(normalize_h(h, "fro"),
                               normalize_h(h_true, "fro"), atol=2e-3, rtol=0)


@pytest.fixture(scope="module")
def quads64():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(3)
    src, tar = random_quad_pairs(g, 1 << 20, torch.float64)
    return K.to_soa(src), K.to_soa(tar)


@pytest.mark.parametrize("name", list(FP64_SOLVE_KERNELS))
@pytest.mark.parametrize("b", [1 << 20, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_kernel_equals_plain(quads64, name, b, dtype):
    solve = FP64_SOLVE_KERNELS[name]
    s = quads64[0][:, :b].to(dtype).contiguous()
    t = quads64[1][:, :b].to(dtype).contiguous()
    before = dict(K.LAUNCHES)
    hk = solve.kernel(s, t)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {**before, solve.key: before[solve.key] + 1}
    hp = solve.plain(s, t)
    assert hk.dtype == torch.float64 and hk.shape == (9, b)
    # The float64 core op for op, its float32 seed rounded as .float() does,
    # and a true h22 division: equal, a NaN where the plain version has one.
    assert _equal_nan(hk, hp)
    assert torch.isfinite(hk).float().mean().item() >= 0.999


def test_find_homography_fp64_on_cuda_runs_k5_not_k2(dev):
    import sks_tpu_torch

    g = torch.Generator(device=dev).manual_seed(5)
    src, tar, h_true = random_correspondences(g, (), 500, 0.5, torch.float64)
    before = dict(K.LAUNCHES)
    h, mask = sks_tpu_torch.find_homography(src, tar, solver="sks")
    torch.cuda.synchronize()
    assert K.LAUNCHES["fp64_sks"] == before["fp64_sks"] + 1
    assert K.LAUNCHES["aca_solve_score"] == before["aca_solve_score"]
    assert K.LAUNCHES["sks_solve"] == before["sks_solve"]
    assert h.dtype == torch.float64 and h.device == src.device and mask.all()
    torch.testing.assert_close(normalize_h(h, "fro"),
                               normalize_h(h_true, "fro"), atol=2e-3, rtol=0)


# --- the confidence early-exit loop, PROSAC, aca_rect and factors ------------

def _contaminated(dev, seed, n, outlier_frac, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    src, tar, h = random_correspondences(g, (), n, 0.5, dtype)
    out = torch.randperm(n, generator=g, device=dev)[:int(n * outlier_frac)]
    tar = tar.clone()
    tar[out] = torch.rand((out.numel(), 2), generator=g, device=dev,
                          dtype=dtype) * 640.0
    inl = torch.ones(n, dtype=torch.bool, device=dev)
    inl[out] = False
    return src, tar, h, inl


def _corner_err(h, h_true):
    from sks_tpu_torch.geom.homography import apply_homography

    c = torch.tensor([[0.0, 0.0], [640.0, 0.0], [640.0, 480.0], [0.0, 480.0]],
                     device=h.device, dtype=h.dtype)
    return (apply_homography(h, c) - apply_homography(h_true.to(h.dtype), c)
            ).norm(dim=-1).mean().item()


@pytest.mark.parametrize("dtype,key", [(torch.float32, "aca_solve"),
                                       (torch.float64, "fp64_aca")])
def test_adaptive_fit_on_cuda_solves_its_chunks_in_the_kernel(dev, dtype, key):
    """Eager chunks of the early-exit loop: one launch of K1 (float64 points:
    K5-aca) a chunk, no K2, and one host read a chunk and one more."""
    import sks_tpu_torch
    from sks_tpu_torch.robust import ransac as R

    src, tar, h_true, inl = _contaminated(dev, 7, 2000, 0.5, dtype)
    reads = [0]
    real = R._read_flag

    def read_flag(flag):
        reads[0] += 1
        # The loop's one synchronisation: everything around it must not.
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(flag)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    real_tail = R._refine_and_pack

    def tail(*args):
        # The loop is over: the shared tail is held by the fixed-batch tests.
        torch.cuda.set_sync_debug_mode("default")
        return real_tail(*args)

    before = dict(K.LAUNCHES)
    R._read_flag, R._refine_and_pack = read_flag, tail
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = R.ransac_homography_adaptive(
            torch.Generator(device=dev).manual_seed(1), src, tar,
            RansacConfig(num_hypotheses=256, threshold=3.0), 0.999, 64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        R._read_flag, R._refine_and_pack = real, real_tail
    torch.cuda.synchronize()
    chunks = K.LAUNCHES[key] - before[key]
    assert 1 <= chunks <= 4 and reads[0] == chunks + 1
    assert K.LAUNCHES["aca_solve_score"] == before["aca_solve_score"]
    assert res.h.dtype == dtype and _corner_err(res.h, h_true) < 1.0
    assert (res.inlier_mask == inl).float().mean().item() >= 0.95
    h, mask = sks_tpu_torch.find_homography(src, tar, confidence=0.999)
    assert _corner_err(h, h_true) < 1.0


def test_adaptive_fused_fit_on_cuda_launches_k2_once_a_fused_chunk(dev):
    import sks_tpu_torch
    from sks_tpu_torch.robust import ransac as R

    src, tar, h_true, inl = _contaminated(dev, 8, 2000, 0.9)
    before = dict(K.LAUNCHES)
    h, mask = sks_tpu_torch.find_homography(
        src, tar, method="fused", confidence=0.999, max_iters=1 << 20)
    torch.cuda.synchronize()
    k1 = K.LAUNCHES["aca_solve"] - before["aca_solve"]
    k2 = K.LAUNCHES["aca_solve_score"] - before["aca_solve_score"]
    sizes = [c for c, n in R._chunk_schedule(256, 4096, 4, 2,
                                             R.ADAPTIVE_MAX_CHUNK)
             for _ in range(n)][:k1 + k2]
    assert k2 >= 1 and k1 + k2 < 18
    assert k2 == sum(c >= R.FUSED_ADAPTIVE_MIN_CHUNK for c in sizes)
    assert _corner_err(h, h_true) < 1.0
    assert (mask == inl).float().mean().item() >= 0.95


def test_adaptive_fit_on_cuda_equals_the_cpu_fit_on_the_same_draws(dev):
    from sks_tpu_torch.robust import ransac as R

    src, tar, _, _ = _contaminated(dev, 9, 1000, 0.6)
    cfg = RansacConfig(num_hypotheses=256, threshold=3.0)
    total = sum(c * n for c, n in R._chunk_schedule(256, 16, 4, 2,
                                                    R.ADAPTIVE_MAX_CHUNK))
    idx = sample_minimal_sets(torch.Generator(device=dev).manual_seed(2),
                              1000, total)
    counts = []
    real = R._eval_chunk

    def counted(*args, **kwargs):
        counts[-1] += 1
        return real(*args, **kwargs)

    R._eval_chunk = counted
    try:
        out = []
        for s, t, i in ((src, tar, idx), (src.cpu(), tar.cpu(), idx.cpu())):
            counts.append(0)
            out.append(R.ransac_homography_adaptive(None, s, t, cfg, 0.999,
                                                    16, indices=i))
    finally:
        R._eval_chunk = real
    assert counts[0] == counts[1] >= 1
    agree = (out[0].inlier_mask.cpu() == out[1].inlier_mask).float().mean()
    assert agree.item() >= 0.95


@pytest.mark.parametrize("entry", ["general", "fused", "confidence"])
def test_prosac_fits_on_cuda(dev, entry):
    import sks_tpu_torch

    # Quality-sorted: the 600 inliers first, 1,400 outliers after them.
    src, tar, h_true, inl = _contaminated(dev, 10, 2000, 0.7)
    order = torch.argsort(inl.to(torch.int8), descending=True, stable=True)
    src, tar, inl = src[order], tar[order], inl[order]
    kwargs = {"general": dict(solver="sks", max_iters=512),
              "fused": dict(method="fused", max_iters=512),
              "confidence": dict(confidence=0.999, max_iters=1 << 16)}[entry]
    before = K.LAUNCHES["aca_solve_score"]
    h, mask = sks_tpu_torch.find_homography(src, tar, sampling="prosac",
                                            **kwargs)
    torch.cuda.synchronize()
    assert (K.LAUNCHES["aca_solve_score"] - before == 1) == (entry == "fused")
    assert _corner_err(h, h_true) < 1.0
    assert (mask == inl).float().mean().item() >= 0.95


def test_batched_adaptive_fit_on_cuda_equals_its_single_fits(dev):
    import sks_tpu_torch

    pairs = [_contaminated(dev, 20 + i, 2000, f)
             for i, f in enumerate((0.3, 0.5, 0.7, 0.5))]
    src = torch.stack([p[0] for p in pairs])
    tar = torch.stack([p[1] for p in pairs])
    kwargs = dict(confidence=0.999, max_iters=1 << 16)
    h, mask = sks_tpu_torch.find_homography(
        src, tar, generator=torch.Generator(device=dev).manual_seed(4),
        **kwargs)
    g = torch.Generator(device=dev).manual_seed(4)
    for i, p in enumerate(pairs):
        hi, mi = sks_tpu_torch.find_homography(src[i], tar[i], generator=g,
                                               **kwargs)
        assert torch.equal(hi, h[i]) and torch.equal(mi, mask[i])
        assert _corner_err(hi, p[2]) < 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_aca_rect_family_and_factors_on_cuda(dev, dtype):
    from sks_tpu_torch import ops
    from sks_tpu_torch.geom.homography import apply_homography

    g = torch.Generator(device=dev).manual_seed(6)
    src, tar = random_quad_pairs(g, 4096, dtype)
    origin = torch.rand((4096, 2), generator=g, device=dev, dtype=dtype) * 50
    size = 64 + torch.rand((4096, 2), generator=g, device=dev, dtype=dtype) * 192
    rect = ops.rect_corners(origin, size)
    square = ops.rect_corners(origin, size[:, :1].expand(-1, 2))
    unit = ops.rect_corners(torch.zeros_like(origin), torch.ones_like(size))
    px = 0.01 if dtype == torch.float32 else 1e-8
    for h, quad in ((ops.aca_rect(tar, origin, size), rect),
                    (ops.aca_square(tar, origin, size[:, 0]), square),
                    (ops.aca_qr(tar), unit)):
        assert h.device == tar.device and h.dtype == dtype
        err = (apply_homography(h, quad) - tar).norm(dim=-1).amax(-1)
        assert err.median().item() < px
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    for factors, solver in ((ops.sks_factors, ops.sks),
                            (ops.aca_factors, ops.aca)):
        f = factors(src, tar)
        d = (normalize_h(f.reconstruct(), "fro")
             - normalize_h(solver(src, tar), "fro")).abs().amax((-2, -1))
        assert d.median().item() < tol
    chain = ops.sks_kernel_chain(ops.sks_factors(src, tar).params)
    prod = chain[0] @ chain[1] @ chain[2] @ chain[3]
    hk = ops.sks_factors(src, tar).h_k
    assert ((prod - hk).abs().amax((-2, -1))
            <= 1e-5 * hk.abs().amax((-2, -1))).all()


# ---- the planar-VO pipeline on the card --------------------------------------
# T = 6 frames rendered on the card at (240, 320), 384 corners, the JAX
# package's benchmark RANSAC configuration.

@pytest.fixture(scope="module")
def vo_sequence():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sks_tpu_torch.data.images import planar_sequence

    dev = torch.device("cuda", 0)
    return planar_sequence(torch.Generator(device=dev).manual_seed(21), 6,
                           (240, 320), loop=True)


def _vo_config(fused):
    return RansacConfig(num_hypotheses=1024, threshold=2.0, refine_iters=2,
                        fused=fused)


def test_pipeline_on_cuda_matches_the_port_on_the_cpu(vo_sequence):
    """The same fused call on CPU tensors, with the same generators (they
    draw on the card): poses within 5e-3, inlier counts within 2."""
    import sks_tpu_torch

    frames, _, k_mat = vo_sequence
    dev = frames.device
    kw = dict(num_corners=384, num_octaves=2, plane_depth=3.0)
    out_g = sks_tpu_torch.frames_to_poses(
        torch.Generator(device=dev).manual_seed(3), frames, k_mat,
        _vo_config(True), **kw)
    out_c = sks_tpu_torch.frames_to_poses(
        torch.Generator(device=dev).manual_seed(3), frames.cpu(),
        k_mat.cpu(), _vo_config(True), **kw)
    assert out_g["poses"].device == dev and out_c["poses"].device.type == "cpu"
    assert (out_g["poses"].cpu() - out_c["poses"]).abs().max().item() <= 5e-3
    gap = (out_g["num_inliers"].cpu().long() - out_c["num_inliers"].long())
    assert gap.abs().max().item() <= 2


@pytest.mark.parametrize("fused", [True, False])
def test_vo_trajectory_launches_k2_once_for_all_pairs(vo_sequence, fused):
    """Fused route: one K2 launch for every pair of a batch (planar_slam: one
    for the consecutive pairs, one for the closures); general route: K1 once
    a pair, no K2."""
    import sks_tpu_torch

    frames, _, k_mat = vo_sequence
    kw = dict(num_corners=384, num_octaves=2, plane_depth=3.0)
    before = dict(K.LAUNCHES)
    out = sks_tpu_torch.frames_to_poses(7, frames, k_mat, _vo_config(fused),
                                        **kw)
    torch.cuda.synchronize()
    made = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
    expect = ({"aca_solve_score": 1, "aca_solve": 0} if fused
              else {"aca_solve_score": 0, "aca_solve": 5})
    assert {k: made[k] for k in expect} == expect
    assert torch.isfinite(out["poses"]).all()
    before = dict(K.LAUNCHES)
    out = sks_tpu_torch.planar_slam(7, frames, k_mat, _vo_config(fused),
                                    strides=(2,), esm_iters=0, **kw)
    torch.cuda.synchronize()
    k2 = K.LAUNCHES["aca_solve_score"] - before["aca_solve_score"]
    k1 = K.LAUNCHES["aca_solve"] - before["aca_solve"]
    assert (k2, k1) == ((2, 0) if fused else (0, 5 + 4))
    assert out["closure_inliers"].shape == (4,)


def test_frames_to_poses_makes_no_host_sync(vo_sequence):
    """From pixels to poses nothing is read back to the host: the whole
    call runs under ``set_sync_debug_mode("error")`` (after a warm-up that
    builds the kernels)."""
    import sks_tpu_torch

    frames, _, k_mat = vo_sequence
    kw = dict(num_corners=384, num_octaves=2, plane_depth=3.0)
    sks_tpu_torch.frames_to_poses(1, frames, k_mat, _vo_config(True), **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sks_tpu_torch.frames_to_poses(1, frames, k_mat,
                                            _vo_config(True), **kw)
        slam = sks_tpu_torch.planar_slam(1, frames, k_mat, _vo_config(True),
                                         strides=(2,), esm_iters=0, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out["poses"]).all()
    assert torch.isfinite(slam["poses"]).all()


# ---- ESM and bundle adjustment on the card --------------------------------

def test_esm_polish_on_cuda_matches_cpu_without_host_sync(vo_sequence):
    """The batched symmetric polish of 5 pairs on the card: nothing read
    back inside it (``set_sync_debug_mode("error")`` after a warm-up), each
    model within 0.01 px of the same call on CPU tensors at the template's
    corners (float32 sums over 59,904 pixels in another order).  Each pair:
    a frame and its view under a known small homography, the start 1 px
    off it."""
    from sks_tpu_torch.data.images import warp_image
    from sks_tpu_torch.geom.homography import apply_homography
    from sks_tpu_torch.slam.tracking import esm_polish_pair_symmetric

    f1 = vo_sequence[0][:5]
    dev = f1.device
    h_true = torch.eye(3, device=dev).repeat(5, 1, 1)
    h_true[:, 0, 2] = torch.arange(5, device=dev) - 2.0
    h_true[:, 1, 0] = 0.01
    h_true[:, 2, 1] = 1e-5
    f2 = torch.stack([warp_image(f1[i], h_true[i]) for i in range(5)])
    h0 = h_true.clone()
    h0[:, :2, 2] += 1.0
    esm_polish_pair_symmetric(f1, f2, h0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h_g, rms_g = esm_polish_pair_symmetric(f1, f2, h0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    h_c, rms_c = esm_polish_pair_symmetric(f1.cpu(), f2.cpu(), h0.cpu())
    corners = torch.tensor([[16.0, 16.0], [304.0, 16.0], [16.0, 224.0],
                            [304.0, 224.0]], dtype=torch.float64)
    gap = (apply_homography(h_g.cpu().double(), corners)
           - apply_homography(h_c.double(), corners)).norm(dim=-1)
    assert gap.max().item() <= 0.01
    assert torch.allclose(rms_g.cpu(), rms_c, rtol=1e-3)


def test_vo_with_esm_makes_no_host_sync(vo_sequence):
    """planar_slam with its default esm_iters=8 and frames_to_poses with
    the polish run from pixels to poses without reading the card."""
    import sks_tpu_torch

    frames, _, k_mat = vo_sequence
    kw = dict(num_corners=384, num_octaves=2, plane_depth=3.0)
    sks_tpu_torch.planar_slam(1, frames, k_mat, _vo_config(True),
                              strides=(2,), **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slam = sks_tpu_torch.planar_slam(1, frames, k_mat, _vo_config(True),
                                         strides=(2,), **kw)
        out = sks_tpu_torch.frames_to_poses(1, frames, k_mat,
                                            _vo_config(True), esm_iters=8,
                                            **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(slam["poses"]).all()
    assert torch.isfinite(out["poses"]).all()


def test_posegraph_on_cuda_replays_one_graph_equal_to_the_eager_solve(dev):
    """optimize_posegraph at planar_slam's shapes (16 poses, 15 odometry
    edges and 20 closures, 5 x 30): captured once, at the first call, then
    replayed with nothing read back; each replay within 1e-5 of the eager
    solve of its own inputs (the same kernels in the same order), and the
    relaxation moves the poses."""
    from sks_tpu_torch.geom.lie import se3_exp
    from sks_tpu_torch.slam import posegraph as PG
    from sks_tpu_torch.utils import graphs

    gen = torch.Generator(device=dev).manual_seed(5)
    i = torch.arange(16, device=dev)
    edges = torch.cat([torch.stack([i[:-1], i[1:]], 1),
                       torch.stack([i[:-4], i[4:]], 1),
                       torch.stack([i[:-8], i[8:]], 1)])

    def graph():
        return PG.PoseGraph(
            poses=se3_exp(0.1 * torch.randn((16, 6), generator=gen,
                                            device=dev)),
            edges=edges,
            meas=se3_exp(0.1 * torch.randn((35, 6), generator=gen,
                                           device=dev)),
            weights=20 + 200 * torch.rand(35, generator=gen, device=dev))

    graphs._GRAPHS.clear()
    PG.optimize_posegraph(graph(), gn_iters=5, cg_iters=30)
    assert len(graphs._GRAPHS) == 1
    for g in (graph(), graph()):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = PG.optimize_posegraph(g, gn_iters=5, cg_iters=30).poses
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want = PG._solve(g, 5, 30, 1e-6, True)
        assert (got - want).abs().max().item() <= 1e-5
        assert (got - g.poses).abs().max().item() > 0.01
    assert len(graphs._GRAPHS) == 1


def test_fused_batch_tail_replays_one_graph_equal_to_the_eager_tail(
        dev, monkeypatch):
    """The per-pair tail of a fused batch of 4 masked pairs (N = 384, 50%
    outliers, VO's RANSAC configuration), the IRLS and polish kernels among
    its launches: captured once, at the first call, then replayed with
    nothing read back; each pair's inlier mask and count as the eager tail's
    and its model within 1e-4 at the image's corners (the same kernels in
    the same order), and within 1 px of the truth."""
    from sks_tpu_torch.robust import ransac as R
    from sks_tpu_torch.utils import graphs

    pairs = [_contaminated(dev, 31 + i, 384, 0.5) for i in range(4)]
    src, tar = (torch.stack([p[k] for p in pairs]) for k in (0, 1))
    mask = torch.ones((4, 384), dtype=torch.bool, device=dev)
    mask[:, 352:] = False
    config = _vo_config(True)

    def fit():
        gens = [torch.Generator(device=dev).manual_seed(i) for i in range(4)]
        return R.ransac_homography_fused_batch(gens, src, tar, config, mask)

    graphs._GRAPHS.clear()
    before = K.LAUNCHES["anneal_polish"]
    fit()
    assert len(graphs._GRAPHS) == 1
    # The polish kernel, once a pair in the eager run before the capture and
    # once a pair under it; the replay launches the captured kernels.
    assert K.LAUNCHES["anneal_polish"] == before + 2 * 4
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fit()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(graphs._GRAPHS) == 1
    assert K.LAUNCHES["anneal_polish"] == before + 2 * 4
    monkeypatch.setattr(graphs, "graphable", lambda *t: False)
    want = fit()
    assert K.LAUNCHES["anneal_polish"] == before + 3 * 4
    for g, w, p in zip(got, want, pairs):
        assert torch.equal(g.inlier_mask, w.inlier_mask)
        assert g.num_inliers.item() == w.num_inliers.item()
        assert _corner_err(g.h, w.h) <= 1e-4
        assert _corner_err(g.h, p[2]) < 1.0


def test_bundle_adjustment_on_cuda_matches_cpu(dev):
    """run_ba in float64 on the card against the CPU, at the damping of the
    JAX package's ``bench/ba_scale.py`` (1e-4: the scale of the scene is
    free, camera 0 alone being gauged, and the damping is what pins it):
    the same Jacobians, blocks and solves; poses within 1e-6 of their
    largest entry, the RMS within 1e-9 relative (seen: 6e-12 in the
    rotations, 1e-11 in the RMS)."""
    from sks_tpu_torch.slam.ba import rms_reprojection, run_ba, synth_ba_problem

    _, init = synth_ba_problem(torch.Generator().manual_seed(0), num_cams=4,
                               num_points=64, dtype=torch.float64)
    on_card = type(init)(*(x.to(dev) for x in (
        init.poses, init.points, init.intrinsics, init.obs, init.mask)))
    got = run_ba(on_card, iters=5, damping=1e-4)
    want = run_ba(init, iters=5, damping=1e-4)
    assert got.poses.device == dev
    gap = (got.poses.cpu() - want.poses).abs().max()
    assert gap.item() <= 1e-6 * want.poses.abs().max().item()
    rms_g, rms_c = rms_reprojection(got).item(), rms_reprojection(want).item()
    assert abs(rms_g - rms_c) <= 1e-9 * rms_c and rms_c < 1.0


# ---- the learned models (sks_tpu_torch.models) -------------------------------

def _head_inputs(dev, dtype, b=64):
    g = torch.Generator(device=dev).manual_seed(9)
    origin = torch.rand((b, 2), generator=g, device=dev, dtype=dtype) * 64
    size = 32 + torch.rand((b, 2), generator=g, device=dev, dtype=dtype) * 96
    offsets = (torch.rand((b, 4, 2), generator=g, device=dev, dtype=dtype)
               - 0.5) * 32
    weights = torch.randn((b, 3, 3), generator=g, device=dev, dtype=dtype)
    return offsets, origin, size, weights


def _head_grad(method, offsets, origin, size, weights):
    from sks_tpu_torch.models import offsets_to_h

    o = offsets.clone().requires_grad_()
    h = offsets_to_h(o, origin, size, method)
    torch.sum(h * weights).backward()
    return h.detach(), o.grad


def _gap(a, b):
    """Largest difference over the largest entry of ``b``."""
    return ((a.cpu().double() - b.double()).abs().max()
            / b.double().abs().max()).item()


@pytest.mark.parametrize("method", ["aca_rect", "dlt", "ge", "ndlt"])
def test_heads_on_cuda_match_cpu(dev, method):
    """Each head's H and its gradient to the offsets (B = 64) on the card
    against the CPU: float64 within 1e-9 of the largest entry, float32
    within 1e-4."""
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        args = _head_inputs(dev, dtype)
        h_g, g_g = _head_grad(method, *args)
        h_c, g_c = _head_grad(method, *(x.cpu() for x in args))
        assert h_g.device == dev and torch.isfinite(g_g).all()
        assert _gap(h_g, h_c) <= tol
        assert _gap(g_g, g_c) <= tol


# One train step on the card against the CPU, over the CPU's norm (as
# chip_smoke.py's models phase holds them): ~10x the largest readings on an
# H100 from a fresh Adam, gradients 1.7e-6 (CNN) and 8.0e-7 (IHN), updates
# 4.7e-4 and 2.3e-5.
STEP_GRAD_TOL = 2e-5
STEP_UPDATE_TOL = 5e-3


def _models_on(dev):
    from sks_tpu_torch import models as M

    cnn, cnn_state = M.create_train_state(
        torch.Generator(device=dev).manual_seed(1), device=dev)
    ihn, ihn_state = M.create_ihn_state(
        torch.Generator(device=dev).manual_seed(2), device=dev)
    return ((cnn, cnn_state, M.HomographyNet(), M.train_step),
            (ihn, ihn_state, M.IterativeHomographyNet(), M.ihn_train_step))


def test_models_forward_on_cuda_match_cpu(dev):
    """HomographyNet and the IHN at full width (64 x 64, B = 16, dim 64, 6
    iterations) on the card against the same weights on the CPU: offsets
    within 1e-5 of the largest (TF32 convs round to 10 mantissa bits,
    ~1e-3)."""
    from sks_tpu_torch.models.deep_homography import synth_training_batch

    pair, _ = synth_training_batch(
        torch.Generator(device=dev).manual_seed(3), 16)
    for model, _, twin, _ in _models_on(dev):
        twin.load_state_dict({k: v.cpu() for k, v in
                              model.state_dict().items()})
        with torch.no_grad():
            got, want = model(pair), twin(pair.cpu())
        assert got.device == dev and torch.isfinite(got).all()
        assert _gap(got, want) <= 1e-5


def _norm_gap(a, b):
    """Distance over the norm of ``b``."""
    b = b.double()
    return ((a.cpu().double() - b).norm() / b.norm()).item()


def test_train_steps_on_cuda_match_cpu_without_host_sync(dev):
    """One train step of each model on the card, after a warm-up step, under
    ``set_sync_debug_mode("error")`` (nothing reads the card: the loss stays
    a 0-d tensor), against the same step on the CPU from the same weights
    and Adam state: the loss within 1e-4 relative; each parameter's
    gradient and its update (after minus before), card against CPU, within
    STEP_GRAD_TOL and STEP_UPDATE_TOL of the CPU's norm of it (a skipped
    step is 1 away, a reversed one 2)."""
    from sks_tpu_torch.models.deep_homography import (
        TrainState,
        synth_training_batch,
    )

    g = torch.Generator(device=dev).manual_seed(4)
    warm = synth_training_batch(g, 16)
    pair, off = synth_training_batch(g, 16)
    for model, state, twin, step in _models_on(dev):
        step(model, state, *warm)
        twin.load_state_dict({k: v.cpu() for k, v in
                              model.state_dict().items()})
        twin_state = TrainState.create(twin)
        # A copy: Adam's step count lives on the host, and a loaded
        # state would share it with the card's.
        twin_state.optimizer.load_state_dict(
            copy.deepcopy(state.optimizer.state_dict()))
        before = [p.detach().clone() for p in model.parameters()]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, loss = step(model, state, pair, off)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        _, want = step(twin, twin_state, pair.cpu(), off.cpu())
        assert loss.dim() == 0 and loss.device == dev
        assert abs(loss.item() - want.item()) <= 1e-4 * want.item()
        for (name, p), q, p0 in zip(model.named_parameters(),
                                    twin.parameters(), before):
            assert _norm_gap(p.grad, q.grad) <= STEP_GRAD_TOL, name
            assert _norm_gap(p.detach() - p0,
                             q.detach() - p0.cpu()) <= STEP_UPDATE_TOL, name


# ---- the image-grounded benchmark and the headline --------------------------


def test_pair_parity_launches_k2_once_a_pair(dev):
    """``bench.real_pipeline.pair_parity`` on the card: each pair's fit takes
    the fused route (one K2 launch, one IRLS refit, one polish), and its
    corner error
    against the true H is under the JAX package's 1.5 px ceiling on the easy
    protocol."""
    from sks_tpu_torch.bench import real_pipeline

    before = dict(K.LAUNCHES)
    rows = real_pipeline.pair_parity(0, 2, device=dev)
    torch.cuda.synchronize()
    made = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
            if K.LAUNCHES[k] != before[k]}
    scored = [r for r in rows if "skipped" not in r]
    assert made == {"aca_solve_score": len(scored),
                    "irls_refine": len(scored),
                    "anneal_polish": len(scored)}, made
    assert scored and all(r["corner_err_ours_px"] < 1.5 for r in scored), rows


def test_sequence_ate_launches_k2_once_for_all_pairs(dev):
    from sks_tpu_torch.bench import real_pipeline

    before = K.LAUNCHES["aca_solve_score"]
    out = real_pipeline.sequence_ate(0, 6, device=dev)
    torch.cuda.synchronize()
    assert K.LAUNCHES["aca_solve_score"] == before + 1
    assert out["ate_rmse"] < 0.12 * out["path_length"] + 0.02, out


def test_headline_fields(dev):
    from sks_tpu_torch.bench import headline

    out = headline.run()
    assert out["metric"] == "aca_homographies_per_sec_per_chip"
    assert out["unit"] == "H/s" and out["value"] > 0
    assert out["device_kind"] == torch.cuda.get_device_name(0)
    assert out["vs_baseline"] == out["value"] / headline.BASELINE_H_PER_S
    spec = headline.HBM_SPEC_GBPS.get(out["device_kind"])
    assert out["hbm_spec_gbps"] == spec
    for suffix in ("", "_b6m", "_b6m_bf16"):
        assert out[f"effective_gbps{suffix}"] > 0
        if spec:
            assert 0 < out[f"roofline_fraction{suffix}"] <= 1.05, out
        else:
            assert f"roofline_fraction{suffix}" not in out


# ---- the IRLS refit of the top-K candidates (csrc/irls.cu) ----------------


def _irls_problem(dev, n, masked=False, scoring="inliers", seed=0):
    """n matches, half of them junk, an optional 90% point mask, and the top-4
    candidates of a 2,048-hypothesis chunk: the refit's main-path inputs
    (N = 2,000 a fit; ~384 matches a VO pair)."""
    from sks_tpu_torch.robust import ransac as R

    g = torch.Generator(device=dev).manual_seed(n + seed)
    src, tar, _ = random_correspondences(g, (), n, 0.5)
    tar = tar.clone()
    tar[:n // 2] = torch.rand((n // 2, 2), generator=g, device=dev) * 640.0
    mask = (torch.rand(n, generator=g, device=dev) > 0.1) if masked else None
    cfg = RansacConfig(num_hypotheses=2048, threshold=3.0, scoring=scoring)
    h_top, _, _ = R._eval_chunk(torch.Generator(device=dev).manual_seed(seed),
                                src, tar, cfg, mask)
    return h_top, src, tar, mask


def _corner_gap(h1, h2):
    from sks_tpu_torch.geom.homography import apply_homography

    corners = torch.tensor([[0.0, 0.0], [640.0, 0.0], [640.0, 480.0],
                            [0.0, 480.0]], device=h1.device)
    return (apply_homography(h1, corners.to(h1.dtype))
            - apply_homography(h2.to(h1.device), corners.to(h1.dtype))
            ).norm(dim=-1).max().item()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("scoring", ["inliers", "msac", "magsac", "lmeds"])
@pytest.mark.parametrize("n", [2000, 384])
def test_irls_kernel_matches_the_eager_refit(dev, n, scoring, masked):
    """One launch refits the 4 candidates through both rounds.  Against the
    eager refit (its plain version on the card) the only difference is the
    order of the sums (block sums against an einsum over 2N rows, 3 x 3
    products, the point loop): the corners within 1e-2 px and the refit's
    inlier mask within 2 points; the same against the kernel's specification
    (irls_refine_plain, on the CPU).  Two calls give the same bits (sums in
    a fixed order, no atomics)."""
    from sks_tpu_torch.kernels.irls_cuda import irls_refine_plain
    from sks_tpu_torch.robust import ransac as R

    h_top, src, tar, mask = _irls_problem(dev, n, masked, scoring)
    torch.cuda.synchronize()
    before = dict(K.LAUNCHES)
    hk = R._irls_refine(h_top, src, tar, 2, 3.0, mask, scoring)
    torch.cuda.synchronize()
    made = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
            if K.LAUNCHES[k] != before[k]}
    assert made == {"irls_refine": 1}
    assert hk.shape == (4, 3, 3) and hk.dtype == torch.float32
    assert not torch.equal(hk, h_top)  # the refit moved the candidates
    assert torch.equal(hk, R._irls_refine(h_top, src, tar, 2, 3.0, mask,
                                          scoring))
    he = R._irls_refine_eager(h_top, src, tar, 2, 3.0, mask, scoring, 9.0,
                              False)
    assert _corner_gap(hk, he) <= 1e-2
    _, inl_k = R.score_hypotheses(hk, src, tar, 3.0, mask)
    _, inl_e = R.score_hypotheses(he, src, tar, 3.0, mask)
    assert (inl_k != inl_e).sum(-1).max().item() <= 2
    weights = ({"magsac_k": R._MAGSAC_K, "sigma_max": 9.0}
               if scoring == "magsac" else {})
    hp = irls_refine_plain(h_top.cpu(), src.cpu(), tar.cpu(), 2, 3.0,
                           None if mask is None else mask.cpu(), **weights)
    assert _corner_gap(hk.cpu(), hp) <= 1e-2


def test_irls_kernel_keeps_nan_and_starved_candidates_and_counts_once(dev):
    """A NaN candidate and one with no point within the threshold come back
    bit for bit; under a profiler the refit counts ``ransac.irls_kernel``
    once a call."""
    from torch.profiler import ProfilerActivity, profile

    from sks_tpu_torch.robust import ransac as R
    from sks_tpu_torch.utils import profiling

    h_top, src, tar, _ = _irls_problem(dev, 2000, seed=1)
    h0 = h_top.clone()
    h0[1] = torch.nan
    h0[2] = torch.tensor([[1.0, 0.0, 5e3], [0.0, 1.0, 5e3], [0.0, 0.0, 1.0]],
                         device=dev)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = R._irls_refine(h0, src, tar, 2, 3.0)
        out2 = R._irls_refine(h0, src, tar, 2, 3.0)
    torch.cuda.synchronize()
    assert profiling.counters().get("ransac.irls_kernel") == 2
    assert out[1].isnan().all() and torch.equal(out[2], h0[2])
    assert torch.isfinite(out[[0, 3]]).all()
    assert torch.equal(out[[0, 2, 3]], out2[[0, 2, 3]])


# ---- the annealed LM polish of the selected model (csrc/polish.cu) --------

POLISH_FIXTURES = ["clean2000", "clean384", "o50_2000", "o50_384", "padded",
                   "skip_mass", "skip_quarter"]


def _polish_problem(dev, name):
    """A fixture of ``test_torch_polish.py`` (built on the CPU, moved to the
    card): (h, src, tar, mask)."""
    from test_torch_polish import _problem

    return tuple(None if t is None else t.to(dev) for t in _problem(name))


@pytest.mark.parametrize("name", POLISH_FIXTURES)
def test_polish_kernel_matches_its_plain_version_and_the_eager_polish(
        dev, name):
    """One launch polishes the model through 3 levels of 8 LM steps.  Against
    its plain version (on the CPU) it differs in the order of the sums over
    points only; against the eager polish on the card also in the order of
    the normal equations' sums and the LU's arithmetic (cuSOLVER's).  Both
    within 1e-3 px at the image's corners: a CPU emulation of the kernel's
    256 threads read at most 2.4e-4 px from the plain version on these
    fixtures, and the plain version 1.4e-4 px from the eager polish.  Two
    calls give the same bits (sums in a fixed order, no atomics)."""
    from test_torch_polish import ITERS, LEVELS

    from sks_tpu_torch.kernels.polish_cuda import anneal_polish_plain
    from sks_tpu_torch.robust import polish as P

    h, src, tar, mask = _polish_problem(dev, name)
    torch.cuda.synchronize()
    before = dict(K.LAUNCHES)
    hk = P.anneal_polish(h, src, tar, 3.0, mask)
    torch.cuda.synchronize()
    made = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
            if K.LAUNCHES[k] != before[k]}
    assert made == {"anneal_polish": 1}
    assert hk.shape == (3, 3) and hk.dtype == torch.float32
    assert torch.equal(hk, P.anneal_polish(h, src, tar, 3.0, mask))
    he = P._anneal_polish_eager(h, src, tar, 3.0, mask, LEVELS, ITERS)
    assert _corner_gap(hk, he) <= 1e-3
    hp = anneal_polish_plain(h.cpu(), src.cpu(), tar.cpu(), 3.0,
                             None if mask is None else mask.cpu(), LEVELS,
                             ITERS)
    assert _corner_gap(hk.cpu(), hp) <= 1e-3


@pytest.mark.parametrize("case", ["nan", "singular", "far"])
def test_polish_kernel_returns_a_start_without_consensus(dev, case):
    from test_torch_polish import _bad_start

    from sks_tpu_torch.robust import polish as P

    _, src, tar, mask = _polish_problem(dev, "o50_384")
    h0 = _bad_start(case).to(dev)
    out = P.anneal_polish(h0, src, tar, 3.0, mask)
    torch.cuda.synchronize()
    assert torch.equal(out, h0) or (case == "nan" and out.isnan().all())


def test_a_fused_fit_launches_the_polish_kernel_once(dev):
    """``find_homography``'s fused route: K2, the IRLS refit and the polish,
    one launch each; under a profiler the polish counts
    ``ransac.polish_kernel`` once a fit."""
    from torch.profiler import ProfilerActivity, profile

    import sks_tpu_torch
    from sks_tpu_torch.utils import profiling

    src, tar, h_true, _ = _contaminated(dev, 11, 2000, 0.5)
    sks_tpu_torch.find_homography(src, tar, max_iters=2048)
    torch.cuda.synchronize()
    before = dict(K.LAUNCHES)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        h, _ = sks_tpu_torch.find_homography(src, tar, max_iters=2048)
        torch.cuda.synchronize()
    made = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
            if K.LAUNCHES[k] != before[k]}
    assert made == {"aca_solve_score": 1, "irls_refine": 1,
                    "anneal_polish": 1}
    assert profiling.counters().get("ransac.polish_kernel") == 1
    assert _corner_err(h, h_true) < 1.0


#: The tail kernels and what keeps each on its eager stretch.
TAIL_ROUTES = [(kernel, case) for kernel in ("irls_refine", "anneal_polish")
               for case in ("float64", "requires_grad", "vmap", "df64")
               if kernel == "irls_refine" or case != "df64"]


@pytest.mark.parametrize("kernel,case", TAIL_ROUTES)
def test_tail_kernels_route_by_what_they_observe(dev, kernel, case):
    """float64 points, a gradient to record, a torch.func transform and, for
    the IRLS refit, float64 scoring keep the eager stretch (no launch); the
    wrappers themselves raise on float64."""
    from test_torch_polish import ITERS, LEVELS

    from sks_tpu_torch.kernels.irls_cuda import irls_refine
    from sks_tpu_torch.kernels.polish_cuda import anneal_polish
    from sks_tpu_torch.robust import polish as P
    from sks_tpu_torch.robust import ransac as R

    irls = kernel == "irls_refine"
    h, src, tar, _ = (_irls_problem(dev, 384) if irls
                      else _polish_problem(dev, "o50_384"))
    route = (partial(R._irls_refine, iters=2, threshold=3.0) if irls
             else partial(P.anneal_polish, threshold=3.0))
    wrapper = (partial(irls_refine, iters=2, threshold=3.0) if irls
               else partial(anneal_polish, threshold=3.0, point_mask=None,
                            levels=LEVELS, iters=ITERS))
    before = K.LAUNCHES[kernel]
    if case == "float64":
        route(h.double(), src.double(), tar.double())
    elif case == "requires_grad":
        route(h.clone().requires_grad_(), src, tar)
    elif case == "df64":
        route(h, src, tar, df64=True)
    elif irls:
        # The eager refit's Jacobi (ops.linalg.jacobi_eigh) writes rotated
        # columns into an eigenvector matrix that vmap does not batch, so it
        # cannot map over the points; the transform is active all the same.
        torch.func.vmap(lambda x: route(h, src, tar) * x)(
            torch.ones(1, device=dev))
    else:
        torch.func.vmap(lambda s: route(h, s, tar))(src[None])
    torch.cuda.synchronize()
    assert K.LAUNCHES[kernel] == before
    with pytest.raises(TypeError):
        wrapper(h.double(), src.double(), tar.double())
    assert K.LAUNCHES[kernel] == before


def test_find_homography_on_o50_requests_stays_inside_the_benchmark_limits(
        dev):
    """``find_homography`` (the fused route, the polish in its kernel) on 4
    requests of the benchmark's ``fit-n2000.o50`` traffic against the
    benchmark's plain reference (float64, 16,384 draws): the corners and the
    mask within the cell's own limits."""
    import json
    from pathlib import Path

    import sks_tpu_torch
    from benchmark.core import gen_fit, ref_fit

    root = Path(__file__).resolve().parent.parent / "benchmark"
    config = json.loads((root / "configs" / "fit-n2000.json").read_text())
    traffic = json.loads((root / "traffic" / "o50.json").read_text())
    gen = torch.Generator(device=dev).manual_seed(2_718_281_828)
    src, tar, _, _ = gen_fit.fit_requests(gen, 4, config,
                                          traffic["outlier_share"])
    limits = traffic["limits"]
    w, hgt = (float(v) for v in config["image_wh"])
    for i in range(4):
        h, mask = sks_tpu_torch.find_homography(
            src[i], tar[i], ransac_reproj_threshold=config["threshold_px"],
            max_iters=config["max_iters"], refine_iters=config["refine_iters"])
        h_ref, mask_ref = ref_fit.fit(
            src[i], tar[i], float(config["threshold_px"]),
            int(traffic["ref_hypotheses"]),
            torch.Generator(device=dev).manual_seed(i))
        assert ref_fit.corner_gap(h, h_ref, w, hgt) <= limits["corner_gap_px"]
        assert int((mask.cpu() != mask_ref.cpu()).sum()) <= limits[
            "mask_flips"]
