"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (decided inside the
fixture, never at import).  The file imports nothing of JAX, so it runs on a
GPU machine without it, from the repository root:

    python -m pytest tests/test_torch_cuda.py -q -o addopts="" --noconftest

Sizes are the main path's: K1 at B = 2^18 and a ragged B; K2 at B = 8192
minimal sets against N = 2,047 points.
"""

import pytest
import torch

from sks_tpu_torch.geom.homography import normalize_h
from sks_tpu_torch.kernels import aca_cuda as K
from sks_tpu_torch.robust.ransac import RansacConfig, fused_kernel_threshold
from sks_tpu_torch.robust.ransac import sample_minimal_sets
from sks_tpu_torch.utils.synth import random_correspondences, random_quad_pairs


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
