"""The IRLS refit's kernel (``kernels/irls_cuda``) on the CPU.

A CUDA kernel cannot run here, so its arithmetic is held through its plain
version, ``irls_refine_plain``: the kernel's rounds written the kernel's way
(the 24 block sums of the normal matrix, the component Jacobi, the 3 x 3
products written out), against the eager refit that ``_irls_refine`` runs on
the CPU.  The two differ in the order of their sums only (the normal matrix
by block sums against an einsum over 2N rows; the 3 x 3 products), so a
refit moves the image's corners by rounding: measured at most 1.5e-3 px
over these inputs, held to 1e-2 px, with its inlier mask within 2 points.
The candidates are a chunk's real top-K (a refit from a candidate without
consensus is chaotic: one flipped weight moves it by pixels).  The wrapper
takes float32 alone, runs the plain version on CPU tensors and launches
nothing there; the kernel is held on the card in ``test_torch_cuda.py``.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sks_tpu_torch.robust.ransac as tr
from sks_tpu_torch.geom.homography import apply_homography
from sks_tpu_torch.kernels import LAUNCHES
from sks_tpu_torch.kernels.irls_cuda import irls_refine, irls_refine_plain
from sks_tpu_torch.utils import profiling
from sks_tpu_torch.utils.synth import random_correspondences

CORNERS = torch.tensor([[0.0, 0.0], [640.0, 0.0], [640.0, 480.0],
                        [0.0, 480.0]])
THRESHOLD = 3.0


def _problem(n, seed=0, masked=False, scoring="inliers"):
    """n matches, half of them junk, an optional 90% point mask, and the
    top-4 candidates of a 512-hypothesis chunk."""
    g = torch.Generator().manual_seed(n + seed)
    src, tar, _ = random_correspondences(g, (), n, 0.5)
    tar = tar.clone()
    tar[:n // 2] = torch.rand((n // 2, 2), generator=g) * 640.0
    mask = torch.rand(n, generator=g) > 0.1 if masked else None
    cfg = tr.RansacConfig(num_hypotheses=512, threshold=THRESHOLD,
                          scoring=scoring)
    h_top, _, _ = tr._eval_chunk(torch.Generator().manual_seed(seed), src,
                                 tar, cfg, mask)
    return h_top, src, tar, mask


def _weights(scoring):
    """The wrapper's weight arguments for ``_irls_refine``'s ``scoring``
    (its default sigma_max, 3 x threshold)."""
    if scoring == "magsac":
        return {"magsac_k": tr._MAGSAC_K, "sigma_max": 3.0 * THRESHOLD}
    return {}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("scoring", ["inliers", "msac", "magsac", "lmeds"])
@pytest.mark.parametrize("n", [2000, 384])
def test_plain_version_matches_the_eager_refit(n, scoring, masked):
    h_top, src, tar, mask = _problem(n, masked=masked, scoring=scoring)
    eager = tr._irls_refine(h_top, src, tar, 2, THRESHOLD, mask, scoring)
    plain = irls_refine_plain(h_top, src, tar, 2, THRESHOLD, mask,
                              **_weights(scoring))
    assert plain.shape == h_top.shape and plain.dtype == torch.float32
    gap = (apply_homography(plain, CORNERS)
           - apply_homography(eager, CORNERS)).norm(dim=-1)
    assert gap.max().item() <= 1e-2
    _, inl_e = tr.score_hypotheses(eager, src, tar, THRESHOLD, mask)
    _, inl_p = tr.score_hypotheses(plain, src, tar, THRESHOLD, mask)
    assert (inl_e != inl_p).sum(-1).max().item() <= 2
    # The refit found the consensus: it did not keep every candidate.
    assert not torch.equal(plain, h_top)


def test_nan_and_starved_candidates_come_back_as_they_went_in():
    h_top, src, tar, _ = _problem(384, seed=1)
    h0 = h_top.clone()
    h0[1] = torch.nan
    # A translation that carries every point out of the threshold: no
    # weight at all.
    h0[2] = torch.tensor([[1.0, 0.0, 5e3], [0.0, 1.0, 5e3], [0.0, 0.0, 1.0]])
    for out in (irls_refine_plain(h0, src, tar, 2, THRESHOLD),
                tr._irls_refine(h0, src, tar, 2, THRESHOLD)):
        assert out[1].isnan().all()
        assert torch.equal(out[2], h0[2])
        assert torch.isfinite(out[[0, 3]]).all()


def test_cpu_calls_run_the_plain_version_and_launch_nothing():
    h_top, src, tar, mask = _problem(384, masked=True)
    before = dict(LAUNCHES)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = irls_refine(h_top, src, tar, 2, THRESHOLD, mask)
        eager = tr._irls_refine(h_top, src, tar, 2, THRESHOLD, mask)
    assert torch.equal(out, irls_refine_plain(h_top, src, tar, 2, THRESHOLD,
                                              mask))
    # _irls_refine keeps CPU tensors on its eager loop: no launch, no count.
    assert torch.equal(eager, tr._irls_refine_eager(
        h_top, src, tar, 2, THRESHOLD, mask, "inliers", 9.0, False))
    assert "ransac.irls_kernel" not in profiling.counters()
    assert LAUNCHES == before


def _bad_call(case):
    """(args, kwargs) of a call the wrapper must refuse."""
    h = torch.eye(3)[None]
    p = torch.zeros((8, 2))
    args = {
        "h0_f64": (h.double(), p, p, 2, THRESHOLD),
        "src_f64": (h, p.double(), p.double(), 2, THRESHOLD),
        "tar_f64": (h, p, p.double(), 2, THRESHOLD),
        "tar_shape": (h, p, p[:6], 2, THRESHOLD),
        "points_not_pairs": (h, torch.zeros((8, 3)), torch.zeros((8, 3)), 2,
                             THRESHOLD),
        "h0_shape": (h[..., :2], p, p, 2, THRESHOLD),
        "mask_shape": (h, p, p, 2, THRESHOLD, torch.ones(6, dtype=bool)),
        "iters": (h, p, p, -1, THRESHOLD),
        "magsac_without_sigma": (h, p, p, 2, THRESHOLD),
    }[case]
    kwargs = {"magsac_k": tr._MAGSAC_K} if case == "magsac_without_sigma" \
        else {}
    return args, kwargs


@pytest.mark.parametrize("case", [
    "h0_f64", "src_f64", "tar_f64", "tar_shape", "points_not_pairs",
    "h0_shape", "mask_shape", "iters", "magsac_without_sigma"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    args, kwargs = _bad_call(case)
    with pytest.raises((TypeError, ValueError)):
        irls_refine(*args, **kwargs)
