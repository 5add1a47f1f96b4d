"""The scoring kernel of an eager chunk (``kernels/score_cuda``) on the CPU.

A CUDA kernel cannot run here, so its arithmetic is held through its plain
version, ``score_h_plain``: ``score_hypotheses``' gains written the kernel's
way (each gated on its comparison, the point mask as a weight).  It is held
to ``score_hypotheses`` on chunks of ACA hypotheses at 50% outliers, 256 and
4,096 of them against 2,000, 1,999 and 384 points, with and without a point
mask, with NaN hypotheses (``aca_valid_mask`` on degenerate minimal sets)
and with hypotheses whose adjugate overflows float32: 'inliers' scores
equal, 'msac' and 'magsac' within 2e-6 relative (the sum over points in
another order).  The wrapper takes float32 alone, runs the plain version on
CPU tensors and launches nothing there; the eager chunk on CPU tensors
scores by ``score_hypotheses``.  The kernel is held on the card in
``test_torch_cuda.py``.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sks_tpu_torch.robust.ransac as tr
from sks_tpu_torch.kernels import LAUNCHES
from sks_tpu_torch.kernels import score_cuda as sc
from sks_tpu_torch.ops import SOLVERS_H, aca_valid_mask
from sks_tpu_torch.utils import profiling
from sks_tpu_torch.utils.synth import random_correspondences

THRESHOLD = 3.0
SIGMA_MAX = 3.0 * THRESHOLD
#: Relative bound of 'msac' and 'magsac' scores against score_hypotheses':
#: float32 sums of up to 2,000 gains in [0, 1] in two orders.
SOFT_RTOL = 2e-6


def score_cases(device="cpu", b=256, n=2000, masked=False, seed=0):
    """A chunk of ``b`` ACA hypotheses on ``n`` matches, half of them
    uniform junk: (h (b, 3, 3), src, tar, point_mask or None), float32 on
    ``device``.  Every 11th minimal set repeats a point (K1's degenerate
    set: NaN through ``aca_valid_mask``); every 7th hypothesis is scaled to
    a norm of 1e25, so that its adjugate overflows float32 (inf products,
    non-finite residuals); the mask drops a tenth of the points."""
    g = torch.Generator().manual_seed(seed + 1000 * b + n + 7 * masked)
    src, tar, _ = random_correspondences(g, (), n, 0.5)
    tar = tar.clone()
    tar[: n // 2] = torch.rand((n // 2, 2), generator=g) * 640.0
    idx = tr.sample_minimal_sets(g, n, b)
    idx[::11, 1] = idx[::11, 0]
    s4, t4 = src[idx], tar[idx]
    h = SOLVERS_H["aca"](s4, t4)
    h = torch.where(aca_valid_mask(s4, t4)[:, None, None], h,
                    torch.full_like(h, torch.nan))
    # Unit Frobenius norm, then 1e25: finite entries, products past 3.4e38.
    h[::7] = h[::7] / torch.linalg.vector_norm(h[::7], dim=(-2, -1),
                                               keepdim=True) * 1e25
    mask = (torch.rand(n, generator=g) < 0.9) if masked else None
    to = (lambda x: None if x is None else x.to(device))  # noqa: E731
    return to(h), to(src), to(tar), to(mask)


def kernel_kwargs(scoring):
    return dict(sigma_max=SIGMA_MAX, magsac_k=tr._MAGSAC_K) if (
        scoring == "magsac") else {}


def assert_scores_match(got, want, scoring):
    """'inliers' equal; 'msac', 'magsac' within ``SOFT_RTOL`` relative; -1
    where ``score_hypotheses`` gives -1."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if scoring == "inliers":
        assert torch.equal(got, want)
        return
    assert torch.equal(got == -1, want == -1)
    torch.testing.assert_close(got, want, rtol=SOFT_RTOL, atol=0)


def test_the_cases_hold_what_they_promise():
    h, src, tar, _ = score_cases(b=4096, n=384)
    finite = torch.isfinite(h).flatten(1).all(1)
    scores, _ = tr.score_hypotheses(h, src, tar, THRESHOLD)
    overflow = finite & torch.zeros_like(finite).index_fill_(
        0, torch.arange(0, 4096, 7), True)
    assert (~finite).sum() >= 4096 // 11  # NaN hypotheses
    # The scaled hypotheses' adjugates overflow: no point is their inlier.
    assert overflow.sum() > 500 and (scores[overflow] == 0).all()
    assert scores.max() >= 150  # some all-inlier draws


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [2000, 1999, 384])
@pytest.mark.parametrize("b", [256, 4096])
@pytest.mark.parametrize("scoring", ["inliers", "msac", "magsac"])
def test_plain_version_equals_score_hypotheses(scoring, b, n, masked):
    h, src, tar, mask = score_cases(b=b, n=n, masked=masked)
    want, _ = tr.score_hypotheses(h, src, tar, THRESHOLD, mask, scoring)
    got = sc.score_h_plain(h, src, tar, THRESHOLD, mask, scoring,
                           **kernel_kwargs(scoring))
    assert_scores_match(got, want, scoring)


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    h, src, tar, mask = score_cases(b=256, n=384, masked=True)
    before = dict(LAUNCHES)
    got = sc.score_h(h, src, tar, THRESHOLD, mask)
    assert LAUNCHES == before
    assert torch.equal(got, sc.score_h_plain(h, src, tar, THRESHOLD, mask))


@pytest.mark.parametrize("bad", ["float64", "h_shape", "points", "mask",
                                 "scoring", "magsac_args"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad):
    h, src, tar, mask = score_cases(b=256, n=384, masked=True)
    kwargs = {}
    scoring = "inliers"
    if bad == "float64":
        h = h.double()
    elif bad == "h_shape":
        h = h.reshape(-1, 9)
    elif bad == "points":
        tar = tar[:-1]
    elif bad == "mask":
        mask = mask[:-1]
    elif bad == "scoring":
        scoring = "lmeds"
    else:
        scoring, kwargs = "magsac", {"sigma_max": SIGMA_MAX}
    with pytest.raises((TypeError, ValueError)):
        sc.score_h(h, src, tar, THRESHOLD, mask, scoring, **kwargs)


def test_the_eager_chunk_on_the_cpu_scores_by_score_hypotheses():
    """On CPU tensors the chunk never takes the kernel's route: no launch,
    no ``ransac.score_kernel``, and its top-K and mask are the whole batch's
    ``score_hypotheses``."""
    _, src, tar, mask = score_cases(b=256, n=2000, masked=True)
    cfg = tr.RansacConfig(num_hypotheses=512, threshold=THRESHOLD)
    idx = tr.sample_minimal_sets(torch.Generator().manual_seed(3), 2000, 512)
    before = dict(LAUNCHES)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        h_top, sc_top, inl = tr._eval_chunk(None, src, tar, cfg, mask, idx)
    assert LAUNCHES == before
    assert "ransac.score_kernel" not in profiling.counters()
    s4, t4 = src[idx], tar[idx]
    h = SOLVERS_H["aca"](s4, t4)
    h = torch.where(aca_valid_mask(s4, t4)[:, None, None], h,
                    torch.full_like(h, torch.nan))
    scores, inls = tr.score_hypotheses(h, src, tar, THRESHOLD, mask)
    top = tr._top_k(scores, 4)
    assert torch.equal(sc_top, scores[top])
    assert torch.equal(inl, inls[top[0]])
