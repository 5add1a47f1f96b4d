"""The annealed LM polish's kernel (``kernels/polish_cuda``) on the CPU.

A CUDA kernel cannot run here, so its arithmetic is held through its plain
version, ``anneal_polish_plain``: the kernel's levels and steps written the
kernel's way (the 30 sums of a pass, one pass a step, the LU with LAPACK's
pivot rule, the 3 x 3 products written out), against the eager polish that
``robust.polish.anneal_polish`` runs on the CPU.  The two differ in the
order of their sums and in the LU's arithmetic only, so a polish moves the
image's corners by rounding: held to 1e-3 px, with the polished model's
inlier mask within 2 points.  The fixtures: clean matches, 50% outliers, a
point mask over padding, a last level skipped for a consensus under 8 points
and one skipped for a consensus under 25% of the first level's, and starts
that must come back unchanged.  The wrapper takes float32 and a bool mask
alone, runs the plain version on CPU tensors and launches nothing there; the
kernel is held on the card in ``test_torch_cuda.py``.
"""

import inspect
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sks_tpu_torch.robust.ransac as tr
from sks_tpu_torch.geom.homography import apply_homography
from sks_tpu_torch.kernels import LAUNCHES
from sks_tpu_torch.kernels import polish_cuda as pc
from sks_tpu_torch.robust import polish as tp
from sks_tpu_torch.utils import profiling
from sks_tpu_torch.utils.synth import random_correspondences

CORNERS = torch.tensor([[0.0, 0.0], [640.0, 0.0], [640.0, 480.0],
                        [0.0, 480.0]])
THRESHOLD = 3.0
#: The polish's schedule: robust.polish.anneal_polish's defaults.
_DEFAULTS = inspect.signature(tp.anneal_polish).parameters
LEVELS, ITERS = _DEFAULTS["levels"].default, _DEFAULTS["iters"].default


def _ring(g, n, radius):
    """n offsets of length ``radius`` px in uniform directions."""
    a = torch.rand(n, generator=g) * (2 * math.pi)
    return radius * torch.stack([torch.cos(a), torch.sin(a)], dim=-1)


def _rigid():
    """A rotation by 5 degrees and a shift: its transfer error is the same
    in both directions."""
    c, s = math.cos(math.radians(5.0)), math.sin(math.radians(5.0))
    return torch.tensor([[c, -s, 30.0], [s, c, -20.0], [0.0, 0.0, 1.0]])


def _problem(name):
    """(h, src, tar, mask) of a fixture: the model is the best of a
    512-hypothesis chunk, the polish's main-path input, or, for the fixtures
    of a skipped level, the true motion."""
    seed = sum(map(ord, name))
    g = torch.Generator().manual_seed(seed)
    n = 384 if name.endswith("384") else 2000
    mask = None
    if name.startswith("clean"):
        src, tar, _ = random_correspondences(g, (), n, 0.5)
    elif name.startswith("o50"):
        src, tar, _ = random_correspondences(g, (), n, 0.5)
        tar = tar.clone()
        tar[:n // 2] = torch.rand((n // 2, 2), generator=g) * 640.0
    elif name == "padded":
        # 1,760 real matches (30% junk) and 240 rows of padding that hold
        # junk, masked out.
        src, tar, _ = random_correspondences(g, (), n, 0.5)
        tar = tar.clone()
        tar[:528] = torch.rand((528, 2), generator=g) * 640.0
        tar[1760:] = torch.rand((240, 2), generator=g) * 640.0
        src = src.clone()
        src[1760:] = 0.0
        mask = torch.arange(n) < 1760
    elif name == "skip_mass":
        # 9 pairs of neighbouring matches 1.8 px off their image in opposite
        # directions, and 6 exact ones, under a rigid motion (the transfer
        # error the same both ways): all 24 inside the levels 1.0 and 0.7,
        # only the 6 exact ones inside 0.5 (1.8 > 1.5): under 8 points, but
        # not under 25% of 24.
        h = _rigid()
        base = torch.rand((9, 2), generator=g) * torch.tensor([600.0, 440.0])
        off = _ring(g, 9, 1.8)
        exact = torch.rand((6, 2), generator=g) * torch.tensor([600.0, 440.0])
        src = torch.cat([base, base + torch.tensor([1.0, 0.0]), exact])
        tar = apply_homography(h, src) + torch.cat(
            [off, -off, torch.zeros((6, 2))])
        return h, src, tar, None
    elif name == "skip_quarter":
        # Under the same motion, 1,200 matches 1.8 px off, 120 exact and 680
        # junk: 120 inside the level 0.5, over 8 but under 25% of the first
        # level's 1,320.
        h = _rigid()
        src = torch.rand((n, 2), generator=g) * torch.tensor([640.0, 480.0])
        tar = apply_homography(h, src)
        tar[:1200] = tar[:1200] + _ring(g, 1200, 1.8)
        tar[1320:] = torch.rand((n - 1320, 2), generator=g) * 640.0
        return h, src, tar, None
    else:
        raise KeyError(name)
    cfg = tr.RansacConfig(num_hypotheses=512, threshold=THRESHOLD)
    h_top, _, _ = tr._eval_chunk(torch.Generator().manual_seed(seed), src,
                                 tar, cfg, mask)
    return h_top[0], src, tar, mask


def _eager(h, src, tar, mask, levels=LEVELS):
    return tp._anneal_polish_eager(h, src, tar, THRESHOLD, mask, levels,
                                   ITERS)


def _plain(h, src, tar, mask, levels=LEVELS):
    return pc.anneal_polish_plain(h, src, tar, THRESHOLD, mask, levels,
                                  ITERS)


def _corner_gap(a, b):
    return (apply_homography(a, CORNERS)
            - apply_homography(b, CORNERS)).norm(dim=-1).max().item()


FIXTURES = ["clean2000", "clean384", "o50_2000", "o50_384", "padded",
            "skip_mass", "skip_quarter"]


@pytest.mark.parametrize("name", FIXTURES)
def test_plain_version_matches_the_eager_polish(name):
    h, src, tar, mask = _problem(name)
    eager = _eager(h, src, tar, mask)
    plain = _plain(h, src, tar, mask)
    assert plain.shape == (3, 3) and plain.dtype == torch.float32
    assert _corner_gap(plain, eager) <= 1e-3
    _, inl_e = tr.score_hypotheses(eager[None], src, tar, THRESHOLD, mask)
    _, inl_p = tr.score_hypotheses(plain[None], src, tar, THRESHOLD, mask)
    assert (inl_e != inl_p).sum().item() <= 2
    # The polish moved a chunk's model: it did not skip every level (the
    # fixtures of a skipped level start at the truth).
    assert name.startswith("skip") or _corner_gap(plain, h) > 1e-2


@pytest.mark.parametrize("name", ["skip_mass", "skip_quarter"])
def test_a_skipped_level_leaves_the_model_as_the_levels_before_it(name):
    """The last level's consensus is under 8 points (``skip_mass``) or under
    25% of the first level's (``skip_quarter``): both versions return, bit
    for bit, what the first two levels alone give."""
    h, src, tar, mask = _problem(name)
    two = LEVELS[:2]
    assert torch.equal(_plain(h, src, tar, mask),
                       _plain(h, src, tar, mask, two))
    assert torch.equal(_eager(h, src, tar, mask), _eager(h, src, tar, mask,
                                                         two))


def _bad_start(case):
    if case == "nan":
        return torch.full((3, 3), torch.nan)
    if case == "singular":
        return torch.zeros((3, 3))
    # A translation that carries every point out of the threshold.
    return torch.tensor([[1.0, 0.0, 5e3], [0.0, 1.0, 5e3], [0.0, 0.0, 1.0]])


@pytest.mark.parametrize("case", ["nan", "singular", "far"])
def test_a_start_without_consensus_comes_back_unchanged(case):
    _, src, tar, mask = _problem("o50_384")
    h0 = _bad_start(case)
    for out in (_plain(h0, src, tar, mask),
                _eager(h0, src, tar, mask)):
        assert torch.equal(out, h0) or (case == "nan" and out.isnan().all())


@pytest.mark.parametrize("n", [2000, 384])
def test_the_fused_step_is_the_two_pass_step(n):
    """One pass a step (the kernel's) gives the bits of the eager loop's two
    passes, a system at hn and a cost at h_new: an accepted step's pass is
    the next step's system, a rejected one keeps the system at hn."""
    h, src, tar, mask = _problem("o50_384" if n == 384 else "o50_2000")
    w = (tr._residual2(h[None], src, tar)[0] < 2 * THRESHOLD ** 2).float()
    sn, p1 = tp._hartley(src, w)
    tn, p2 = tp._hartley(tar, w)
    hn = pc._mul3(pc._mul3(tp._t_matrix(*p2), h), tp._t_inv_matrix(*p1))
    hn = hn / hn[2, 2]
    lam = torch.full((), 1e-3)
    taken = 0
    for _ in range(ITERS):
        s = pc._system(hn, sn, tn, w)
        h_new = hn + torch.cat([pc._solve(s, lam), torch.zeros(1)]).reshape(
            3, 3)
        cost_new = pc._system(h_new, sn, tn, w)[-1]
        ok = (torch.isfinite(cost_new) & (cost_new < s[-1])
              & torch.isfinite(h_new).all())
        taken += int(ok)
        hn = torch.where(ok, h_new, hn)
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-8), lam * 10.0)
    want = pc._mul3(pc._mul3(tp._t_inv_matrix(*p2), hn), tp._t_matrix(*p1))
    assert 0 < taken < ITERS  # both branches ran
    assert torch.equal(pc._lm(h, src, tar, w, ITERS), want)


def test_the_solve_is_lu_with_partial_pivoting():
    """``_solve`` against float64 LAPACK on a damped system whose first
    column's largest entry is off the diagonal (a row swap at step 0)."""
    g = torch.Generator().manual_seed(3)
    s = torch.randn(30, generator=g)
    s[[0, 3, 5, 18, 20]] = s[[0, 3, 5, 18, 20]].abs() + 4.0
    s[6] = 50.0  # A[0, 6] = A[6, 0]: the pivot of column 0 is row 6
    lam = torch.full((), 1e-3)
    a = torch.cat([s, torch.zeros(1)])[pc._A_INDEX].reshape(8, 8).double()
    a = a + torch.diag(lam.double() * torch.diagonal(a) + 1e-12)
    want = torch.linalg.solve(a, -s[21:29].double())
    got = pc._solve(s, lam)
    assert ((got.double() - want).abs() <= 1e-4 * want.abs().max()).all()


def test_cpu_calls_run_the_plain_version_and_launch_nothing():
    h, src, tar, mask = _problem("padded")
    before = dict(LAUNCHES)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = pc.anneal_polish(h, src, tar, THRESHOLD, mask, LEVELS, ITERS)
        eager = tp.anneal_polish(h, src, tar, THRESHOLD, mask)
    assert torch.equal(out, _plain(h, src, tar, mask))
    # robust.polish keeps CPU tensors on its eager loop: no launch, no count.
    assert torch.equal(eager, _eager(h, src, tar, mask))
    assert "ransac.polish_kernel" not in profiling.counters()
    assert LAUNCHES == before


def _bad_call(case):
    """The arguments of a call the wrapper must refuse (the mask, levels and
    iters that a case leaves out are None, LEVELS and ITERS)."""
    h = torch.eye(3)
    p = torch.zeros((8, 2))
    meta = torch.zeros((8, 2), device="meta")
    ok_mask = torch.ones(8, dtype=torch.bool)
    args = {
        "h_f64": (h.double(), p, p, THRESHOLD),
        "src_f64": (h, p.double(), p.double(), THRESHOLD),
        "tar_f64": (h, p, p.double(), THRESHOLD),
        "h_batched": (h[None], p, p, THRESHOLD),
        "tar_shape": (h, p, p[:6], THRESHOLD),
        "points_not_pairs": (h, torch.zeros((8, 3)), torch.zeros((8, 3)),
                             THRESHOLD),
        "tar_device": (h, p, meta, THRESHOLD),
        "mask_float": (h, p, p, THRESHOLD, ok_mask.float()),
        "mask_shape": (h, p, p, THRESHOLD, ok_mask[:6]),
        "mask_device": (h, p, p, THRESHOLD, ok_mask.to("meta")),
        "no_levels": (h, p, p, THRESHOLD, None, ()),
        "nine_levels": (h, p, p, THRESHOLD, None, (1.0,) * 9),
        "iters": (h, p, p, THRESHOLD, None, LEVELS, -1),
    }[case]
    return args + (None, LEVELS, ITERS)[len(args) - 4:]


@pytest.mark.parametrize("case", [
    "h_f64", "src_f64", "tar_f64", "h_batched", "tar_shape",
    "points_not_pairs", "tar_device", "mask_float", "mask_shape",
    "mask_device", "no_levels", "nine_levels", "iters"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises((TypeError, ValueError)):
        pc.anneal_polish(*_bad_call(case))
