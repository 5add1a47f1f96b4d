"""The program's spans and counters (``utils.profiling.annotate`` and
``count``) on every RANSAC route, read from a CPU trace at a small size.

Each route opens its spans nested as the benchmark's readers expect
(``benchmark/core/spans.py``): a single fit under ``ransac/fit``, its chunk
under ``ransac/chunk`` and its refit and polish under ``ransac/tail``; the
batched and VO routes keep the stage spans that ``bench/pipeline_fps``
reads, one after the other.  No span name nests inside itself.  Counters
count only while a profiler records, and with none recording ``annotate``
is a null context.
"""

import contextlib
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sks_tpu_torch
import sks_tpu_torch.robust.ransac as tr
import sks_tpu_torch.slam.odometry as odometry
from sks_tpu_torch.data.images import planar_sequence
from sks_tpu_torch.utils import profiling
from sks_tpu_torch.utils.synth import random_correspondences

N, B = 96, 128
CFG = tr.RansacConfig(num_hypotheses=B, threshold=3.0, refine_iters=1)
PREFIXES = ("ransac/", "vo/")
FIT = {("ransac/fit", "ransac/chunk"), ("ransac/fit", "ransac/tail"),
       ("ransac/tail", "ransac/irls"), ("ransac/tail", "ransac/polish")}
FUSED_CHUNK = {("ransac/chunk", "ransac/draw"), ("ransac/chunk", "ransac/k2"),
               ("ransac/chunk", "ransac/rescore")}
BATCH_TAIL = {("ransac/tail", "ransac/rescore"), ("ransac/tail", "ransac/irls"),
              ("ransac/tail", "ransac/polish")}


def _points(seed=0, outliers=0.3):
    gen = torch.Generator().manual_seed(seed)
    src, tar, _ = random_correspondences(gen, (), N, noise=0.3)
    k = int(outliers * N)
    tar[:k] = torch.rand((k, 2), generator=gen) * 480.0
    return src, tar


def _traced(fn):
    """Run ``fn`` under the profiler: (its result, the program's spans as
    (start, end, name), the counters of the window)."""
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.start_ns(), e.end_ns(), e.name())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(PREFIXES)]
    return out, spans, profiling.counters()


def _edges(spans):
    """(parent, child) names, each span's parent the innermost span that
    holds it (None at the top); also asserts no name nests in itself."""
    edges, stack = [], []
    for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= start:
            stack.pop()
        assert name not in {s[2] for s in stack}, f"{name} nests in itself"
        edges.append((stack[-1][2] if stack else None, name))
        stack.append((start, end, name))
    return edges


def _names(spans, name):
    return [s for s in spans if s[2] == name]


@pytest.mark.parametrize("fused", [False, True])
def test_a_single_fit_opens_the_fit_chunk_and_tail_spans(fused):
    src, tar = _points()
    cfg = dataclasses.replace(CFG, fused=fused)
    _, spans, counts = _traced(
        lambda: tr.ransac_homography(torch.Generator().manual_seed(1), src,
                                     tar, cfg))
    edges = set(_edges(spans))
    assert edges == ({(None, "ransac/fit")} | FIT
                     | (FUSED_CHUNK if fused else set()))
    assert len(_names(spans, "ransac/fit")) == 1
    assert counts == {"ransac.hypotheses": B, "ransac.chunks": 1}


def test_the_fused_fit_is_the_fit_with_the_fused_config():
    src, tar = _points()
    gen = lambda: torch.Generator().manual_seed(2)  # noqa: E731
    got, spans, counts = _traced(
        lambda: tr.ransac_homography_fused(gen(), src, tar, CFG))
    want = tr.ransac_homography(gen(), src, tar,
                                dataclasses.replace(CFG, fused=True))
    assert torch.equal(got.h, want.h)
    assert torch.equal(got.inlier_mask, want.inlier_mask)
    assert set(_edges(spans)) == {(None, "ransac/fit")} | FIT | FUSED_CHUNK
    assert counts == {"ransac.hypotheses": B, "ransac.chunks": 1}


@pytest.mark.parametrize("outliers,confidence", [(0.2, 0.99), (0.9, 0.9999)])
def test_the_adaptive_loop_counts_its_chunks_draws_and_reads(
        monkeypatch, outliers, confidence):
    """An easy problem stops on the bound (one read more than chunks); a hard
    one runs out of its schedule (as many reads as chunks)."""
    src, tar = _points(3, outliers)
    sizes = []
    eval_chunk = tr._eval_chunk

    def counted(generator, src, tar, config, *args):
        sizes.append(config.num_hypotheses)
        return eval_chunk(generator, src, tar, config, *args)

    monkeypatch.setattr(tr, "_eval_chunk", counted)
    cfg = dataclasses.replace(CFG, num_hypotheses=16)
    _, spans, counts = _traced(lambda: tr.ransac_homography_adaptive(
        torch.Generator().manual_seed(4), src, tar, cfg,
        confidence=confidence, max_chunks=8))
    edges = _edges(spans)
    assert set(edges) == {(None, "ransac/fit"), ("ransac/fit", "ransac/sync"),
                          *FIT}
    chunks = len(sizes)
    assert chunks >= 2
    assert len(_names(spans, "ransac/chunk")) == chunks == counts[
        "ransac.chunks"]
    assert counts["ransac.hypotheses"] == sum(sizes)
    reads = counts["ransac.host_reads"]
    assert len(_names(spans, "ransac/sync")) == reads
    schedule = tr._chunk_schedule(16, 8, 4, 2, tr.ADAPTIVE_MAX_CHUNK)
    stopped = sum(sizes) < sum(c * k for c, k in schedule)
    assert reads == chunks + 1 if stopped else reads == chunks
    bound = counts["ransac.bound"]
    assert isinstance(bound, float) and bound > 0
    assert (counts["ransac.hypotheses"] >= bound) == stopped


def test_the_fused_batch_keeps_its_stage_spans():
    gen = torch.Generator().manual_seed(5)
    pairs = [_points(s) for s in range(3)]
    src = torch.stack([p[0] for p in pairs])
    tar = torch.stack([p[1] for p in pairs])
    cfg = dataclasses.replace(CFG, fused=True)
    _, spans, counts = _traced(
        lambda: tr.ransac_homography_fused_batch(gen, src, tar, cfg))
    edges = _edges(spans)
    assert set(edges) == {(None, "ransac/draw"), (None, "ransac/k2"),
                          (None, "ransac/tail")} | BATCH_TAIL
    assert edges.count(("ransac/tail", "ransac/irls")) == 3
    assert counts == {"ransac.hypotheses": 3 * B}


@pytest.fixture(scope="module")
def frames():
    gen = torch.Generator().manual_seed(0)
    frames, _, k_mat = planar_sequence(gen, 3, (96, 128))
    return frames, k_mat


@pytest.mark.parametrize("fused", [False, True])
def test_the_vo_routes_nest_their_fit_spans(frames, fused):
    frames, k_mat = frames
    cfg = dataclasses.replace(CFG, fused=fused, threshold=2.0)
    _, spans, counts = _traced(lambda: sks_tpu_torch.frames_to_poses(
        0, frames, k_mat, cfg, num_corners=64, num_octaves=1,
        plane_depth=3.0))
    edges = _edges(spans)
    top = {(None, n) for n in ("vo/describe", "vo/match", "vo/pose",
                               "vo/chain")}
    if fused:
        assert set(edges) == top | {(None, "ransac/draw"), (None, "ransac/k2"),
                                    (None, "ransac/tail")} | BATCH_TAIL
        # The batch's one tail: no fit-level twin inside it.
        assert len(_names(spans, "ransac/tail")) == 1
        assert len(_names(spans, "ransac/fit")) == 0
    else:
        assert set(edges) == top | {(None, "ransac/general"),
                                    ("ransac/general", "ransac/fit")} | FIT
        assert len(_names(spans, "ransac/fit")) == 2
        assert counts["ransac.chunks"] == 2
    assert counts["ransac.hypotheses"] == 2 * B


@pytest.fixture(scope="module")
def sweep():
    gen = torch.Generator().manual_seed(1)
    frames, _, k_mat = planar_sequence(gen, 10, (96, 128))
    return frames, k_mat


def _slam(sweep, smooth=True):
    frames, k_mat = sweep
    # Without the LM polish: the spans do not depend on it, and its
    # launches would fill the trace.
    cfg = dataclasses.replace(CFG, fused=True, threshold=2.0,
                              final_polish=False)
    return sks_tpu_torch.planar_slam(0, frames, k_mat, cfg, num_corners=64,
                                     num_octaves=1, plane_depth=3.0,
                                     strides=(4, 8), smooth=smooth,
                                     esm_iters=1)


def test_planar_slam_opens_the_closure_esm_and_posegraph_spans(
        sweep, monkeypatch):
    """The closures' fits (their K2 batch, tails and polish) run inside
    ``vo/closure``; each batch's polish in its ``vo/esm``; the relaxation in
    ``vo/posegraph``.  The polish counts its models (one a pair) and those
    the guard kept; the closures at the 12-inlier gate are counted.  The
    relaxation runs one Gauss-Newton step of 2 CG steps here: its length
    does not touch the spans, and its 150 steps would fill the trace."""
    relax = odometry.optimize_posegraph
    monkeypatch.setattr(odometry, "optimize_posegraph",
                        lambda graph, **kw: relax(graph, gn_iters=1,
                                                  cg_iters=2))
    out, spans, counts = _traced(lambda: _slam(sweep))
    edges = _edges(spans)
    e = out["closure_inliers"].shape[0]
    pairs = out["num_inliers"].shape[0] + e
    assert e == 8 and len(_names(spans, "vo/closure")) == 1
    assert len(_names(spans, "vo/esm")) == 2
    assert len(_names(spans, "vo/posegraph")) == 1
    assert {(None, "vo/esm"), ("vo/closure", "vo/esm"),
            ("vo/closure", "ransac/k2"), ("vo/closure", "ransac/tail"),
            ("vo/closure", "vo/pose"), (None, "vo/posegraph")} <= set(edges)
    assert counts["esm.models"] == pairs
    assert 0 <= counts["esm.kept"] <= counts["esm.models"]
    kept = int((out["closure_inliers"] >= odometry.CLOSURE_MIN_INLIERS).sum())
    assert counts["vo.closures_kept"] == kept <= e


def test_planar_slam_counts_nothing_with_no_profiler(sweep):
    profiling.reset_counters()
    _slam(sweep, smooth=False)
    assert profiling.counters() == {}


def test_nothing_is_counted_or_spanned_with_no_profiler():
    assert not torch.autograd._profiler_enabled()
    assert isinstance(profiling.annotate("ransac/fit"),
                      contextlib.nullcontext)
    profiling.reset_counters()
    src, tar = _points(6, 0.2)
    tr.ransac_homography(None, src, tar, CFG)
    tr.ransac_homography_adaptive(
        None, src, tar, dataclasses.replace(CFG, num_hypotheses=16),
        confidence=0.99, max_chunks=4)
    assert profiling.counters() == {}
    profiling.count("ransac.chunks", 3)
    assert profiling.counters() == {}


def test_counters_sum_device_values_after_the_window():
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("ransac/fit") as span:
            assert not isinstance(span, contextlib.nullcontext)
        profiling.count("a")
        profiling.count("a", 2)
        profiling.count("b", torch.tensor(1.5))
        profiling.count("b", torch.tensor(2.0))
        # A mask is summed at the read, not where it is counted.
        profiling.count("c", torch.tensor([True, False, True]))
    assert profiling.counters() == {"a": 3, "b": 3.5, "c": 2}
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_device_trace_counts_its_own_window_alone(tmp_path):
    """A second ``device_trace`` in one process reads its window only."""
    for window in range(2):
        with profiling.device_trace(str(tmp_path / str(window))):
            profiling.count("ransac.chunks", 2)
            profiling.count("ransac.bound", torch.tensor(5.0))
        assert profiling.counters() == {"ransac.chunks": 2,
                                        "ransac.bound": 5.0}
    profiling.reset_counters()
