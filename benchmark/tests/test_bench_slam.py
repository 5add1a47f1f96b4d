"""Whole runs of the ``slam-vga.esm8`` cell on the CPU at a small size, past
the harness's look for a card: the result line's keys, the cell's per-layer
metrics in a traced run, and ``correct`` coming out false under the
lower-precision control and under each fault the cell can have, the
program's own call with its pose-graph relaxation or its dense polish left
out among them."""

from __future__ import annotations

import json

import pytest
import torch

import sks_tpu_torch
from benchmark import run
from benchmark.core import calls, ref_slam, spec

CELL = "slam-vga.esm8"
LIMITS = spec.resolve(spec.load_spec(), CELL)["traffic"]["limits"]
# 240 x 320 with the VGA cell's field of view: 10 frames, 8 closures.  The
# cell's limits hold here but the polish's: with 2 iterations at half the
# size its edges' median gap reads 6.1e-4 (left out: 4.95e-3), so this size
# takes 2e-3 for it.
SMALL = {"config": {"num_frames": 10, "frame_hw": [240, 320],
                    "focal_px": 150.0, "num_corners": 192,
                    "num_hypotheses": 512, "esm_iters": 2},
         "traffic": {"pool": 1, "warmup": 0, "check_sample": 1,
                     "ref_hypotheses": 2048, "trace_requests": 1,
                     "limits": {**LIMITS, "edge_trans_gap_median": 2e-3}}}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(trace=False, seed=2**31 + 7):
    return run.run_cell(CELL, seed, 0.0, trace, device="cpu",
                        overrides=SMALL, log=lambda line: None)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(trace):
    result = _run(trace)
    keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True
    assert set(result["checks"]) == {
        "requests_checked", "pose_rot_gap_deg", "pose_trans_gap",
        "relax_rot_gap_deg", "relax_trans_gap", "edge_trans_gap_median",
        "inlier_gap", "closure_inlier_gap"}
    if trace:
        # Every metric of the cell reads something, but the device's idle
        # share: a CPU trace holds no device kernel.
        names = {m["name"] for m in spec.resolve(spec.load_spec(),
                                                 CELL)["per_layer"]}
        assert set(result["metrics"]) == names - {"device_idle_share.slam"}
        assert result["metrics"]["closures_kept_per_call.slam"]["value"] == 8
        assert 0 <= result["metrics"]["esm_kept_share.slam"]["value"] <= 100
    else:
        assert set(result["metrics"]) == {"vo_pairs_per_s", "setup_s"}
        # 9 consecutive pairs and 8 closures a call.
        assert result["metrics"]["vo_pairs_per_s"]["value"] > 0
    json.dumps(result, allow_nan=False)


def _bf16_slam(seed, frames, k_mat, config, **kw):
    cfg = {"num_corners": kw["num_corners"], "num_octaves": kw["num_octaves"],
           "threshold_px": config.threshold, "plane_depth": kw["plane_depth"],
           "strides": kw["strides"], "esm_iters": kw["esm_iters"]}
    poses, rel, ninl, ninl_c, rel_c = ref_slam.slam(
        frames, k_mat, cfg, 2048, torch.Generator().manual_seed(9),
        torch.bfloat16)
    return {"poses": poses, "rel": rel, "num_inliers": ninl,
            "closure_inliers": ninl_c, "closure_rel": rel_c}


def test_the_control_is_not_correct(monkeypatch):
    """The reference in bfloat16, the precision below the configuration's
    float32, put in the program's place."""
    monkeypatch.setattr(sks_tpu_torch, "planar_slam", _bf16_slam)
    assert _run()["correct"] is False


def _fault(fault):
    real = sks_tpu_torch.planar_slam

    def slam(seed, frames, k_mat, config, **kw):
        if fault == "relaxation_left_out":
            kw = {**kw, "smooth": False}
        elif fault == "polish_left_out":
            kw = {**kw, "esm_iters": 0}
        out = real(seed, frames, k_mat, config, **kw)
        poses = out["poses"].clone()
        ninl, ninl_c = out["num_inliers"], out["closure_inliers"].clone()
        if fault == "answer_altered":
            poses[5, 0, 3] += 0.1
        elif fault == "scale_drift":
            poses[1:, :3, 3] *= 1.1
        elif fault == "closures_left_out":
            ninl_c[ninl_c.shape[0] // 2:] = 0
        return {**out, "poses": poses, "num_inliers": ninl,
                "closure_inliers": ninl_c}

    return slam


#: Each fault and the numbers that must miss their limits under it.
MISSES = {"answer_altered": {"pose_trans_gap", "relax_trans_gap"},
          "scale_drift": {"pose_trans_gap", "relax_trans_gap"},
          "closures_left_out": {"closure_inlier_gap", "relax_trans_gap"},
          "relaxation_left_out": {"relax_rot_gap_deg", "relax_trans_gap"},
          "polish_left_out": {"edge_trans_gap_median"}}


@pytest.mark.parametrize("fault", list(MISSES))
def test_a_fault_under_the_timed_path_is_caught(fault, monkeypatch):
    monkeypatch.setattr(sks_tpu_torch, "planar_slam", _fault(fault))
    result = _run()
    assert result["correct"] is False
    missed = {name for name, c in result["checks"].items()
              if c["value"] > c["limit"]}
    assert MISSES[fault] <= missed, (fault, result["checks"])


def test_a_program_without_closure_measurements_stops_at_set_up(
        monkeypatch):
    """The relaxation's check needs ``closure_rel``: a program that does not
    return it (this cell's parent) ends the run at the warm-up call, before
    the window, rather than read correct or not."""
    real = sks_tpu_torch.planar_slam

    def slam(*args, **kw):
        out = real(*args, **kw)
        del out["closure_rel"]
        return out

    monkeypatch.setattr(sks_tpu_torch, "planar_slam", slam)
    small = {**SMALL, "traffic": {**SMALL["traffic"], "warmup": 1}}
    with pytest.raises(RuntimeError, match="closure_rel"):
        run.run_cell(CELL, 2**31 + 7, 0.0, False, device="cpu",
                     overrides=small, log=lambda line: None)


class _View:
    """The host events of a trace, as ``TraceView`` keeps them."""

    def __init__(self, host):
        self.host = sorted(host)

    def span_ms(self, *names):
        return sum(e - s for s, e, n in self.host if n in names) / 1e6


def test_the_vo_span_readers_count_per_call():
    view = _View([(0, 4_000_000, "vo/posegraph"), (1, 2, "cudaLaunchKernel"),
                  (3, 4, "cudaMemcpyAsync"), (5, 6, "cudaLaunchKernel"),
                  (5_000_000, 7_000_000, "vo/posegraph"),
                  (5_000_001, 5_000_002, "cuLaunchKernel"),
                  (5_000_003, 5_000_004, "aten::mul"),
                  (8_000_000, 8_000_001, "cudaLaunchKernel")])
    run_ = {"requests": 2}
    assert calls.launches(view, "vo/posegraph") == 4
    assert calls.per_call(run_, calls.launches(view, "vo/posegraph")) == 2.0
    assert calls.span_ms_per_call(view, run_, "vo/posegraph") == 3.0
    assert calls.launches(view, "vo/closure") is None
    assert calls.span_ms_per_call(view, run_, "vo/closure") is None
