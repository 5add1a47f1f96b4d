"""Whole runs of every cell on the CPU at a small size, past the harness's
look for a card: the result line's keys, and ``correct`` coming out false
under the lower-precision control and under each fault a cell can have."""

from __future__ import annotations

import json

import pytest
import torch

import sks_tpu_torch
from benchmark import run
from benchmark.core import ref_fit, ref_vo

FIT = {"config": {"n_points": 200, "max_iters": 256},
       "traffic": {"pool": 3, "warmup": 0, "check_sample": 3,
                   "ref_hypotheses": 4096, "trace_requests": 2}}
# At N = 300 a 90% share leaves 30 inliers, too few for a small cap to find
# for sure; the adaptive route is driven at 80% here.
FIT90 = {"config": {"n_points": 300},
         "traffic": {"pool": 2, "warmup": 0, "check_sample": 2,
                     "ref_hypotheses": 16384, "trace_requests": 1,
                     "outlier_share": 0.8,
                     "call": {"confidence": 0.999, "max_iters": 16384}}}
VO = {"config": {"num_frames": 3, "num_hypotheses": 256},
      "traffic": {"pool": 1, "warmup": 0, "check_sample": 1,
                  "ref_hypotheses": 2048, "trace_requests": 1}}
SMALL = {"fit-n2000.o50": FIT, "fit-n2000.o90-adaptive": FIT90,
         "vo-vga.fused": VO}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cell, trace=False, seed=2**31 + 7):
    return run.run_cell(cell, seed, 0.0, trace, device="cpu",
                        overrides=SMALL[cell], log=lambda line: None)


@pytest.mark.parametrize("cell,trace", [
    ("fit-n2000.o50", False), ("fit-n2000.o50", True),
    ("fit-n2000.o90-adaptive", False), ("vo-vga.fused", False),
    ("vo-vga.fused", True)])
def test_result_line_has_the_contract_keys(cell, trace):
    result = _run(cell, trace)
    keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2
    assert all(set(c) == {"value", "limit"}
               for c in result["checks"].values())
    json.dumps(result, allow_nan=False)


def _bf16_fit(src, tar, ransac_reproj_threshold, **kw):
    return ref_fit.fit(src, tar, ransac_reproj_threshold, 4096,
                       torch.Generator().manual_seed(9), torch.bfloat16)


def _bf16_vo(seed, frames, k_mat, config, **kw):
    cfg = {"num_corners": kw["num_corners"], "num_octaves": kw["num_octaves"],
           "threshold_px": config.threshold, "plane_depth": kw["plane_depth"]}
    rel, ninl, _ = ref_vo.poses(frames, k_mat, cfg, 2048,
                                torch.Generator().manual_seed(9),
                                torch.bfloat16)
    return {"rel": rel, "num_inliers": ninl}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(cell, monkeypatch):
    """The reference in bfloat16, the precision below the configuration's
    float32, put in the program's place."""
    if cell.startswith("fit"):
        monkeypatch.setattr(sks_tpu_torch, "find_homography", _bf16_fit)
    else:
        monkeypatch.setattr(sks_tpu_torch, "frames_to_poses", _bf16_vo)
    assert _run(cell)["correct"] is False


def _fit_fault(fault):
    real = sks_tpu_torch.find_homography

    def fit(src, tar, **kw):
        if fault == "half_left_out":
            n = src.shape[0] // 2
            h, mask = real(src[:n], tar[:n], **kw)
            return h, torch.cat([mask, torch.zeros_like(mask)])
        h, mask = real(src, tar, **kw)
        if fault == "answer_altered":
            h = h.clone()
            h[0, 2] += 5.0
        elif fault == "unchanged":
            h, mask = torch.eye(3, dtype=h.dtype), torch.zeros_like(mask)
        return h, mask

    return fit


def _vo_fault(fault):
    real = sks_tpu_torch.frames_to_poses

    def poses(seed, frames, k_mat, config, **kw):
        out = real(seed, frames, k_mat, config, **kw)
        rel, ninl = out["rel"].clone(), out["num_inliers"].clone()
        if fault == "answer_altered":
            rel[0, 0, 3] += 0.05
        elif fault == "half_left_out":
            half = rel.shape[0] // 2
            rel[half:] = torch.eye(4, dtype=rel.dtype)
            ninl[half:] = 0
        return {**out, "rel": rel, "num_inliers": ninl}

    return poses


@pytest.mark.parametrize("cell,fault", [
    ("fit-n2000.o50", "answer_altered"), ("fit-n2000.o50", "half_left_out"),
    ("fit-n2000.o50", "unchanged"),
    ("fit-n2000.o90-adaptive", "answer_altered"),
    ("fit-n2000.o90-adaptive", "half_left_out"),
    ("vo-vga.fused", "answer_altered"), ("vo-vga.fused", "half_left_out")])
def test_a_fault_under_the_timed_path_is_caught(cell, fault, monkeypatch):
    if cell.startswith("fit"):
        monkeypatch.setattr(sks_tpu_torch, "find_homography",
                            _fit_fault(fault))
    else:
        monkeypatch.setattr(sks_tpu_torch, "frames_to_poses",
                            _vo_fault(fault))
    assert _run(cell)["correct"] is False
