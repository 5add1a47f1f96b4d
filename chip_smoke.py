#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU, and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's hand-written CUDA kernels from ``sks_tpu_torch/csrc``
(``nvcc``, sm_90a), holds each against its plain PyTorch version at the main
path's shapes, drives the main path (the batched 4-point solve of all six
solvers of the paper's Table 8 in float32 and in float64, ``find_homography``
with the ACA, SKS and RHO-GE solvers on float32 points and with ACA and SKS
on float64 points, and the general path with float64 scoring) through the
kernels with the launch counters reset, checks the results against the
synthetic truth, holds the CUDA paths against the port's general path on the
CPU, and times kernels and path with CUDA events (the port's Table 8, float32
and float64, beside the reference's CUDA fp64 times).

A second path, with the counters reset again: the confidence early-exit loop
(``find_homography(confidence=...)``: eager chunks through K1, float64 ones
through K5, fused stages through K2), PROSAC sampling and a batched
early-exit fit; then the per-chunk fused-versus-eager table behind
``FUSED_ADAPTIVE_MIN_CHUNK`` (``sks_tpu_torch/bench/fused_adaptive.py``), and
the rectangle solvers and the SKS / ACA factorizations on CUDA tensors.

A third path, counters reset again: the planar-VO pipeline on frames
rendered on the card (``frames_to_poses`` on the fused route, one K2 launch
for all pairs, and on the general route, K1 once a pair; ``planar_slam``
with and without the pose graph), its trajectories against the truth and
against the same fused call on CPU tensors, K2 replayed on the inputs of
each of its launches against the plain version and timed at the pipeline's
shape; then its pairs/s in device and host time, with the stage split and
the device's idle share from one trace of each entry point
(``sks_tpu_torch/bench/pipeline_fps.py``).

A fourth, counters reset again: the learned models (``sks_tpu_torch.models``)
at full width, the four solver heads' H and gradients and both networks'
forwards on the card against the CPU, each network trained 300 steps with
its held-out MACE before and after; no kernel of the repo launches there.

Then the multi-device layer (``sks_tpu_torch.parallel``), counters reset
again (``launches_sharded``): a world-size-1 NCCL group on the card, every
sharded form (RANSAC general and fused, NDLT, HO, a BA step, the pose
graph, ``sharded_frames_to_poses``, ``sharded_planar_slam``) against its
single-device form, each K2 launch against its plain version,
``bench/ba_scale.py`` at 20 x 10,240, and, where gloo takes CUDA tensors,
``sharded_frames_to_poses`` at world size 2 on the one card (two processes
of this script, ``--gloo-rank``) against world size 1.

A fifth, counters reset again (``launches_real``): the headline
(``sks_tpu_torch/bench/headline.py``: K1's homographies/s at B = 2^20 and
6 x 2^20, float32 and bfloat16 storage, each rate's share of the card's
memory bandwidth), the image-grounded benchmark
(``sks_tpu_torch/bench/real_pipeline.py``: rendered pairs scored against
their true H, a VO sequence's ATE, loop closures, one fit against the CPU;
K2 once a fit) and ``sks_tpu_torch/bench/wall_real.py`` on the synthetic
wall fixture (the reference's real matches are not in the repository).

It also holds the Jacobi rotation's hand-written square root and reciprocal
against the IEEE ones on every float32 of their range, and its division of
tiny numerators on 2^28 pairs, and times, as yardsticks that the port never
calls, the PyTorch calls that do the dominant step of NDLT, HO and GPT.

Output: one JSON line per phase; then the card's name and power limit as
``nvidia-smi`` prints them; then a JSON line with every kernel's route, source,
launches on the main path, the adaptive path, the pipeline, the sharded
phase and the real paths,
error against
its plain version, times and bound
(``sks_tpu_torch/bench/roofline.py``); and last
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without the last line.  Without a CUDA device, or outside the
repository, it exits non-zero at once.  Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line for a phase, with the seconds since the script began."""
    print(json.dumps({"phase": phase,
                      "at_s": round(time.perf_counter() - START, 1), **fields}),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


#: The per-pair tail's kernels: every float32 fit on the card launches the
#: IRLS refit of its top-K candidates and the polish of its model once each.
TAIL_KERNELS = ("irls_refine", "anneal_polish")


def without_tail(made: dict) -> dict:
    """Launch counts without the tail's kernels (``TAIL_KERNELS``): the rest
    says which solve and score kernels a path ran."""
    return {k: v for k, v in made.items() if k not in TAIL_KERNELS}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def paired_ms(kernel, plain, runs: int = 25, reps: int = 10):
    """Median device ms per call of a kernel and of its plain version, timed
    in turns (plain, kernel, kernel, plain, ...) after a warm-up."""
    import torch

    from sks_tpu_torch.bench.table8 import device_ms

    for _ in range(3):
        kernel()
        plain()
    torch.cuda.synchronize()
    tk, tp = [], []
    for i in range(runs):
        order = ((kernel, tk), (plain, tp)) if i % 2 else ((plain, tp),
                                                           (kernel, tk))
        for fn, acc in order:
            acc.append(device_ms(fn, reps))
    return statistics.median(tk), statistics.median(tp)


def ptxas_entries(log: str) -> list[dict]:
    """Each kernel's registers, static shared memory and spills from
    ``nvcc -Xptxas -v`` output."""
    out, source = [], None
    for ln in log.splitlines():
        if ln.startswith("== "):
            source = ln[3:].strip()
        elif "Compiling entry function" in ln:
            out.append({"source": source, "entry": ln.split("'")[1]})
        elif out and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out[-1]["stack_bytes"], out[-1]["spill_store_bytes"], \
                out[-1]["spill_load_bytes"] = nums[:3]
        elif out and "Used" in ln and "registers" in ln:
            out[-1]["registers"] = int(ln.split("Used")[1].split()[0])
            out[-1]["static_smem_bytes"] = (
                int(ln.split("bytes smem")[0].split()[-1])
                if "bytes smem" in ln else 0)
    return out


# One train step on the card against the CPU (``models_phase``): the largest
# gradient and update gaps over the parameter tensors, each over the CPU's
# norm; ~10x the largest readings on an H100, gradients 1.7e-6 (CNN) and
# 8.0e-7 (IHN), updates 4.7e-4 and 2.3e-5.
STEP_GRAD_TOL = 2e-5
STEP_UPDATE_TOL = 5e-3


def models_phase(torch, dev, check) -> dict:
    """The learned models at full width on the card (``sks_tpu_torch.models``).

    Heads: all four, H and the gradient of a fixed random weighting of H to
    the offsets, B = 64, on the card against the CPU: float64 within 1e-9 of
    the largest entry; float32 H and its gradient within 1e-4.  Models:
    ``HomographyNet`` and the IHN (dim 64, 6 iterations) built on the card
    from seeded generators; a forward of 32 held-out pairs (64 x 64) against
    the same weights on the CPU within 1e-5 of the largest offset (TF32
    convs round to 10 mantissa bits, ~1e-3).  One train step of each at
    batch 16 on the card and on the CPU from the same weights and fresh
    Adam: each
    parameter's gradient and its update (after minus before), card against
    CPU, over the CPU's norm of it, within STEP_GRAD_TOL and STEP_UPDATE_TOL
    (a skipped step is 1 away, a reversed one 2).  Each then trained 300
    steps at batch 64 on fresh batches rendered on the card, then one step
    under ``set_sync_debug_mode("error")``: held-out MACE on 256 pairs from
    a generator of their own must fall, everything finite.  Times: the
    training loop's device span and host time a step (its batch renders
    included); one traced forward and one traced train step: their kernels,
    the device's busy ms (their device time) and the step's idle share
    (``bench/models_mace.step_trace``).
    """
    from sks_tpu_torch import models as M
    from sks_tpu_torch.bench.models_mace import mace, step_trace, train
    from sks_tpu_torch.models.deep_homography import (
        TrainState,
        synth_training_batch,
    )

    def gap(a, b):
        return ((a.cpu().double() - b.cpu().double()).abs().max()
                / b.cpu().double().abs().max()).item()

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def norm_gap(a, b):
        b = b.double()
        return ((a.cpu().double() - b).norm() / b.norm()).item()

    def step_gaps(model, state, twin, step, pair, off):
        """Largest gradient and update gaps over the parameter tensors of
        one step on the card and on the CPU."""
        before = [p.detach().clone() for p in model.parameters()]
        step(model, state, pair, off)
        step(twin, TrainState.create(twin), pair.cpu(), off.cpu())
        grads, updates = [], []
        for p, q, p0 in zip(model.parameters(), twin.parameters(), before):
            grads.append(norm_gap(p.grad, q.grad))
            updates.append(norm_gap(p.detach() - p0, q.detach() - p0.cpu()))
        return max(grads), max(updates)

    out = {"batch": 64, "image_size": 64, "eval_batch": 256, "steps": 300,
           "heads": {}}
    t_phase = time.perf_counter()
    g = gen(9)
    for dt, tol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        origin = torch.rand((64, 2), generator=g, device=dev, dtype=dt) * 64
        size = 32 + torch.rand((64, 2), generator=g, device=dev,
                               dtype=dt) * 96
        offsets = (torch.rand((64, 4, 2), generator=g, device=dev, dtype=dt)
                   - 0.5) * 32
        weights = torch.randn((64, 3, 3), generator=g, device=dev, dtype=dt)
        for method in sorted(M.HEAD_METHODS):
            runs = []
            for where in (dev, torch.device("cpu")):
                o = offsets.to(where).detach().clone().requires_grad_()
                h = M.offsets_to_h(o, origin.to(where), size.to(where),
                                   method)
                torch.sum(h * weights.to(where)).backward()
                runs.append((h.detach(), o.grad))
            (h_g, g_g), (h_c, g_c) = runs
            row = {"h_gap": gap(h_g, h_c), "grad_gap": gap(g_g, g_c),
                   "finite": bool(torch.isfinite(h_g).all()
                                  and torch.isfinite(g_g).all())}
            out["heads"][f"{method}_{str(dt)[6:]}"] = row
            check(row["finite"] and row["h_gap"] <= tol
                  and row["grad_gap"] <= tol,
                  f"models: head {method} {dt} card vs CPU {row}")

    pair_ev, off_ev = synth_training_batch(gen(5), 256)
    models = (
        ("cnn", M.create_train_state(gen(1), device=dev), M.HomographyNet(),
         M.train_step, lambda m, p: m(p)),
        ("ihn", M.create_ihn_state(gen(2), device=dev),
         M.IterativeHomographyNet(), M.ihn_train_step,
         lambda m, p: m(p)[-1]),
    )
    for name, (model, state), twin, step, predict in models:
        twin.load_state_dict({k: v.cpu() for k, v in
                              model.state_dict().items()})
        with torch.no_grad():
            forward_gap = gap(model(pair_ev[:32]), twin(pair_ev[:32].cpu()))
            before = mace(predict(model, pair_ev), off_ev).item()
        grad_gap, update_gap = step_gaps(model, state, twin, step,
                                         *synth_training_batch(gen(7), 16))
        data = gen(6)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        loss = train(step, model, state, data, out["steps"], 64, 64)
        ev1.record()
        ev1.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / out["steps"]
        pair, off = synth_training_batch(data, 64)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, checked_loss = step(model, state, pair, off)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        with torch.no_grad():
            after = mace(predict(model, pair_ev), off_ev).item()
            forward = step_trace(lambda: model(pair))
        traced = step_trace(lambda: step(model, state, pair, off))
        row = {"forward_card_vs_cpu": forward_gap,
               "step_grad_card_vs_cpu": grad_gap,
               "step_update_card_vs_cpu": update_gap,
               "mace_untrained_px": before, "mace_trained_px": after,
               "final_train_loss": loss.item(),
               "checked_step_loss": checked_loss.item(),
               "train_device_ms_per_step": ev0.elapsed_time(ev1)
               / out["steps"],
               "train_host_ms_per_step": host_ms,
               "forward_device_ms": forward["busy_ms"],
               "forward_kernels": forward["device_kernels"],
               "step_device_ms": traced["busy_ms"],
               "step_kernels": traced["device_kernels"],
               "step_idle_share": traced["idle_share"]}
        out[name] = row
        check(forward_gap <= 1e-5 and grad_gap <= STEP_GRAD_TOL
              and update_gap <= STEP_UPDATE_TOL and after < before
              and all(math.isfinite(v) for v in row.values()),
              f"models: {name} {row}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# The image-grounded phases (``real_paths``): the largest ground-truth corner
# error of an easy pair (the absolute ceiling of the JAX package's gate,
# tests/test_photo_pipeline.py), the bandwidth fraction above which a
# headline reading is a timing fault, and the synthetic fixture's true
# inliers (sks_tpu_torch/data/fixture.py: 2,000 matches, 15% outliers).
EASY_CORNER_ERR_PX = 1.5
MAX_BANDWIDTH_FRACTION = 1.05
FIXTURE_TRUE_INLIERS = 1700


def real_paths(torch, dev, check, smi, emit) -> dict:
    """The headline, the image-grounded benchmark and the wall fixture on the
    card; returns each kernel's launches across the three phases.

    ``headline``: ``bench/headline.py`` (K1 at B = 2^20 and 6 x 2^20, float32
    and bfloat16 storage, device time); every bandwidth fraction at most
    MAX_BANDWIDTH_FRACTION of the card's spec.  ``real_pipeline``
    (``bench/real_pipeline.py`` at its own shapes): ``pair_parity`` on 8 easy
    and 4 parallax pairs at (480, 640), every scored easy pair under
    EASY_CORNER_ERR_PX against the true H; ``sequence_ate`` on 12 frames
    under 0.12 x the path length + 0.02; ``loop_closure_ate`` on 16 frames,
    closures under 0.95 x the raw chain's ATE; one pair's fit on the card
    (fused, K2) against the same matches and minimal sets on the CPU (the
    general path): the same inliers, H within 1e-4 after Frobenius
    normalization; K2 launched once a fit.  ``wall_real_synth``:
    ``bench/wall_real.py`` on the synthetic fixture: float64 medians under
    1e-6 px, finite fractions at least 0.99, and ``robust_parity``'s inliers
    within 5% of the fixture's true ones.
    """
    from sks_tpu_torch.bench import headline, real_pipeline, wall_real
    from sks_tpu_torch.data.fixture import load_correspondences
    from sks_tpu_torch.data.images import planar_pair
    from sks_tpu_torch.features.matching import match_frames_oriented
    from sks_tpu_torch.geom.homography import normalize_h
    from sks_tpu_torch.kernels import LAUNCHES
    from sks_tpu_torch.robust import find_homography
    from sks_tpu_torch.robust.ransac import RansacConfig, _sample_chunk
    from sks_tpu_torch.utils.streams import pair_generators

    torch.cuda.synchronize()
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    seen = dict(LAUNCHES)

    def made():
        out = {k: LAUNCHES[k] - seen[k] for k in LAUNCHES
               if LAUNCHES[k] != seen[k]}
        seen.update(LAUNCHES)
        return out

    # ---- headline ----
    t0 = time.perf_counter()
    head = headline.run()
    fractions = {k: v for k, v in head.items()
                 if k.startswith("roofline_fraction")}
    check(math.isfinite(head["value"]) and head["value"] > 0
          and head["hbm_spec_gbps"] is not None and len(fractions) == 3,
          f"headline: {head}")
    check(all(v <= MAX_BANDWIDTH_FRACTION for v in fractions.values()),
          f"headline: a bandwidth fraction above {MAX_BANDWIDTH_FRACTION} of "
          f"the spec is a timing fault: {fractions}")
    emit("headline", card=smi, seconds=time.perf_counter() - t0,
         launches=made(), **head)

    # ---- real_pipeline ----
    t0 = time.perf_counter()
    easy = real_pipeline.pair_parity(0, 8, device=dev)
    parallax = real_pipeline.pair_parity(0, 4, protocol="parallax",
                                         device=dev)
    fits = sum(1 for r in easy + parallax if "skipped" not in r)
    seq = real_pipeline.sequence_ate(0, 12, device=dev)
    loop = real_pipeline.loop_closure_ate(0, 16, device=dev)
    # One easy pair, card against CPU on the same matches and draws.
    g_render = pair_generators(1, 1, device=dev)[0]
    img1, img2, _ = planar_pair(g_render, (480, 640))
    p1, p2, valid, _ = match_frames_oriented(img1, img2, 512, 3)
    center = torch.tensor([320.0, 240.0], device=dev)
    p1 = torch.where(valid[..., None], p1, center)
    p2 = torch.where(valid[..., None], p2, center)
    idx = _sample_chunk(torch.Generator(device=dev).manual_seed(3),
                        p1.shape[0], RansacConfig(num_hypotheses=2048), None,
                        valid)
    h_card, m_card = find_homography(p1, p2, point_mask=valid, indices=idx,
                                     max_iters=2048)
    h_cpu, m_cpu = find_homography(p1.cpu(), p2.cpu(),
                                   point_mask=valid.cpu(), indices=idx.cpu(),
                                   max_iters=2048)
    card_vs_cpu = {
        "matches": int(valid.sum()),
        "inliers_card": int(m_card.sum()), "inliers_cpu": int(m_cpu.sum()),
        "same_mask": torch.equal(m_card.cpu(), m_cpu),
        "h_max_fro_diff": (normalize_h(h_card.cpu(), "fro")
                           - normalize_h(h_cpu, "fro")).abs().max().item(),
        "bound": 1e-4}
    launches = made()
    summary = {"easy": real_pipeline._summarize(easy),
               "parallax": real_pipeline._summarize(parallax)}
    rp = {"seconds": time.perf_counter() - t0, "launches": launches,
          "easy": easy, "parallax": parallax, "summary": summary,
          "sequence": seq, "loop_closure": loop, "card_vs_cpu": card_vs_cpu}
    scored = [r for r in easy if "skipped" not in r]
    check(len(scored) >= 6 and all(r["corner_err_ours_px"] < EASY_CORNER_ERR_PX
                                   for r in scored),
          f"real_pipeline: easy pairs' corner error: {summary['easy']}")
    check(all(math.isfinite(r["corner_err_ours_px"])
              and "offplane_inlier_leak_ours" in r
              for r in parallax if "skipped" not in r),
          f"real_pipeline: parallax rows: {parallax}")
    check(seq["ate_rmse"] < 0.12 * seq["path_length"] + 0.02,
          f"real_pipeline: sequence ATE: {seq}")
    check(loop["ate_smooth_with_closures"] < 0.95 * loop["ate_odometry"],
          f"real_pipeline: closures must cut the ATE: {loop}")
    check(card_vs_cpu["same_mask"]
          and card_vs_cpu["inliers_card"] == card_vs_cpu["inliers_cpu"]
          and card_vs_cpu["h_max_fro_diff"] <= 1e-4,
          f"real_pipeline: card vs CPU: {card_vs_cpu}")
    # K2 once a pair fit, once a sequence_ate, 1 + 1 + 2 in
    # loop_closure_ate, once the card-versus-CPU fit; nothing else but the
    # tail's kernels, at least once behind each K2 launch (once a pair).
    check(without_tail(launches) == {"aca_solve_score": fits + 1 + 4 + 1}
          and all(launches.get(k, 0) >= fits + 1 + 4 + 1
                  for k in TAIL_KERNELS),
          f"real_pipeline launches: {launches}, {fits} pair fits")
    emit("real_pipeline", card=smi, **rp)

    # ---- wall_real_synth: the synthetic fixture, not the real matches ----
    t0 = time.perf_counter()
    wsrc, wtar = load_correspondences()
    acc = wall_real.solver_accuracy(wsrc, wtar, device=dev)
    thr = wall_real.throughput_real(wsrc, wtar, device=dev)
    par = wall_real.robust_parity(wsrc, wtar, device=dev)
    launches = made()
    check(all(row["f64_median_px"] < 1e-6 and row["finite_frac"] >= 0.99
              and row["f64_finite_frac"] >= 0.99 for row in acc.values()),
          f"wall_real_synth: solver accuracy: {acc}")
    check(abs(par["inliers_ours"] - FIXTURE_TRUE_INLIERS)
          <= 0.05 * FIXTURE_TRUE_INLIERS,
          f"wall_real_synth: robust parity: {par}")
    check(math.isfinite(thr["h_per_s"]) and launches.get("aca_solve", 0) >= 1
          and launches.get("aca_solve_score") == 1,
          f"wall_real_synth: {thr}, launches {launches}")
    emit("wall_real_synth", card=smi, data="synthetic fixture "
         "sks_tpu_torch/data/wall_synth.txt (GT_H, 15% outliers)",
         seconds=time.perf_counter() - t0, launches=launches,
         solver_accuracy=acc, throughput_real=thr, robust_parity=par)
    return dict(LAUNCHES)


# The sharded phase's bounds against the single-device forms on the card.
# RANSAC, frames_to_poses: the same fits (same streams, same launches per
# pair).  NDLT / HO: the single forms sum in another order (HO's eigensolver
# is the closed form there, Jacobi here).  BA: float64, the 1e12 gauge
# carries a reordered sum to ~1e-8 of the largest entry
# (tests/test_torch_parallel.py).  Pose graph: the CG bound of
# tests/test_torch_posegraph.py.  planar_slam: its one batch of every pair
# polishes in one ESM batch (the single form: two), which the card sums in
# another order (the esm phase's batch-vs-single gap): the pipeline's
# card-vs-CPU bound.
SHARDED_REFINE_TOL = 1e-5
SHARDED_BA_TOL = 1e-7
SHARDED_PG_TOL = 1e-4
SHARDED_F2P_TOL = 1e-5
SHARDED_SLAM_TOL = 5e-3


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ring_graph(torch, dev, n=32, drift=0.05):
    """An odometry ring of n poses with the loop closed, its initial poses
    drifted by noisy odometry (float64, on the card)."""
    from sks_tpu_torch.geom.lie import se3_exp
    from sks_tpu_torch.slam.posegraph import PoseGraph, _inv_se3

    g = torch.Generator(device=dev).manual_seed(12)
    ang = torch.arange(n, dtype=torch.float64, device=dev) * (2 * math.pi / n)
    z = torch.zeros_like(ang)
    gt = se3_exp(torch.stack([ang.cos(), ang.sin(), z, z, z, ang], -1))
    edges = torch.stack([torch.arange(n, device=dev),
                         torch.arange(n, device=dev).roll(-1)], -1)
    meas = _inv_se3(gt[edges[:, 0]]) @ gt[edges[:, 1]]
    noise = se3_exp(torch.randn((n, 6), generator=g, dtype=torch.float64,
                                device=dev) * drift)
    poses = [gt[0]]
    for i in range(1, n):
        poses.append(poses[-1] @ meas[i - 1] @ noise[i])
    return PoseGraph(torch.stack(poses), edges, meas,
                     torch.ones(n, dtype=torch.float64, device=dev))


def gloo_rank(rank: int, port: int) -> int:
    """One rank of the two-rank gloo group on the one card: the fused
    ``sharded_frames_to_poses`` of the sharded phase's world-2 check; rank 0
    prints its result as JSON."""
    import torch

    sys.path.insert(0, ROOT)
    os.environ["LOCAL_RANK"] = str(rank)
    from sks_tpu_torch.bench import pipeline_fps
    from sks_tpu_torch.data.images import planar_sequence
    from sks_tpu_torch.parallel import initialize_multihost, make_mesh
    from sks_tpu_torch.slam.pipeline import sharded_frames_to_poses

    initialize_multihost(f"localhost:{port}", 2, rank, "cuda", backend="gloo",
                         timeout=120)
    dev = torch.device("cuda", 0)
    frames, _, k_mat = planar_sequence(
        torch.Generator(device=dev).manual_seed(16), 16, (240, 320))
    out = sharded_frames_to_poses(
        make_mesh({"frame": -1}), torch.Generator(device=dev).manual_seed(5),
        frames[:15], k_mat, pipeline_fps.config(True), num_corners=384,
        num_octaves=2, plane_depth=3.0)
    if rank == 0:
        print(json.dumps({k: v.tolist() for k, v in out.items()}), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def sharded_phase(torch, dev, check, smi, emit, vo_runs, ransac_problem,
                  seq_gen, cfg_fused, vo_kw):
    """The multi-device layer (``sks_tpu_torch.parallel``) on a world-size-1
    NCCL group on the card; returns (each kernel's launches, K2's largest
    gap to its plain version on the phase's launches).

    With the counters at 0, every sharded form once: RANSAC (ACA, N = 2,000,
    50% outliers, 2,048 hypotheses; general, through K1, and fused, K2);
    NDLT and HO on the same matches, weighted by the true inliers; one BA
    step at 20 x 10,240 in float64; the pose graph of a 32-pose ring;
    ``sharded_frames_to_poses`` at T = 16, (240, 320), fused (one K2
    launch); ``sharded_planar_slam`` with its default ESM polish (one K2
    launch for the consecutive and closure pairs); ``bench/ba_scale.run()``
    in float64 (held: converged, RMS < 0.6 px) and float32 (reported).  Then
    each against its single-device form on the card (the pipeline phase's
    runs of ``frames_to_poses`` and ``planar_slam`` on the same frames and
    generators), and each K2 launch replayed against its plain version
    (inliers bit-equal).  Last, whether gloo takes CUDA tensors; if it does,
    the fused ``sharded_frames_to_poses`` on 15 frames at world size 2 (two
    processes on the one card) against world size 1.
    """
    import dataclasses

    import torch.distributed as dist

    from sks_tpu_torch.bench import ba_scale
    from sks_tpu_torch.geom.homography import normalize_h
    from sks_tpu_torch.kernels import aca_cuda as K
    from sks_tpu_torch.ops.ho import ho_h
    from sks_tpu_torch.ops.ndlt import ndlt_h
    from sks_tpu_torch.parallel import (
        initialize_multihost,
        make_mesh,
        shard_graph,
        sharded_ho_h,
        sharded_ndlt_h,
        sharded_optimize_posegraph,
        sharded_ransac_homography,
    )
    from sks_tpu_torch.parallel import sharded_ransac as SR
    from sks_tpu_torch.parallel.sharded_ba import (
        gather_problem,
        shard_problem,
        sharded_gauss_newton_step,
    )
    from sks_tpu_torch.robust import ransac as R
    from sks_tpu_torch.robust.ransac import (
        RansacConfig,
        ransac_homography,
        sample_minimal_sets,
    )
    from sks_tpu_torch.slam.ba import gauss_newton_step, synth_ba_problem
    from sks_tpu_torch.slam.pipeline import (
        sharded_frames_to_poses,
        sharded_planar_slam,
    )
    from sks_tpu_torch.slam.posegraph import optimize_posegraph
    from sks_tpu_torch.utils.streams import pair_generators

    def fro(h):
        return normalize_h(h.double(), "fro")

    initialize_multihost(f"localhost:{free_port()}", 1, 0, "cuda",
                         timeout=300)
    row = {"backend": dist.get_backend(), "world_size": dist.get_world_size()}
    check(row == {"backend": "nccl", "world_size": 1},
          f"sharded: the group is not NCCL at world size 1: {row}")
    k2_launched, wrappers = [], (R.aca_solve_score_soa, SR.aca_solve_score_soa)

    def k2_recorded(*args, **kwargs):
        k2_launched.append((args, kwargs))
        return wrappers[0](*args, **kwargs)

    src, tar, _, true_inl = ransac_problem
    w_inl = true_inl.float()
    cfg = RansacConfig(num_hypotheses=2048, threshold=3.0)
    _, ba_init = synth_ba_problem(torch.Generator(device=dev).manual_seed(0),
                                  dtype=torch.float64)
    graph = ring_graph(torch, dev)
    frames_s, frames_c = vo_runs["fused"][0], vo_runs["planar_slam_esm"][0]
    try:
        torch.cuda.synchronize()
        for name in K.LAUNCHES:
            K.LAUNCHES[name] = 0
        R.aca_solve_score_soa = SR.aca_solve_score_soa = k2_recorded
        t0 = time.perf_counter()
        try:
            hyp = make_mesh({"hyp": -1})
            fits = {route: sharded_ransac_homography(
                hyp, 11, src, tar, cfg, fused=route == "fused")
                for route in ("general", "fused")}
            pts = make_mesh({"pts": -1})
            refine = {"ndlt": sharded_ndlt_h(pts, src, tar, w_inl),
                      "ho": sharded_ho_h(pts, src, tar, w_inl)}
            lm = make_mesh({"lm": -1})
            ba_step = gather_problem(sharded_gauss_newton_step(
                lm, shard_problem(ba_init, lm), 1e-4), lm)
            edge = make_mesh({"edge": -1})
            pg = sharded_optimize_posegraph(edge, shard_graph(graph, edge))
            f2p = sharded_frames_to_poses(
                make_mesh({"frame": -1}), seq_gen(5), frames_s[0],
                frames_s[2], cfg_fused, **vo_kw)
            slam = sharded_planar_slam(
                make_mesh({"pair": -1}), seq_gen(6), frames_c[0],
                frames_c[2], cfg_fused, strides=(4, 8), **vo_kw)
            scale = {str(dt)[6:]: ba_scale.run(dtype=dt)
                     for dt in (torch.float64, torch.float32)}
            torch.cuda.synchronize()
        finally:
            R.aca_solve_score_soa, SR.aca_solve_score_soa = wrappers
        row["seconds"] = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        row["launches"] = {k: v for k, v in launches.items() if v}
        check(without_tail(row["launches"])
              == {"aca_solve": 1, "aca_solve_score": 3}
              and row["launches"].get("irls_refine", 0) >= 2,
              f"sharded: K1 once (general RANSAC), K2 once for each of the "
              f"fused RANSAC, frames_to_poses and planar_slam, the IRLS "
              f"refit behind each fit: {row}")

        # Against the single-device forms on the card.
        idx = sample_minimal_sets(pair_generators(11, 1, device=dev)[0],
                                  src.shape[0], 2048)
        for route, fit in fits.items():
            one = ransac_homography(None, src, tar, dataclasses.replace(
                cfg, fused=route == "fused"), indices=idx)
            row[f"ransac_{route}"] = {
                "num_inliers": int(fit.num_inliers),
                "h_gap": (fro(fit.h) - fro(one.h)).abs().max().item(),
                "masks_equal": torch.equal(fit.inlier_mask, one.inlier_mask)}
            check(row[f"ransac_{route}"]["masks_equal"]
                  and row[f"ransac_{route}"]["h_gap"] <= 1e-6,
                  f"sharded RANSAC ({route}) against the single fit: {row}")
        for name, one in (("ndlt", ndlt_h(src, tar, w_inl)),
                          ("ho", ho_h(src, tar, w_inl))):
            row[f"{name}_gap"] = (fro(refine[name]) - fro(one)).abs().max(
            ).item()
            check(row[f"{name}_gap"] <= SHARDED_REFINE_TOL,
                  f"sharded {name} against the single form: {row}")
        one = gauss_newton_step(ba_init, 1e-4)
        for field in ("poses", "points"):
            want = getattr(one, field)
            row[f"ba_{field}_gap"] = ((getattr(ba_step, field) - want).abs()
                                      .max() / want.abs().max()).item()
            check(row[f"ba_{field}_gap"] <= SHARDED_BA_TOL,
                  f"sharded BA step against the single step: {row}")
        row["posegraph_gap"] = (pg.poses - optimize_posegraph(graph).poses
                                ).abs().max().item()
        check(row["posegraph_gap"] <= SHARDED_PG_TOL,
              f"sharded pose graph against the single form: {row}")
        for name, got, run_, tol in (
                ("frames_to_poses", f2p, "fused", SHARDED_F2P_TOL),
                ("planar_slam", slam, "planar_slam_esm", SHARDED_SLAM_TOL)):
            want = vo_runs[run_][1]
            gaps = {k: (got[k].long() - want[k].long()).abs().max().item()
                    for k in ("num_inliers", "closure_inliers") if k in want}
            row[name] = {"pose_gap": (got["poses"] - want["poses"]).abs()
                         .max().item(), "num_inliers_gaps": gaps,
                         "num_inliers": got["num_inliers"].tolist()}
            exact = tol == SHARDED_F2P_TOL
            check(row[name]["pose_gap"] <= tol
                  and max(gaps.values()) <= (0 if exact else 2),
                  f"sharded {name} against the single form: {row}")
        row["ba_scale"] = scale
        f64 = scale["float64"]
        check(f64["converged"] and f64["rms_reprojection_px"][-1] < 0.6
              and f64["devices"] == 1 and f64["points"] == 10_240,
              f"ba_scale (float64) did not converge: {f64}")

        # Each K2 launch of the phase, replayed against its plain version.
        k2_err, replays = 0.0, []
        for args, kwargs in k2_launched:
            sk = K.aca_solve_score_soa(*args, **kwargs)
            sp = K.aca_solve_score_soa_plain(*args, **kwargs)
            gap = (sk - sp).abs().max().item()
            k2_err = max(k2_err, gap)
            replays.append({"shape": list(args[0].shape), "N": args[2].shape[-1],
                            "equal": torch.equal(sk, sp), "max_abs_diff": gap})
            check(torch.equal(sk, sp), f"K2 differs from plain on the sharded "
                  f"phase's inputs: {replays}")
        row["k2_replays"] = replays

        # gloo on CUDA tensors: a separate check, never a fallback.
        gl = dist.new_group(backend="gloo")
        x = torch.arange(4.0, device=dev)
        try:
            dist.all_reduce(x, group=gl)
            parts = [torch.empty_like(x)]
            dist.all_gather(parts, x, group=gl)
            row["gloo_cuda_tensors"] = True
        except Exception as exc:  # reported: gloo refused CUDA tensors
            row["gloo_cuda_tensors"] = repr(exc)[:300]
        if row["gloo_cuda_tensors"] is True:
            mesh1 = make_mesh({"frame": -1})
            one = sharded_frames_to_poses(mesh1, seq_gen(5), frames_s[0][:15],
                                          frames_s[2], cfg_fused, **vo_kw)
            port, t1 = free_port(), time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--gloo-rank",
                 str(r), str(port)], stdout=subprocess.PIPE, text=True,
                cwd=ROOT) for r in range(2)]
            try:
                outs = [p.communicate(timeout=240)[0] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            check(all(p.returncode == 0 for p in procs),
                  f"the world-2 gloo ranks failed: {[p.returncode for p in procs]}")
            two = json.loads(outs[0].strip().splitlines()[-1])
            row["world2_gloo"] = {
                "seconds": time.perf_counter() - t1,
                "num_inliers": two["num_inliers"],
                "pose_gap": (torch.tensor(two["poses"], device=dev)
                             - one["poses"]).abs().max().item()}
            check(two["num_inliers"] == one["num_inliers"].tolist()
                  and row["world2_gloo"]["pose_gap"] <= SHARDED_F2P_TOL,
                  f"frames_to_poses at world 2 (gloo) against world 1: {row}")
    finally:
        dist.destroy_process_group()
    emit("sharded", card=smi, **row)
    return launches, k2_err


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    spec = importlib.util.find_spec("sks_tpu_torch")
    if spec is None or not os.path.abspath(spec.origin).startswith(ROOT):
        print("chip_smoke: run from a checkout of the repository "
              "(sks_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 2

    import sks_tpu_torch
    from sks_tpu_torch.bench import (
        fp64_table,
        fused_adaptive,
        roofline,
        table8,
    )
    from sks_tpu_torch.geom.homography import apply_homography, normalize_h
    from sks_tpu_torch.kernels import FP64_SOLVE_KERNELS, SOLVE_KERNELS, _build
    from sks_tpu_torch.kernels import aca_cuda as K
    from sks_tpu_torch.kernels import baselines_cuda as KB
    from sks_tpu_torch.kernels import sks_cuda as KS
    from sks_tpu_torch.robust import polish as P
    from sks_tpu_torch.robust import ransac as R
    from sks_tpu_torch.robust.ransac import (
        RansacConfig,
        fused_kernel_threshold,
        ransac_homography,
        ransac_homography_adaptive,
        ransac_homography_fused,
        sample_minimal_sets,
    )
    from sks_tpu_torch.utils.synth import (
        adversarial_quad_pairs,
        random_correspondences,
        random_quad_pairs,
    )

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    # ---- 1. device ---------------------------------------------------------
    emit("device", name=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         precision=torch.get_float32_matmul_precision())

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    emit("build", seconds=round(time.perf_counter() - t0, 3), nvcc=_build.find_nvcc(),
         flags=list(_build.NVCC_FLAGS), ptxas=ptxas_entries(_build.BUILD_LOG))

    # kernel -> (source in the repo, the TPU kernel it replaces).
    kernel_sources = {
        "aca_solve_score": ("sks_tpu_torch/csrc/aca.cu",
                            "sks_tpu/kernels/aca_pallas.py:197"),
        **{solve.key: (solve.source, solve.replaces)
           for solve in (*SOLVE_KERNELS.values(), *FP64_SOLVE_KERNELS.values())},
    }
    gen = torch.Generator(device=dev).manual_seed(20261016)
    errors = dict.fromkeys(kernel_sources, 0.0)

    # ---- 3. K1 against its plain version -----------------------------------
    b1 = 1 << 20
    q_src, q_tar = random_quad_pairs(gen, b1)
    s_soa, t_soa = K.to_soa(q_src), K.to_soa(q_tar)
    # Batches: the Table-8 one, a ragged one, and the eager chunks of the
    # adaptive loop's first stages.
    k1 = []
    for b in (b1, 1000, 256, 1024, 4096):
        s, t = s_soa[:, :b].contiguous(), t_soa[:, :b].contiguous()
        hk = K.aca_solve_soa(s, t)
        hp = K.aca_solve_soa_plain(s, t)
        torch.cuda.synchronize()
        diff = (normalize_h(K.from_soa_h(hk), "fro")
                - normalize_h(K.from_soa_h(hp), "fro")).abs().max().item()
        errors["aca_solve"] = max(errors["aca_solve"], diff)
        check(diff <= 1e-6, f"K1 f32 B={b}: max |fro diff| {diff}")
        s16, t16 = s.to(torch.bfloat16), t.to(torch.bfloat16)
        hk16 = K.aca_solve_soa(s16, t16)
        hp16 = K.aca_solve_soa_plain(s16, t16)
        same16 = torch.equal(hk16, hp16)
        check(same16, f"K1 bf16 B={b}: kernel and plain outputs differ")
        k1.append({"B": b, "f32_exact": torch.equal(hk, hp),
                   "f32_max_fro_diff": diff, "bf16_equal": same16})
    emit("k1_vs_plain", cases=k1)

    # ---- 4. K2 against its plain version -----------------------------------
    # Every per-point gain is the plain version's, bit for bit (-fmad=false,
    # IEEE division); only the order of the sum over points differs.  So
    # 'inliers' (0/1 gains and weights: integer sums) must be equal, and
    # 'msac' / 'magsac' within rtol 1e-5 + atol 1e-4 of the plain version's
    # pairwise sum.  The kernel's own order is fixed: the same launch twice
    # must give the same bits.  Shapes: the default and the large hypothesis
    # budget, a ragged N, an N smaller than one warp's slice, weights that
    # drop a tenth of the points, one pair and a pair axis of 8; then the
    # launches of the adaptive path, whose hypothesis counts set grids (and
    # with them orders of the sum) of their own: a PROSAC fit of 512, and
    # fused stages of 16,384 (one grid step under the shipped gate, should
    # it move), 65,536 (above) and the schedule's cap; last, the VO
    # pipeline's launches: 1,024 hypotheses on 384 match slots, about half
    # of them empty (weight 0), for the 15 consecutive pairs of a 16-frame
    # call and the 20 closure pairs of planar_slam (phase k2_pipeline holds
    # K2 on the pipeline's own inputs too).
    def score_problem(n, pairs, b, keep=0.9):
        """``pairs`` problems of n matches (half of them junk) with b minimal
        sets each, and weights that keep each point with probability
        ``keep``: src, tar (pairs, 8, b), pts (pairs, 4, n), w (pairs, n)."""
        out = []
        for _ in range(pairs):
            src, tar, _ = random_correspondences(gen, (), n, 0.5)
            tar = tar.clone()
            tar[:n // 2] = torch.rand((n // 2, 2), generator=gen,
                                      device=dev) * 640.0
            idx = sample_minimal_sets(gen, n, b)
            out.append((K.to_soa(src[idx]), K.to_soa(tar[idx]),
                        torch.cat([src.T, tar.T]).contiguous(),
                        (torch.rand(n, generator=gen, device=dev)
                         < keep).float()))
        return tuple(torch.stack(x) for x in zip(*out))

    b2 = 65536
    k2 = []
    k2_rel = 0.0
    for b, n, pairs, keep in (
            (2048, 2000, 1, 0.9), (b2, 2000, 1, 0.9), (2048, 1999, 1, 0.9),
            (2048, 20, 1, 0.9), (2048, 2000, 8, 0.9), (2048, 1999, 8, 0.9),
            (2048, 20, 8, 0.9), (512, 2000, 1, 0.9), (16384, 2000, 1, 0.9),
            (R.ADAPTIVE_MAX_CHUNK, 2000, 1, 0.9), (1024, 384, 15, 0.5),
            (1024, 384, 20, 0.5)):
        s, t, pts, w = score_problem(n, pairs, b, keep)
        if pairs == 1:  # the two-dimensional call
            s, t, pts, w = s[0], t[0], pts[0], w[0]
        for dt in (torch.float32, torch.bfloat16):
            sd, td = s.to(dt), t.to(dt)
            for scoring in ("inliers", "msac", "magsac"):
                thr = fused_kernel_threshold(
                    RansacConfig(threshold=3.0, scoring=scoring))
                sk = K.aca_solve_score_soa(sd, td, pts, thr, w, scoring)
                again = K.aca_solve_score_soa(sd, td, pts, thr, w, scoring)
                sp = K.aca_solve_score_soa_plain(sd, td, pts, thr, w, scoring)
                torch.cuda.synchronize()
                d = (sk - sp).abs()
                maxd = d.max().item()
                rel = (d / sp.abs().clamp(min=1e-3)).max().item()
                errors["aca_solve_score"] = max(errors["aca_solve_score"], maxd)
                case = {"B": b, "N": n, "pairs": pairs, "keep": keep,
                        "dtype": str(dt)[6:],
                        "scoring": scoring, "grid": K.score_grid(pairs, b, n),
                        "max_abs_diff": maxd, "max_rel_diff": rel,
                        "max_score": sk.max().item(),
                        "same_twice": torch.equal(sk, again),
                        "equal": torch.equal(sk, sp)}
                k2.append(case)
                check(case["same_twice"], f"K2 is not reproducible: {case}")
                check(sk.shape == sp.shape, f"K2 shape: {case}")
                if scoring == "inliers":
                    check(case["equal"], f"K2 inliers differ from plain: {case}")
                else:
                    k2_rel = max(k2_rel, rel)
                    check(torch.allclose(sk, sp, rtol=1e-5, atol=1e-4),
                          f"K2 {scoring} beyond rtol 1e-5 + atol 1e-4: {case}")
        if pairs > 1:
            # The pair-axis launch against one launch per pair: the same bits
            # in every scoring (the chunks, which fix the order of a score's
            # sum, do not depend on the pair count).
            for scoring in ("inliers", "msac", "magsac"):
                thr = fused_kernel_threshold(
                    RansacConfig(threshold=3.0, scoring=scoring))
                one = K.aca_solve_score_soa(s, t, pts, thr, w, scoring)
                each = torch.stack([
                    K.aca_solve_score_soa(s[i], t[i], pts[i], thr, w[i],
                                          scoring) for i in range(pairs)])
                check(torch.equal(one, each), "K2 pair axis != per-pair "
                      f"launches at B={b} N={n}, {scoring}")
    emit("k2_vs_plain", bound="inliers equal; msac, magsac rtol 1e-5 + atol "
         "1e-4 (sum order); same launch twice bit-equal",
         max_rel_diff_soft=k2_rel, cases=k2)

    # K2's bound at a shape: 17 values a hypothesis and 5 a point moved, the
    # plain version's arithmetic (inlier counting) at the float32 rate.
    per_hyp, per_pair = roofline.score_ops(K.aca_solve_score_soa_plain,
                                           "inliers")

    def k2_bound(b, pairs, n=2000):
        return roofline.bound_ms(
            4 * pairs * (17 * b + 5 * n),
            {k: pairs * b * (per_hyp.get(k, 0) + n * per_pair[k])
             for k in per_pair})


    # ---- 4b. K3 and the four K4 instances against their plain versions -----
    # Bound: equal, value for value (a NaN where the plain version has one),
    # in f32 and bf16.  Each body follows its PyTorch core op for op, and
    # -fmad=false with IEEE division and sqrt rounds every op as the eager
    # op does, so nothing short of equality is accepted.
    def same(a, b):
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())

    def fro_diff(a, b):
        wide = torch.float64 if a.dtype == torch.float64 else torch.float32
        d = (normalize_h(K.from_soa_h(a.to(wide)), "fro")
             - normalize_h(K.from_soa_h(b.to(wide)), "fro")).abs()
        return d[torch.isfinite(d)].max().item() if d.numel() else 0.0

    k34 = []
    for solver, solve in SOLVE_KERNELS.items():
        if solver == "aca":  # K1: phase 3
            continue
        kname, kern, plain = solve.key, solve.kernel, solve.plain
        for b in (b1, 1000):
            for dt in (torch.float32, torch.bfloat16):
                s = s_soa[:, :b].contiguous().to(dt)
                t = t_soa[:, :b].contiguous().to(dt)
                hk, hp = kern(s, t), plain(s, t)
                torch.cuda.synchronize()
                diff = fro_diff(hk, hp)
                errors[kname] = max(errors[kname], diff)
                case = {"kernel": kname, "B": b, "dtype": str(dt)[6:],
                        "torch_equal": torch.equal(hk, hp),
                        "equal_nan_aware": same(hk, hp),
                        "nan": int(torch.isnan(hk).sum()),
                        "max_fro_diff": diff}
                k34.append(case)
                check(case["equal_nan_aware"], f"K3/K4 vs plain: {case}")
    # The kernels that share the Jacobi rotation, on pairs that reach what
    # random quads never do (collinear, repeated and zero-size quads, squares
    # that underflow or overflow, NaN and infinity), 64 of each of 16 cases.
    adv_src, adv_tar, adv_labels = adversarial_quad_pairs(0, 64)
    adv_s = K.to_soa(torch.from_numpy(adv_src).to(dev))
    adv_t = K.to_soa(torch.from_numpy(adv_tar).to(dev))

    def adversarial_cases(registry, storages):
        out = []
        for solver in ("ho", "ndlt"):
            solve = registry[solver]
            for dt in storages:
                s, t = adv_s.to(dt), adv_t.to(dt)
                hk, hp = solve.kernel(s, t), solve.plain(s, t)
                torch.cuda.synchronize()
                differ = ~((hk == hp) | (torch.isnan(hk) & torch.isnan(hp))
                           ).all(0)
                case = {"kernel": solve.key, "B": s.shape[1],
                        "storage": str(dt)[6:], "input": "adversarial",
                        "equal_nan_aware": not bool(differ.any()),
                        "nan_columns": int(torch.isnan(hk).any(0).sum()),
                        "finite_columns": int(torch.isfinite(hk).all(0).sum()),
                        "cases_that_differ": sorted(
                            {adv_labels[i] for i in differ.nonzero()[:, 0]})}
                out.append(case)
                check(case["equal_nan_aware"] and case["nan_columns"] > 0
                      and case["finite_columns"] > 0,
                      f"adversarial quads, kernel vs plain: {case}")
        return out

    k34 += adversarial_cases(SOLVE_KERNELS, (torch.float32, torch.bfloat16))
    emit("k3_k4_vs_plain", cases=k34)

    # ---- 4c. K5 (six kinds, float64) against its plain version -------------
    # Bound: equal, value for value (a NaN where the plain version has one),
    # from float32 and from float64 storage: each kind's body is its float64
    # core op for op (the float32 Jacobi seed of HO and NDLT included, rounded
    # with __double2float_rn as Tensor.float() rounds), and the h22 division
    # is a true division in both.
    q_src64, q_tar64 = random_quad_pairs(gen, b1, torch.float64)
    s64_soa, t64_soa = K.to_soa(q_src64), K.to_soa(q_tar64)
    k5 = []
    for solver, solve in FP64_SOLVE_KERNELS.items():
        for b in (b1, 1000, 256, 4096):  # the last two: adaptive chunks
            for dt in (torch.float32, torch.float64):
                s = s64_soa[:, :b].to(dt).contiguous()
                t = t64_soa[:, :b].to(dt).contiguous()
                hk, hp = solve.kernel(s, t), solve.plain(s, t)
                torch.cuda.synchronize()
                diff = fro_diff(hk, hp)
                errors[solve.key] = max(errors[solve.key], diff)
                case = {"kernel": solve.key, "B": b, "storage": str(dt)[6:],
                        "out_dtype": str(hk.dtype)[6:],
                        "equal_nan_aware": same(hk, hp),
                        "nan": int(torch.isnan(hk).sum()),
                        "max_fro_diff": diff}
                k5.append(case)
                check(case["equal_nan_aware"] and hk.dtype == torch.float64,
                      f"K5 vs plain: {case}")
    k5 += adversarial_cases(FP64_SOLVE_KERNELS, (torch.float32, torch.float64))
    emit("k5_vs_plain", cases=k5)

    # ---- 5. main path, through the kernels ---------------------------------
    def problem(seed, n, outlier_frac, dtype=torch.float32):
        """n matches with 0.5 px noise; a random outlier_frac of them junk."""
        g = torch.Generator(device=dev).manual_seed(seed)
        src, tar, h = random_correspondences(g, (), n, 0.5, dtype)
        out = torch.randperm(n, generator=g, device=dev)[:int(n * outlier_frac)]
        tar = tar.clone()
        tar[out] = torch.rand((out.numel(), 2), generator=g, device=dev,
                              dtype=dtype) * 640.0
        true_inl = torch.ones(n, dtype=torch.bool, device=dev)
        true_inl[out] = False
        return src, tar, h, true_inl

    corners = torch.tensor([[0.0, 0.0], [640.0, 0.0], [640.0, 480.0],
                            [0.0, 480.0]], device=dev)
    problems = {"50pct": (problem(1, 2000, 0.5), 2048),
                "90pct": (problem(2, 2000, 0.9), 65536)}
    problem64 = problem(1, 2000, 0.5, torch.float64)

    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    # Table 8: a 2^20 batch of quads solved by each of the six solvers' kernels
    # (K1 is the bench.py headline).
    h_batch = {"aca": K.aca_h_cuda(q_src, q_tar),
               "sks": KS.sks_h_cuda(q_src, q_tar)}
    for solver in KB.SOA_SOLVERS:
        h_batch[solver] = KB.baseline_h_cuda(solver, q_src, q_tar)
    # The same six solvers in float64 (K5) on a 2^20 batch of float64 quads.
    h_batch64 = {solver: K.from_soa_h(solve.kernel(s64_soa, t64_soa))
                 for solver, solve in FP64_SOLVE_KERNELS.items()}
    fits = {}
    for name, ((src, tar, h_true, true_inl), iters) in problems.items():
        fits[name] = sks_tpu_torch.find_homography(
            src, tar, ransac_reproj_threshold=3.0, max_iters=iters)
    # A batched fit over 8 pairs: every pair's minimal sets drawn first, one
    # K2 launch for the 8, then the tail pair by pair; against 8 single fits
    # drawing from the same generator in turn.
    # Inlier counting on all 8, and the soft MSAC score on the first 2.
    pairs8 = [problem(10 + i, 2000, 0.5) for i in range(8)]
    src8 = torch.stack([p[0] for p in pairs8])
    tar8 = torch.stack([p[1] for p in pairs8])
    batched_fits = {}
    for method, count in (("ransac", 8), ("msac", 2)):
        before8 = K.LAUNCHES["aca_solve_score"]
        h_b, mask_b = sks_tpu_torch.find_homography(
            src8[:count], tar8[:count], method=method,
            ransac_reproj_threshold=3.0, max_iters=2048,
            generator=torch.Generator(device=dev).manual_seed(8))
        torch.cuda.synchronize()
        k2_launches = K.LAUNCHES["aca_solve_score"] - before8
        g8 = torch.Generator(device=dev).manual_seed(8)
        singles = [sks_tpu_torch.find_homography(
            src8[i], tar8[i], method=method, ransac_reproj_threshold=3.0,
            max_iters=2048, generator=g8) for i in range(count)]
        batched_fits[method] = (h_b, mask_b, k2_launches, singles)
    # Array inputs go to the card (a caller asks for the CPU with CPU tensors).
    h_arr, mask_arr = sks_tpu_torch.find_homography(
        problems["50pct"][0][0].cpu().numpy(),
        problems["50pct"][0][1].cpu().numpy(),
        ransac_reproj_threshold=3.0, max_iters=2048)
    # The general path with a kernel-backed batched solve: K3 and K4-GE.
    for solver in ("sks", "rho_ge"):
        src, tar = problems["50pct"][0][:2]
        fits[f"50pct_{solver}"] = sks_tpu_torch.find_homography(
            src, tar, ransac_reproj_threshold=3.0, max_iters=2048,
            solver=solver)
    # float64 points on CUDA keep their precision: the general path in
    # float64, its batched solve in K5, never the float32 fused kernel (K2).
    torch.cuda.synchronize()
    before64 = dict(K.LAUNCHES)
    for solver in ("aca", "sks"):
        src, tar = problem64[:2]
        fits[f"50pct_{solver}_fp64"] = sks_tpu_torch.find_homography(
            src, tar, ransac_reproj_threshold=3.0, max_iters=2048,
            solver=solver)
    torch.cuda.synchronize()
    launches_fp64_fits = {k: K.LAUNCHES[k] - before64[k] for k in K.LAUNCHES}
    # The general path with float64 scoring (df64_scoring), float32 points.
    src, tar = problems["50pct"][0][:2]
    res = ransac_homography(None, src, tar, RansacConfig(
        num_hypotheses=2048, threshold=3.0, df64_scoring=True))
    fits["50pct_df64_scoring"] = (res.h, res.inlier_mask)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)

    main = {"launches": launches, "batch": b1, "batch_solve": {}}
    # Exact homographies, so every solver must reproduce its quads: finite on
    # >= 99.9% and a median reprojection under 0.01 px.  NDLT (inverse
    # iteration) is held by the same median and finite fraction and by
    # nothing stricter: its worst quad in 20K is 0.77 px (ops/linalg.py).
    for solver, h in h_batch.items():
        reproj = (apply_homography(h, q_src) - q_tar).norm(dim=-1)
        finite = torch.isfinite(reproj).all(-1)
        res = {"finite_frac": finite.float().mean().item(),
               "median_reproj_px": reproj[finite].median().item(),
               "p999_reproj_px": reproj[finite].amax(-1).quantile(
                   0.999).item()}
        main["batch_solve"][solver] = res
        check(res["finite_frac"] >= 0.999 and res["median_reproj_px"] < 0.01,
              f"{solver} batch solve: {res}")
    # float64: finite on >= 99.9%, a median reprojection under 1e-8 px and at
    # most 1e-3 of the float32 kernel's median for the same solver.
    main["batch_solve_fp64"] = {}
    for solver, h in h_batch64.items():
        reproj = (apply_homography(h, q_src64) - q_tar64).norm(dim=-1)
        finite = torch.isfinite(reproj).all(-1)
        med32 = main["batch_solve"][solver]["median_reproj_px"]
        res = {"finite_frac": finite.float().mean().item(),
               "median_reproj_px": reproj[finite].median().item(),
               "p999_reproj_px": reproj[finite].amax(-1).quantile(
                   0.999).item(),
               "dtype": str(h.dtype)[6:]}
        res["median_over_f32_median"] = res["median_reproj_px"] / med32
        main["batch_solve_fp64"][solver] = res
        check(h.dtype == torch.float64 and res["finite_frac"] >= 0.999
              and res["median_reproj_px"] < 1e-8
              and res["median_over_f32_median"] <= 1e-3,
              f"{solver} fp64 batch solve: {res}")
    for name, ((src, tar, h_true, true_inl), iters) in [
            *problems.items(),
            ("50pct_sks", (problems["50pct"][0], 2048)),
            ("50pct_rho_ge", (problems["50pct"][0], 2048)),
            ("50pct_aca_fp64", (problem64, 2048)),
            ("50pct_sks_fp64", (problem64, 2048)),
            ("50pct_df64_scoring", (problems["50pct"][0], 2048))]:
        h, mask = fits[name]
        check(h.shape == (3, 3) and mask.shape == (src.shape[0],)
              and mask.dtype == torch.bool and h.dtype == src.dtype,
              f"{name}: output shapes and dtype")
        err = (apply_homography(h, corners.to(h.dtype))
               - apply_homography(h_true, corners.to(h.dtype))
               ).norm(dim=-1).mean().item()
        agree = (mask == true_inl).float().mean().item()
        main[name] = {"max_iters": iters, "corner_err_px": err,
                      "inlier_agreement": agree,
                      "num_inliers": int(mask.sum().item())}
        check(err < 1.0 and agree >= 0.95, f"{name}: {main[name]}")
    main["launches_fp64_fits"] = launches_fp64_fits
    for method, (h_b, mask_b, k2_launches, singles) in batched_fits.items():
        count = len(singles)
        batched = {"pairs": count, "method": method,
                   "k2_launches": k2_launches, "pairs_out": []}
        for i, (_, _, h_true, true_inl) in enumerate(pairs8[:count]):
            err = (apply_homography(h_b[i], corners)
                   - apply_homography(h_true, corners)
                   ).norm(dim=-1).mean().item()
            same = (torch.equal(h_b[i], singles[i][0])
                    and torch.equal(mask_b[i], singles[i][1]))
            batched["pairs_out"].append({
                "corner_err_px": err, "equals_single_fit": same,
                "inlier_agreement":
                    (mask_b[i] == true_inl).float().mean().item()})
            check(err < 1.0 and same, f"batched fit, pair {i}: {batched}")
        check(k2_launches == 1 and h_b.shape == (count, 3, 3)
              and mask_b.shape == (count, 2000),
              f"a batched fit must launch K2 once for its pairs: {batched}")
        main[f"batched_fit_{count}_pairs_{method}"] = batched
    check(h_arr.device.type == "cuda" and mask_arr.device.type == "cuda"
          and torch.equal(h_arr, fits["50pct"][0]),
          "array inputs must be fitted on the card, as the same tensors are")
    check(launches["aca_solve_score"] >= 2 and launches["sks_solve"] >= 2
          and launches["ge_solve"] >= 2
          and all(launches[k] >= 1 for k in kernel_sources),
          f"main path launches {launches}")
    check(launches_fp64_fits["fp64_aca"] >= 1
          and launches_fp64_fits["fp64_sks"] >= 1
          and launches_fp64_fits["aca_solve_score"] == 0,
          f"float64 fits must run K5 and not K2: {launches_fp64_fits}")
    emit("main_path", **main)

    # ---- 5b. the adaptive path: the confidence early-exit loop and PROSAC ---
    # A chunk of the loop launches one solve-or-score kernel, so the launch
    # counts are the chunks evaluated: K1 an eager float32 chunk, K5-aca an
    # eager float64 one, K2 a fused one.
    def corner_err(h, h_true):
        c = corners.to(h.dtype)
        return (apply_homography(h, c) - apply_homography(h_true.to(h.dtype), c)
                ).norm(dim=-1).mean().item()

    def schedule(max_iters, chunk=256):
        return [c for c, k in R._chunk_schedule(
            chunk, -(-max_iters // chunk), 4, 2, R.ADAPTIVE_MAX_CHUNK)
            for _ in range(k)]

    problem95 = problem(3, 2000, 0.95)
    iters95 = 1 << 21
    # Quality-sorted points for PROSAC: the inliers first.
    src, tar, h_true, true_inl = problems["50pct"][0]
    by_quality = torch.argsort(true_inl.to(torch.int8), descending=True,
                               stable=True)
    sorted50 = (src[by_quality], tar[by_quality], h_true, true_inl[by_quality])
    pairs4 = [problem(30 + i, 2000, f) for i, f in enumerate((0.3, 0.5, 0.7,
                                                              0.5))]
    src4 = torch.stack([p[0] for p in pairs4])
    tar4 = torch.stack([p[1] for p in pairs4])

    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    runs = {}

    def counted(name, fit):
        """Run one fit; keep its result and the launches it made."""
        before = dict(K.LAUNCHES)
        out = fit()
        torch.cuda.synchronize()
        runs[name] = (out, {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
                            if K.LAUNCHES[k] != before[k]})

    counted("50pct", lambda: sks_tpu_torch.find_homography(
        *problems["50pct"][0][:2], ransac_reproj_threshold=3.0,
        confidence=0.999))
    counted("95pct_fused", lambda: sks_tpu_torch.find_homography(
        *problem95[:2], method="fused", ransac_reproj_threshold=3.0,
        confidence=0.999, max_iters=iters95))
    counted("50pct_fp64", lambda: sks_tpu_torch.find_homography(
        *problem64[:2], ransac_reproj_threshold=3.0, confidence=0.999))
    counted("50pct_prosac_fused", lambda: sks_tpu_torch.find_homography(
        *sorted50[:2], ransac_reproj_threshold=3.0, max_iters=512,
        sampling="prosac"))
    counted("50pct_prosac_confidence", lambda: sks_tpu_torch.find_homography(
        *sorted50[:2], ransac_reproj_threshold=3.0, confidence=0.999,
        sampling="prosac"))
    counted("batched_4_pairs", lambda: sks_tpu_torch.find_homography(
        src4, tar4, ransac_reproj_threshold=3.0, confidence=0.999,
        max_iters=1 << 16,
        generator=torch.Generator(device=dev).manual_seed(4)))
    launches_adaptive = dict(K.LAUNCHES)
    g4 = torch.Generator(device=dev).manual_seed(4)
    singles4 = [sks_tpu_torch.find_homography(
        src4[i], tar4[i], ransac_reproj_threshold=3.0, confidence=0.999,
        max_iters=1 << 16, generator=g4) for i in range(4)]

    adaptive = {"launches": launches_adaptive,
                "fused_adaptive_min_chunk": R.FUSED_ADAPTIVE_MIN_CHUNK}
    for name, (_, _, h_true, true_inl) in (
            ("50pct", problems["50pct"][0]), ("95pct_fused", problem95),
            ("50pct_fp64", problem64), ("50pct_prosac_fused", sorted50),
            ("50pct_prosac_confidence", sorted50)):
        (h, mask), made = runs[name]
        adaptive[name] = {
            "corner_err_px": corner_err(h, h_true),
            "inlier_agreement": (mask == true_inl).float().mean().item(),
            "launches": made}
        check(adaptive[name]["corner_err_px"] < 1.0
              and adaptive[name]["inlier_agreement"] >= 0.95,
              f"adaptive {name}: {adaptive[name]}")
    # An easy fit stops within the first two chunks (256, 256), eager
    # chunks through K1 and nothing else.
    for name in ("50pct", "95pct_fused", "50pct_prosac_fused",
                 "50pct_prosac_confidence"):
        check(all(adaptive[name]["launches"].get(k) == 1
                  for k in TAIL_KERNELS),
              f"a float32 adaptive fit refits its top-K and polishes its "
              f"model in one launch each: {adaptive[name]}")
    made = without_tail(adaptive["50pct"]["launches"])
    check(set(made) == {"aca_solve"} and 1 <= made["aca_solve"] <= 2,
          f"the 50% fit must stop within the first two chunks on K1: {made}")
    # method='fused': the stages from FUSED_ADAPTIVE_MIN_CHUNK on run K2, one
    # launch a chunk; the smaller ones before them K1.
    made = without_tail(adaptive["95pct_fused"]["launches"])
    sizes = schedule(iters95)[:sum(made.values())]
    fused_chunks = sum(c >= R.FUSED_ADAPTIVE_MIN_CHUNK for c in sizes)
    adaptive["95pct_fused"].update(
        max_iters=iters95, chunks=len(sizes), hypotheses=sum(sizes),
        fused_chunks=fused_chunks)
    check(set(made) <= {"aca_solve", "aca_solve_score"}
          and made.get("aca_solve_score", 0) == fused_chunks >= 1
          and made.get("aca_solve", 0) == len(sizes) - fused_chunks,
          f"the fused adaptive fit must launch K2 once a fused chunk: "
          f"{adaptive['95pct_fused']}")
    made = adaptive["50pct_fp64"]["launches"]
    check(set(made) == {"fp64_aca"} and runs["50pct_fp64"][0][0].dtype
          == torch.float64, f"the float64 adaptive fit must run K5-aca: {made}")
    check(without_tail(adaptive["50pct_prosac_fused"]["launches"])
          == {"aca_solve_score": 1},
          "a fixed-batch PROSAC fit on the card takes the fused kernel once: "
          f"{adaptive['50pct_prosac_fused']}")
    (h4, mask4), made = runs["batched_4_pairs"]
    batched = {"launches": made, "pairs_out": []}
    for i, (_, _, h_true, true_inl) in enumerate(pairs4):
        same = (torch.equal(h4[i], singles4[i][0])
                and torch.equal(mask4[i], singles4[i][1]))
        batched["pairs_out"].append({
            "corner_err_px": corner_err(h4[i], h_true),
            "equals_single_fit": same})
        check(same and batched["pairs_out"][-1]["corner_err_px"] < 1.0,
              f"batched adaptive fit, pair {i}: {batched}")
    check(h4.shape == (4, 3, 3) and mask4.shape == (4, 2000),
          "batched adaptive fit: output shapes")
    adaptive["batched_4_pairs"] = batched
    check(launches_adaptive["aca_solve"] >= 1
          and launches_adaptive["aca_solve_score"] >= 1
          and launches_adaptive["fp64_aca"] >= 1,
          f"the adaptive path must launch K1, K2 and K5: {launches_adaptive}")
    emit("adaptive", **adaptive)

    # ---- 5c. the planar-VO pipeline: frames -> poses ------------------------
    # Rendered on the card (T = 16 at (240, 320), the JAX package's benchmark
    # size), at its pipeline_fps configuration: frames_to_poses on the fused
    # route (one K2 launch for the 15 pairs) and on the general route (K1
    # once a pair), planar_slam on a closed circuit without and with the pose
    # graph (K2 once for the consecutive pairs, once for the closures).  ATE
    # bound: 0.12 x path length + 0.02 (the JAX package's
    # tests/test_pipeline.py), and smoothing under 0.95 x the raw ATE.
    from sks_tpu_torch.bench import pipeline_fps
    from sks_tpu_torch.data.images import planar_sequence
    from sks_tpu_torch.slam.odometry import closure_candidates
    from sks_tpu_torch.slam.posegraph import ate_rmse
    from sks_tpu_torch.utils import graphs

    def seq_gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    sweep = planar_sequence(seq_gen(16), 16, (240, 320))
    circuit = planar_sequence(seq_gen(17), 16, (240, 320), loop=True)
    sweep_vga = planar_sequence(seq_gen(18), 16, (480, 640))
    vo_kw = dict(num_corners=384, num_octaves=2, plane_depth=3.0)
    slam_kw = dict(vo_kw, strides=(4, 8), esm_iters=0)
    cfg_fused, cfg_general = pipeline_fps.config(True), pipeline_fps.config(
        False)
    vo_runs = {}
    # Every K2 launch of these runs is recorded with its inputs (the
    # pipeline's own draws and match masks), to be replayed against the
    # plain version below; the recording calls the wrapper once, as the
    # path does.
    k2_launched, k2_wrapper = [], R.aca_solve_score_soa
    run_name = [None]

    def k2_recorded(*args, **kwargs):
        k2_launched.append((run_name[0], args, kwargs))
        return k2_wrapper(*args, **kwargs)

    # A fused batch's per-pair tail runs as a CUDA graph on the card
    # (utils/graphs): the first call of its shapes captures it, each later
    # call replays it.  ``captured[run]`` holds the pairs of each fused
    # batch that a run captured.
    captured = {}

    def tail_graphs():
        return {k for k in graphs._GRAPHS if k[0][0] == "fused_tail"}

    def vo_counted(name, seq, fit):
        before, held = dict(K.LAUNCHES), tail_graphs()
        run_name[0] = name
        t0 = time.perf_counter()
        out = fit()
        torch.cuda.synchronize()
        vo_runs[name] = (seq, out, {k: K.LAUNCHES[k] - before[k]
                                    for k in K.LAUNCHES
                                    if K.LAUNCHES[k] != before[k]},
                         (time.perf_counter() - t0) * 1e3)
        # A key holds the counts' (dtype, shape) third: (pairs, B).
        captured[name] = sorted(k[2][1][0] for k in tail_graphs() - held)

    torch.cuda.synchronize()
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    graphs._GRAPHS.clear()
    R.aca_solve_score_soa = k2_recorded
    try:
        vo_counted("fused", sweep, lambda: sks_tpu_torch.frames_to_poses(
            seq_gen(5), sweep[0], sweep[2], cfg_fused, **vo_kw))
        # The same call again: a replay of the graph the first one captured.
        vo_counted("fused_again", sweep, lambda: sks_tpu_torch.frames_to_poses(
            seq_gen(5), sweep[0], sweep[2], cfg_fused, **vo_kw))
        vo_counted("general", sweep, lambda: sks_tpu_torch.frames_to_poses(
            seq_gen(5), sweep[0], sweep[2], cfg_general, **vo_kw))
        for smooth in (False, True):
            vo_counted(f"planar_slam_smooth_{smooth}", circuit,
                       lambda smooth=smooth: sks_tpu_torch.planar_slam(
                           seq_gen(6), circuit[0], circuit[2], cfg_fused,
                           smooth=smooth, **slam_kw))
        # The dense ESM polish on every pair: planar_slam's default
        # (esm_iters=8) on the same circuit, and frames_to_poses at VGA.
        vo_counted("planar_slam_esm", circuit,
                   lambda: sks_tpu_torch.planar_slam(
                       seq_gen(6), circuit[0], circuit[2], cfg_fused,
                       strides=(4, 8), **vo_kw))
        vo_counted("fused_esm_vga", sweep_vga,
                   lambda: sks_tpu_torch.frames_to_poses(
                       seq_gen(5), sweep_vga[0], sweep_vga[2], cfg_fused,
                       esm_iters=8, **vo_kw))
    finally:
        R.aca_solve_score_soa = k2_wrapper
    launches_pipeline = dict(K.LAUNCHES)
    # The same fused call on CPU tensors of the port: the same frames and the
    # same generators (they draw on the card; the draws move to the CPU).
    out_cpu = sks_tpu_torch.frames_to_poses(
        seq_gen(5), sweep[0].cpu(), sweep[2].cpu(), cfg_fused, **vo_kw)

    def path_length(poses):
        return torch.linalg.norm(torch.diff(poses[:, :3, 3], dim=0),
                                 dim=-1).sum().item()

    pipeline = {"launches": launches_pipeline, "frames": 16,
                "shape": [240, 320], "tail_graphs_captured": captured}
    closures = len(closure_candidates(16, (4, 8)))
    for name, ((frames_, poses_gt, _), out, made, ms) in vo_runs.items():
        ate = ate_rmse(out["poses"], poses_gt).item()
        bound = 0.12 * path_length(poses_gt) + 0.02
        pipeline[name] = {"shape": list(frames_.shape[-2:]), "ate": ate,
                          "ate_bound": bound, "launches": made,
                          "host_ms": ms,
                          "num_inliers": out["num_inliers"].tolist()}
        check(bool(torch.isfinite(out["poses"]).all()) and ate < bound
              and out["poses"].shape == (16, 4, 4),
              f"pipeline {name}: {pipeline[name]}")
    # The tail's kernels: the general route fits pair by pair, eagerly, one
    # launch each a pair.  A fused batch's first call launches each twice a
    # pair (the eager run before the capture, then the capture); a replay
    # runs the captured kernels with no call that LAUNCHES counts.
    for name, (_, out_, made_, _) in vo_runs.items():
        pairs_fit = out_["num_inliers"].numel() + (
            out_["closure_inliers"].numel() if "closure_inliers" in out_
            else 0)
        want = pairs_fit if name == "general" else 2 * sum(captured[name])
        check(all(made_.get(k, 0) == want for k in TAIL_KERNELS),
              f"{name}: the IRLS refit and the polish, {want} launches each "
              f"({pairs_fit} pair fits, captured {captured[name]}): {made_}")
    # The sweep's 15 pairs are captured once; the circuit's pairs replay
    # that graph, its 20 closures are captured at the first planar_slam and
    # replayed after.
    check(captured == {"fused": [15], "fused_again": [], "general": [],
                       "planar_slam_smooth_False": [closures],
                       "planar_slam_smooth_True": [], "planar_slam_esm": [],
                       "fused_esm_vga": []},
          f"the fused tail's captures: {captured}")
    # A replay on the captured call's inputs gives the captured call's
    # answers: the same fused call twice, and the pairs and closures that
    # planar_slam fits before its pose graph, with and without smoothing.
    for first, again, keys in (
            ("fused", "fused_again", ("poses", "rel", "num_inliers")),
            ("planar_slam_smooth_False", "planar_slam_smooth_True",
             ("rel", "num_inliers", "closure_inliers", "closure_rel"))):
        a_, b_ = vo_runs[first][1], vo_runs[again][1]
        check(all(torch.equal(a_[k], b_[k]) for k in keys),
              f"{again} (a replay) differs from {first} (its capture) in "
              f"{[k for k in keys if not torch.equal(a_[k], b_[k])]}")
    for name in ("fused", "fused_again"):
        check(without_tail(vo_runs[name][2]) == {"aca_solve_score": 1},
              f"a fused frames_to_poses launches K2 once: {pipeline[name]}")
    check(without_tail(vo_runs["general"][2]) == {"aca_solve": 15},
          f"a general frames_to_poses launches K1 once a pair: "
          f"{pipeline['general']}")
    check(without_tail(vo_runs["fused_esm_vga"][2]) == {"aca_solve_score": 1},
          f"frames_to_poses(esm_iters=8) launches K2 once: "
          f"{pipeline['fused_esm_vga']}")
    for name in ("planar_slam_smooth_False", "planar_slam_smooth_True",
                 "planar_slam_esm"):
        run_ = vo_runs[name]
        check(without_tail(run_[2]) == {"aca_solve_score": 2}
              and run_[1]["closure_inliers"].shape == (closures,),
              f"planar_slam launches K2 for the pairs and the closures: "
              f"{pipeline[name]}")
    ate_raw = pipeline["planar_slam_smooth_False"]["ate"]
    ate_closed = pipeline["planar_slam_smooth_True"]["ate"]
    pipeline["smoothed_over_raw_ate"] = ate_closed / ate_raw
    check(ate_closed < 0.95 * ate_raw,
          f"the pose graph must cut the raw ATE: {ate_raw} -> {ate_closed}")
    # planar_slam's default ESM polish against none, both smoothed, over 20
    # loop circuits: the one above and 19 more.  (The JAX package's
    # tests/test_pipeline.py claims less: the ESM chain beats the raw one,
    # both unsmoothed.)  After smoothing one circuit's margin can be a tie:
    # this one's is 0.2%, and a polish whose sums run in another order flips
    # it.  On an H100 the eager polish and the polish kernel alike read a
    # median ATE ratio of 0.673 over these circuits, ESM ahead on 19 and 18
    # of 20 (on one circuit it loses by 2.5% with either polish).  A polish
    # or ESM that did nothing would read ~1.0 and about half.
    ate_ratios = [pipeline["planar_slam_esm"]["ate"] / ate_closed]
    for c in range(100, 119):
        frames_c, poses_c, k_c = planar_sequence(seq_gen(c), 16, (240, 320),
                                                 loop=True)
        ate0, ate8 = (ate_rmse(sks_tpu_torch.planar_slam(
            seq_gen(6), frames_c, k_c, cfg_fused,
            **dict(slam_kw, esm_iters=e))["poses"], poses_c).item()
            for e in (0, 8))
        ate_ratios.append(ate8 / ate0)
    esm_wins = sum(r < 1.0 for r in ate_ratios)
    pipeline["esm_over_no_esm_ate"] = {
        "ratios": ate_ratios, "wins": esm_wins,
        "median": statistics.median(ate_ratios)}
    check(esm_wins >= 16 and statistics.median(ate_ratios) < 0.9,
          f"planar_slam(esm_iters=8) must beat esm_iters=0 on at least 16 of "
          f"20 circuits, at a median ATE ratio under 0.9: "
          f"{pipeline['esm_over_no_esm_ate']}")
    fused_out = vo_runs["fused"][1]
    pose_gap = (fused_out["poses"].cpu() - out_cpu["poses"]).abs().max().item()
    inl_gap = (fused_out["num_inliers"].cpu().long()
               - out_cpu["num_inliers"].long()).abs().max().item()
    pipeline["card_vs_cpu"] = {"max_pose_diff": pose_gap, "bound": 5e-3,
                               "max_num_inliers_diff": inl_gap,
                               "num_inliers_cpu":
                                   out_cpu["num_inliers"].tolist()}
    check(pose_gap <= 5e-3 and inl_gap <= 2,
          f"frames_to_poses, card vs CPU: {pipeline['card_vs_cpu']}")
    emit("pipeline", card=smi, **pipeline)

    # ---- 5d. K2 on the pipeline's own launches ------------------------------
    # Each launch recorded above, replayed on its inputs: the kernel against
    # its plain version (inliers equal, msac / magsac rtol 1e-5 + atol 1e-4;
    # the same launch twice bit-equal), and the frames_to_poses launch (15 x
    # 1,024 x 384) timed beside its plain version and its bound.
    k2_pipe = []
    for name, args, kwargs in k2_launched:
        sk = K.aca_solve_score_soa(*args, **kwargs)
        again = K.aca_solve_score_soa(*args, **kwargs)
        sp = K.aca_solve_score_soa_plain(*args, **kwargs)
        torch.cuda.synchronize()
        pairs, b, n = args[0].shape[0], args[0].shape[-1], args[2].shape[-1]
        maxd = (sk - sp).abs().max().item()
        errors["aca_solve_score"] = max(errors["aca_solve_score"], maxd)
        case = {"run": name, "pairs": pairs, "B": b, "N": n,
                "scoring": kwargs["scoring"],
                "weighted_share": kwargs["point_weights"].mean().item(),
                "grid": K.score_grid(pairs, b, n), "max_abs_diff": maxd,
                "max_score": sk.max().item(), "equal": torch.equal(sk, sp),
                "same_twice": torch.equal(sk, again)}
        k2_pipe.append(case)
        check(case["same_twice"] and sk.shape == sp.shape,
              f"K2 on the pipeline's inputs is not reproducible: {case}")
        if kwargs["scoring"] == "inliers":
            check(case["equal"], f"K2 inliers differ from plain on the "
                  f"pipeline's inputs: {case}")
        else:
            check(torch.allclose(sk, sp, rtol=1e-5, atol=1e-4),
                  f"K2 beyond rtol 1e-5 + atol 1e-4 on the pipeline's "
                  f"inputs: {case}")
    check([c["run"] for c in k2_pipe] == [
        "fused", "fused_again", "planar_slam_smooth_False", "planar_slam_smooth_False",
        "planar_slam_smooth_True", "planar_slam_smooth_True",
        "planar_slam_esm", "planar_slam_esm", "fused_esm_vga"],
        f"the pipeline's K2 launches: {[c['run'] for c in k2_pipe]}")
    _, args, kwargs = k2_launched[0]
    ms_k, ms_p = paired_ms(
        lambda: K.aca_solve_score_soa(*args, **kwargs),
        lambda: K.aca_solve_score_soa_plain(*args, **kwargs))
    pairs, b, n = args[0].shape[0], args[0].shape[-1], args[2].shape[-1]
    bound_ms, bound_by = k2_bound(b, pairs, n)
    k2_pipe_time = {"pairs": pairs, "B": b, "N": n, "ms": ms_k,
                    "plain_ms": ms_p, "bound_ms": bound_ms,
                    "bound_by": bound_by, "share_of_bound": bound_ms / ms_k}
    emit("k2_pipeline", card=smi, bound="inliers equal; msac, magsac rtol "
         "1e-5 + atol 1e-4; same launch twice bit-equal", cases=k2_pipe,
         frames_to_poses_launch=k2_pipe_time)
    # ---- 5e. the dense ESM polish, batched over the pairs of a sequence -----
    # esm_polish_pair_symmetric, the polish fit_pair runs (its default caps:
    # 8 coarse and 2 fine iterations, both directions), on the 15
    # consecutive pairs of a 16-frame sequence at (240, 320) and (480, 640)
    # in one call, from the true homographies displaced by up to 1.5 px.
    # Bounds: each pair of the batch against the same call for that pair
    # alone, and the card against the port on the CPU on the same inputs,
    # within 0.01 px at the template's corners (float32 sums over up to
    # 272,384 template pixels in another order); no host read inside the
    # polish (the timed call runs under set_sync_debug_mode("error")); the
    # corner error against the truth lower after than before.  The warm-up
    # call counts the aten ops the polish dispatches to the card (each
    # launches one kernel or a few).
    from sks_tpu_torch.bench import esm_bench
    from sks_tpu_torch.slam.tracking import esm_polish_pair_symmetric

    def pair_truth(poses, k_seq):
        """True homographies frame i -> i+1 of the plane z = 3 of frame 0,
        from the cam->world poses (T, 4, 4)."""
        w2c = torch.linalg.inv(poses)
        rel = w2c[1:] @ poses[:-1]  # cam_i -> cam_{i+1}
        n_i = w2c[:-1, :3, 2]  # R_i^T (0, 0, 1)
        d_i = 3.0 + (n_i * w2c[:-1, :3, 3]).sum(-1)
        core = rel[:, :3, :3] + rel[:, :3, 3:4] * n_i[:, None, :] / d_i[
            :, None, None]
        return k_seq @ core @ torch.linalg.inv(k_seq)

    def corner_gap(a, b, shape, border=16):
        """(P,) largest displacement (px) of the template's corners."""
        hh, ww = shape
        c = torch.tensor([[border, border], [ww - border, border],
                          [border, hh - border], [ww - border, hh - border]],
                         dtype=torch.float64, device=a.device)
        d = apply_homography(a.double(), c) - apply_homography(
            b.to(a.device).double(), c)
        return d.norm(dim=-1).amax(-1)

    esm = {}
    for frames_, poses_gt, k_seq in (sweep, sweep_vga):
        shape = tuple(frames_.shape[-2:])
        h_true = pair_truth(poses_gt, k_seq)
        shift = torch.eye(3, device=dev).repeat(15, 1, 1)
        shift[:, :2, 2] = 3.0 * torch.rand((15, 2), generator=gen,
                                           device=dev) - 1.5
        h0 = h_true @ shift
        f1, f2 = frames_[:-1], frames_[1:]
        _, ops = esm_bench.dispatched_ops(
            lambda: esm_polish_pair_symmetric(f1, f2, h0))
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ev0.record()
            h_b, rms_b = esm_polish_pair_symmetric(f1, f2, h0)
            ev1.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        single = torch.stack([esm_polish_pair_symmetric(f1[i], f2[i],
                                                        h0[i])[0]
                              for i in range(15)])
        h_cpu, _ = esm_polish_pair_symmetric(f1.cpu(), f2.cpu(), h0.cpu())
        before = corner_gap(h0, h_true, shape)
        after = corner_gap(h_b, h_true, shape)
        row = {"pairs": 15, "shape": list(shape), "iters": [8, 2],
               "device_ms": ev0.elapsed_time(ev1), "host_ms": host_ms,
               "aten_ops": sum(ops.values()),
               "corner_err_before_px": {"max": before.max().item(),
                                        "mean": before.mean().item()},
               "corner_err_after_px": {"max": after.max().item(),
                                       "mean": after.mean().item()},
               "batch_vs_single_px": corner_gap(h_b, single,
                                                shape).max().item(),
               "card_vs_cpu_px": corner_gap(h_b, h_cpu, shape).max().item(),
               "bound_px": 0.01, "rms": rms_b.tolist()}
        esm[f"{shape[0]}x{shape[1]}"] = row
        check(row["batch_vs_single_px"] <= 0.01
              and row["card_vs_cpu_px"] <= 0.01
              and bool(torch.isfinite(h_b).all())
              and row["corner_err_after_px"]["max"]
              < row["corner_err_before_px"]["max"],
              f"esm polish at {shape}: {row}")
    emit("esm", card=smi, **esm)
    # The reference's ESM benchmark (bench/esm_bench.py): 64 templates of
    # 64 x 64 in 128 x 128 images, 10 iterations, gather sampling.
    esm_row = esm_bench.run()
    check(esm_row["median_translation_err_px"] < 0.01,
          f"esm_bench did not track: {esm_row}")
    emit("esm_bench", **esm_row)

    # ---- 5f. bundle adjustment at full width --------------------------------
    # synth_ba_problem's width (20 cameras, 10,240 landmarks, 80% seen,
    # 0.5 px of noise) through run_ba, 8 Gauss-Newton steps at damping 1e-4
    # (the JAX package's bench/ba_scale.py), after one warm-up step that also
    # counts the aten ops a step dispatches; in float64, then in float32
    # (the default).  Held, in float64: the final RMS reprojection within 20%
    # of the noise (the optimum leaves 0.5 x sqrt(1 - unknowns /
    # observations) ~ 0.475 px), and the same run on the CPU within 1e-6
    # relative in RMS and 1e-6 in the camera rotations.  float32 is reported,
    # not held: with camera 0 gauged by a 1e12 diagonal, the reference's
    # float32 Schur reduction loses the translation directions (a first
    # step's translations are half noise: ROADMAP.md Queue C), so whether a
    # float32 run converges depends on its rounding, on the card as on the
    # CPU.
    from sks_tpu_torch.slam.ba import (
        gauss_newton_step,
        rms_reprojection,
        run_ba,
        synth_ba_problem,
    )

    ba = {"cams": 20, "points": 10_240, "iters": 8, "damping": 1e-4,
          "noise_px": 0.5}
    for dt in (torch.float64, torch.float32):
        _, init_ba = synth_ba_problem(
            torch.Generator(device=dev).manual_seed(0), dtype=dt)
        _, ops = esm_bench.dispatched_ops(
            lambda: gauss_newton_step(init_ba, 1e-4))
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        done_ba = run_ba(init_ba, iters=8, damping=1e-4)
        ev1.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        init_cpu = type(init_ba)(*(x.cpu() for x in (
            init_ba.poses, init_ba.points, init_ba.intrinsics, init_ba.obs,
            init_ba.mask)))
        done_cpu = run_ba(init_cpu, iters=8, damping=1e-4)
        ba[str(dt)[6:]] = {
            "observations": int(init_ba.mask.sum().item()),
            "device_ms_per_step": ev0.elapsed_time(ev1) / 8,
            "host_ms_per_step": host_ms / 8,
            "aten_ops_per_step": sum(ops.values()),
            "rms_before_px": rms_reprojection(init_ba).item(),
            "rms_after_px": rms_reprojection(done_ba).item(),
            "rms_after_cpu_px": rms_reprojection(done_cpu).item(),
            "rotation_card_vs_cpu": (done_ba.poses[:, :3, :3].cpu()
                                     - done_cpu.poses[:, :3, :3]).abs()
            .max().item()}
    f64 = ba["float64"]
    check(0.8 * 0.5 < f64["rms_after_px"] < 1.2 * 0.5
          and f64["rms_before_px"] > 5.0
          and abs(f64["rms_after_px"] - f64["rms_after_cpu_px"])
          <= 1e-6 * f64["rms_after_cpu_px"]
          and f64["rotation_card_vs_cpu"] <= 1e-6, f"ba: {ba}")
    emit("ba", card=smi, **ba)

    # ---- 5f'. the multi-device layer on a world-size-1 NCCL group ----------
    # Counters at 0 before the phase, read after it (launches_sharded).
    launches_sharded, k2_sharded_err = sharded_phase(
        torch, dev, check, smi, emit, vo_runs, problems["50pct"][0], seq_gen,
        cfg_fused, vo_kw)
    errors["aca_solve_score"] = max(errors["aca_solve_score"],
                                    k2_sharded_err)

    # ---- 5g. the learned models: the four heads, HomographyNet, the IHN ----
    # The JAX models reach no pallas_call: convs and dense layers are cuDNN /
    # cuBLAS in float32 (TF32 off), the IHN's warp eager gathers.  With the
    # counters at 0, no kernel of the repo may launch across the phase.
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    emit("models", card=smi, **models_phase(torch, dev, check))
    check(not any(K.LAUNCHES.values()),
          f"models: the path launched a kernel of the repo: {K.LAUNCHES}")

    # Pairs/s in device and host time, the stage split, launches and the
    # device's idle share (bench/pipeline_fps.py); its launches are its own.
    # One timed call a row, none untimed: the pipeline phase above built
    # every kernel and ran each entry point at these shapes.
    fps = pipeline_fps.run(runs=1)
    emit("pipeline_fps", **fps)
    for trace, extra in ((fps["trace"], ()),
                         (fps["trace_capstone"], ("vo/posegraph",))):
        want = {"vo/describe", "vo/match", "ransac/draw", "ransac/k2",
                "ransac/tail", "vo/pose", "vo/chain", *extra}
        check(set(trace["stages_host_ms"]) == want
              and trace["busy_ms"] and "ransac/k2" in trace["stages_device_ms"],
              f"the traced {trace['entry']} call: stages and device time "
              f"{ {k: trace[k] for k in ('stages_host_ms', 'stages_device_ms', 'busy_ms')} }")

    # ---- 5h. the headline, the image-grounded benchmark, the wall fixture --
    # Counters at 0 before the three phases, read after (launches_real).
    launches_real = real_paths(torch, dev, check, smi, emit)
    check(launches_real["aca_solve"] >= 1
          and launches_real["aca_solve_score"] >= 1,
          f"the real paths must launch K1 and K2: {launches_real}")

    # ---- 6. port consistency: CUDA paths == the general path on the CPU ----
    # Same minimal sets (indices=) on both sides; the same mask, and H within
    # the bound after Frobenius normalization: 1e-4 where the CUDA path works
    # in float32, 1e-9 in float64 (both sides run the same float64 ops; only
    # reduction order and the CPU's sqrt rounding differ).
    consistency = {}

    def consistent(name, cfg, src, tar, idx, bound, run=ransac_homography):
        res_g = run(None, src, tar, cfg, indices=idx)
        res_c = ransac_homography(None, src.cpu(), tar.cpu(), cfg,
                                  indices=idx.cpu())
        hdiff = (normalize_h(res_g.h.cpu(), "fro")
                 - normalize_h(res_c.h, "fro")).abs().max().item()
        same_mask = torch.equal(res_g.inlier_mask.cpu(), res_c.inlier_mask)
        consistency[name] = {
            "h_max_fro_diff": hdiff, "bound": bound, "same_mask": same_mask,
            "num_inliers_cuda": int(res_g.num_inliers),
            "num_inliers_cpu": int(res_c.num_inliers)}
        check(same_mask and hdiff <= bound,
              f"{name}: CUDA vs general CPU path differ: {consistency[name]}")

    src, tar, _, _ = problems["50pct"][0]
    idx = sample_minimal_sets(gen, src.shape[0], 2048)
    # The fused kernel (K2) against the general path on the CPU.
    consistent("aca_fused", RansacConfig(num_hypotheses=2048, threshold=3.0),
               src, tar, idx, 1e-4, run=ransac_homography_fused)
    # The general path on CUDA (K3 / K4-GE) against the eager op on the CPU.
    for solver in ("sks", "rho_ge"):
        consistent(solver, RansacConfig(num_hypotheses=2048, threshold=3.0,
                                        solver=solver), src, tar, idx, 1e-4)
    # float64 scoring of float32 points (K1, then residual2_fp64).
    consistent("aca_df64_scoring", RansacConfig(
        num_hypotheses=2048, threshold=3.0, df64_scoring=True),
        src, tar, idx, 1e-4)
    # The float64 general path: K5 on CUDA, the eager float64 op on the CPU.
    src64, tar64 = problem64[:2]
    for solver in ("aca", "sks", "rho_ge"):
        consistent(f"{solver}_fp64", RansacConfig(
            num_hypotheses=2048, threshold=3.0, solver=solver),
            src64, tar64, idx, 1e-9)
    # The adaptive loop on the card against the same loop on CPU tensors, on
    # the same draws for the whole schedule: the same number of chunks, and
    # masks agreeing on >= 95% of the points.
    src, tar, _, _ = problem(5, 2000, 0.7)
    cfg = RansacConfig(num_hypotheses=256, threshold=3.0)
    idx_all = sample_minimal_sets(gen, 2000, sum(schedule(1 << 14)))
    chunks = []
    eval_chunk = R._eval_chunk

    def counting_eval_chunk(*args, **kwargs):
        chunks[-1] += 1
        return eval_chunk(*args, **kwargs)

    R._eval_chunk = counting_eval_chunk
    try:
        fits_ad = []
        for s, t, i in ((src, tar, idx_all), (src.cpu(), tar.cpu(),
                                              idx_all.cpu())):
            chunks.append(0)
            fits_ad.append(ransac_homography_adaptive(
                None, s, t, cfg, confidence=0.999, max_chunks=64, indices=i))
    finally:
        R._eval_chunk = eval_chunk
    agree = (fits_ad[0].inlier_mask.cpu() == fits_ad[1].inlier_mask
             ).float().mean().item()
    consistency["aca_adaptive"] = {
        "chunks_cuda": chunks[0], "chunks_cpu": chunks[1],
        "mask_agreement": agree,
        "h_max_fro_diff": (normalize_h(fits_ad[0].h.cpu(), "fro")
                           - normalize_h(fits_ad[1].h, "fro")
                           ).abs().max().item()}
    check(chunks[0] == chunks[1] >= 1 and agree >= 0.95,
          f"adaptive fit, CUDA vs CPU: {consistency['aca_adaptive']}")
    emit("port_consistency", **consistency)

    # ---- 6a. the rectangle solvers and the factorizations on the card ------
    # Exact quads: each rect-family H must carry its source rectangle onto
    # the target quad (median under 0.01 px, finite on >= 99.9%, float32), and
    # each factorization's reconstruct() must be its solver's H (median
    # difference after Frobenius normalization under 1e-4).
    from sks_tpu_torch import ops

    origin = torch.rand((b1, 2), generator=gen, device=dev) * 64.0
    size = 64.0 + torch.rand((b1, 2), generator=gen, device=dev) * 192.0
    rect_family = {}
    for name, h, quad in (
            ("aca_rect", ops.aca_rect(q_tar, origin, size),
             ops.rect_corners(origin, size)),
            ("aca_square", ops.aca_square(q_tar, origin, size[:, 0]),
             ops.rect_corners(origin, size[:, :1].expand(-1, 2))),
            ("aca_qr", ops.aca_qr(q_tar),
             ops.rect_corners(torch.zeros_like(origin),
                              torch.ones_like(size)))):
        reproj = (apply_homography(h, quad) - q_tar).norm(dim=-1)
        finite = torch.isfinite(reproj).all(-1)
        vs_aca = (normalize_h(h, "fro") - normalize_h(ops.aca(quad, q_tar),
                                                      "fro")).abs()
        rect_family[name] = {
            "finite_frac": finite.float().mean().item(),
            "median_reproj_px": reproj[finite].median().item(),
            "median_fro_diff_vs_aca": vs_aca.amax((-2, -1))[finite].median(
                ).item()}
        check(h.device.type == "cuda"
              and rect_family[name]["finite_frac"] >= 0.999
              and rect_family[name]["median_reproj_px"] < 0.01
              and rect_family[name]["median_fro_diff_vs_aca"] < 1e-4,
              f"{name} on the card: {rect_family[name]}")
    for name, factors, solver in (("sks_factors", ops.sks_factors, ops.sks),
                                  ("aca_factors", ops.aca_factors, ops.aca)):
        f = factors(q_src, q_tar)
        d = (normalize_h(f.reconstruct(), "fro")
             - normalize_h(solver(q_src, q_tar), "fro")).abs().amax((-2, -1))
        finite = torch.isfinite(d)
        rect_family[name] = {"finite_frac": finite.float().mean().item(),
                             "median_fro_diff_vs_solver":
                                 d[finite].median().item(),
                             "p999_fro_diff_vs_solver":
                                 d[finite].quantile(0.999).item()}
        check(rect_family[name]["finite_frac"] >= 0.999
              and rect_family[name]["median_fro_diff_vs_solver"] < 1e-4,
              f"{name} on the card: {rect_family[name]}")
    h_e, h_t, h_g, _ = ops.sks_kernel_chain(ops.sks_factors(q_src,
                                                            q_tar).params)
    h_k = ops.sks_factors(q_src, q_tar).h_k
    chain_err = ((h_e @ h_t @ h_g @ h_e - h_k).abs().amax((-2, -1))
                 / h_k.abs().amax((-2, -1)))
    rect_family["sks_kernel_chain"] = {
        "max_rel_err": chain_err[torch.isfinite(chain_err)].max().item()}
    check(rect_family["sks_kernel_chain"]["max_rel_err"] <= 1e-5,
          f"sks_kernel_chain on the card: {rect_family['sks_kernel_chain']}")
    emit("rect_and_factors", batch=b1, **rect_family)

    # ---- 6a'. the fused-versus-eager crossover of the adaptive loop --------
    # (bench/fused_adaptive.py: per chunk and end to end.)  The shipped
    # FUSED_ADAPTIVE_MIN_CHUNK must be what this run measures, or one step of
    # the size grid away (the two chunks tie near a point count's crossover).
    fa = fused_adaptive.run(generators=2)
    grid = list(fused_adaptive.CHUNK_SIZES)
    check(fa["crossover_chunk"] is not None,
          f"the fused chunk never wins: {fa['crossover']}")
    check(R.FUSED_ADAPTIVE_MIN_CHUNK in grid,
          f"FUSED_ADAPTIVE_MIN_CHUNK = {R.FUSED_ADAPTIVE_MIN_CHUNK} is not a "
          f"size of the grid {grid}")
    steps = abs(grid.index(fa["crossover_chunk"])
                - grid.index(R.FUSED_ADAPTIVE_MIN_CHUNK))
    check(steps <= 1,
          f"FUSED_ADAPTIVE_MIN_CHUNK = {R.FUSED_ADAPTIVE_MIN_CHUNK} is "
          f"{steps} grid steps from the measured {fa['crossover_chunk']}")
    for row in fa["end_to_end"]:
        check(row["corner_err_px_max"] < 1.0, f"adaptive fit: {row}")
    emit("fused_adaptive", grid_steps_from_shipped=steps, **fa)

    # ---- 6b. the Jacobi rotation's short forms (csrc/angle_check.cu): its
    # hand-written square root and reciprocal against the IEEE ones (every
    # float32 of [1, 2], NaN), DivTiny against the IEEE division (2^28
    # pairs), the whole rotation on special values.
    angles = KB.angle_check()
    check(angles["sqrt_mismatches"] == 0 and angles["rcp_mismatches"] == 0
          and angles["division_mismatches"] == 0
          and angles["angle_mismatches"] == 0
          and angles["subnormal_quotients"] >= 1 << 20,
          f"the rotation's short forms are not exact: {angles}")
    emit("angle_check", **angles)

    # ---- 6c. yardsticks: the library calls that do the dominant step of
    # NDLT (9x9 eigh), HO (3x3 eigh) and GPT (8x8 solve), float32.  The port
    # never calls them, and none computes a kernel's whole function.
    def yardstick(name, make, call, batches=(10_000, b1), budget_ms=15_000):
        """Device ms of ``call(make(b))`` per batch size.  A batch whose time,
        scaled from the one before, would pass ``budget_ms`` is cut to the
        largest power of two that fits, and says so (``cut_from``)."""
        rows = []
        for b in batches:
            row = {"call": name, "batch": b}
            if rows and rows[-1]["ms"] * b / rows[-1]["batch"] > budget_ms:
                fits = budget_ms / rows[-1]["ms"] * rows[-1]["batch"]
                row.update(batch=max(rows[-1]["batch"],
                                     1 << int(fits).bit_length() - 1),
                           cut_from=b)
            x = make(row["batch"])
            try:
                call(x)
            except RuntimeError as exc:
                # A yardstick the installed libraries cannot run is reported
                # as such; no kernel or path of the port depends on it.
                rows.append({**row, "ms": None,
                             "error": str(exc).splitlines()[0][:200]})
                break
            torch.cuda.synchronize()
            row["ms"] = statistics.median(
                table8.device_ms(lambda: call(x), 1) for _ in range(3))
            rows.append(row)
        return rows

    def spd(b, n):
        a = torch.randn((b, n, n), generator=gen, device=dev)
        return a @ a.transpose(1, 2) + n * torch.eye(n, device=dev)

    yard = (
        yardstick("torch.linalg.eigh (B, 9, 9)", lambda b: spd(b, 9),
                  torch.linalg.eigh)
        + yardstick("torch.linalg.eigh (B, 3, 3)", lambda b: spd(b, 3),
                    torch.linalg.eigh)
        # The same eigenvectors of a symmetric PSD matrix by another call.
        + yardstick("torch.linalg.svd (B, 9, 9)", lambda b: spd(b, 9),
                    torch.linalg.svd)
        + yardstick("torch.linalg.svd (B, 3, 3)", lambda b: spd(b, 3),
                    torch.linalg.svd)
        + yardstick("torch.linalg.solve (B, 8, 8)",
                    lambda b: (spd(b, 8), torch.randn((b, 8, 1), generator=gen,
                                                      device=dev)),
                    lambda ab: torch.linalg.solve(*ab)))
    emit("library_yardsticks", card=smi, dtype="float32", rows=yard)

    # ---- 7. times (CUDA events, median of 25 after warm-up) ----------------
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        s, t = s_soa.to(dt), t_soa.to(dt)
        ms_k, ms_p = paired_ms(lambda: K.aca_solve_soa(s, t),
                               lambda: K.aca_solve_soa_plain(s, t))
        nbytes = 25 * b1 * s.element_size()
        times[f"k1_{str(dt)[6:]}"] = {
            "B": b1, "ms": ms_k, "plain_ms": ms_p,
            "hyp_per_s": b1 / (ms_k * 1e-3), "plain_hyp_per_s": b1 / (ms_p * 1e-3),
            "GB_per_s": nbytes / (ms_k * 1e-3) / 1e9,
            "plain_GB_per_s": nbytes / (ms_p * 1e-3) / 1e9,
        }
    for b, pairs in ((b2, 1), (2048, 1), (2048, 8)):
        s, t, pts, w = score_problem(2000, pairs, b)
        if pairs == 1:
            s, t, pts, w = s[0], t[0], pts[0], w[0]
        ones = torch.ones_like(w)
        ms_k, ms_p = paired_ms(
            lambda: K.aca_solve_score_soa(s, t, pts, 9.0, ones),
            lambda: K.aca_solve_score_soa_plain(s, t, pts, 9.0, ones,
                                                "inliers"),
        )
        hyp_blocks, chunks, chunk_points = K.score_grid(pairs, b, 2000)
        key = f"k2_B{b}_N2000" + (f"_P{pairs}" if pairs > 1 else "")
        times[key] = {
            "B": b, "N": 2000, "pairs": pairs, "ms": ms_k, "plain_ms": ms_p,
            "bound_ms": k2_bound(b, pairs)[0],
            "pairs_per_s": pairs * b * 2000 / (ms_k * 1e-3),
            "grid": [hyp_blocks, chunks, pairs], "chunk_points": chunk_points,
            "blocks": hyp_blocks * chunks * pairs,
            "warps_per_sm": hyp_blocks * chunks * pairs * 8 / 132,
        }
    src, tar, _, _ = problems["50pct"][0]
    fh = lambda: sks_tpu_torch.find_homography(src, tar, max_iters=2048)  # noqa: E731
    for _ in range(3):
        fh()
    torch.cuda.synchronize()
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        h, _ = fh()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    fh_ms = statistics.median(lat)
    k2_ms = times["k2_B2048_N2000"]["ms"]

    # The fit's stages on their own (host clock to a synchronize): the fused
    # batch (K2 + the eager top-K re-score), the IRLS refit of the top-K
    # (weighted NDLT with the 9x9 Jacobi, in its kernel), and the annealed
    # LM polish.
    def host_ms(fn, runs=10):
        fn()
        torch.cuda.synchronize()
        acc = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            acc.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(acc)

    cfg = RansacConfig(num_hypotheses=2048, threshold=3.0, fused=True)
    h_top, _, _ = R._eval_chunk_fused(None, src, tar, cfg, None)
    times["find_homography_50pct_2048"] = {
        "host_ms_median": fh_ms, "host_ms_min": min(lat), "host_ms_max": max(lat),
        "k2_ms": k2_ms, "k2_share": k2_ms / fh_ms,
        "stage_host_ms": {
            "fused_batch_and_rescore": host_ms(
                lambda: R._eval_chunk_fused(None, src, tar, cfg, None)),
            "irls_refine_top4": host_ms(
                lambda: R._irls_refine(h_top, src, tar, 2, 3.0)),
            "anneal_polish": host_ms(
                lambda: P.anneal_polish(h_top[0], src, tar, 3.0)),
        },
    }
    # The IRLS refit of the top-4 in its kernel (irls_refine, one launch)
    # against its plain version, the eager refit, on the card: the fit's
    # shape (N = 2,000) and a VO pair's (the first 384 of its matches),
    # both top-4s of a 2,048-hypothesis fused chunk.
    from sks_tpu_torch.bench.table8 import median_device_ms
    from sks_tpu_torch.kernels import irls_cuda as KI

    irls = {}
    for n in (2000, 384):
        src_n, tar_n = src[:n], tar[:n]
        top, _, _ = R._eval_chunk_fused(None, src_n, tar_n, cfg, None)
        torch.cuda.synchronize()
        before = K.LAUNCHES["irls_refine"]
        h_k = R._irls_refine(top, src_n, tar_n, 2, 3.0)
        torch.cuda.synchronize()
        launched = K.LAUNCHES["irls_refine"] - before
        h_e = R._irls_refine_eager(top, src_n, tar_n, 2, 3.0, None,
                                   "inliers", 9.0, False)
        _, inl_k = R.score_hypotheses(h_k, src_n, tar_n, 3.0)
        _, inl_e = R.score_hypotheses(h_e, src_n, tar_n, 3.0)
        row = {
            "N": n, "K": top.shape[0], "launches_per_call": launched,
            "kernel_us": 1e3 * median_device_ms(
                lambda: KI.irls_refine(top, src_n, tar_n, 2, 3.0), runs=5,
                reps=20),
            "kernel_host_ms": host_ms(
                lambda: R._irls_refine(top, src_n, tar_n, 2, 3.0)),
            "plain_host_ms": host_ms(
                lambda: R._irls_refine_eager(top, src_n, tar_n, 2, 3.0, None,
                                             "inliers", 9.0, False), runs=3),
            "corner_gap_px": (apply_homography(h_k, corners)
                              - apply_homography(h_e, corners)
                              ).norm(dim=-1).max().item(),
            "mask_flips": int((inl_k != inl_e).sum(-1).max()),
            "same_bits_twice": torch.equal(
                h_k, R._irls_refine(top, src_n, tar_n, 2, 3.0)),
            "moved": not torch.equal(h_k, top)}
        irls[f"N{n}"] = row
        check(launched == 1 and row["corner_gap_px"] <= 1e-2
              and row["mask_flips"] <= 2 and row["same_bits_twice"]
              and row["moved"], f"irls_refine against the eager refit: {row}")
    times["irls_refine"] = irls
    # The annealed LM polish of the best candidate in its kernel
    # (anneal_polish, one launch) against its plain version (on the CPU) and
    # the eager polish, on the card, at the same two shapes: within 1e-2 px
    # at the corners, as the refit.  The three differ in the order of their
    # sums only, but a float32 LM stops anywhere in a flat region of its
    # cost: 1.3e-4 px is typical, 1.8e-3 px was read at N = 384 on an
    # H100, and a point that sits on a level's threshold and flips moves a
    # result by ~0.07 px (1 CPU seed in 30).
    from sks_tpu_torch.kernels import polish_cuda as KP

    # The polish's schedule: robust.polish.anneal_polish's defaults.
    schedule = tuple(inspect.signature(P.anneal_polish).parameters[k].default
                     for k in ("levels", "iters"))
    polish = {}
    for n in (2000, 384):
        src_n, tar_n = src[:n], tar[:n]
        top, _, _ = R._eval_chunk_fused(None, src_n, tar_n, cfg, None)
        h0 = top[0]
        torch.cuda.synchronize()
        before = K.LAUNCHES["anneal_polish"]
        h_k = P.anneal_polish(h0, src_n, tar_n, 3.0)
        torch.cuda.synchronize()
        launched = K.LAUNCHES["anneal_polish"] - before
        h_e = P._anneal_polish_eager(h0, src_n, tar_n, 3.0, None, *schedule)
        h_p = KP.anneal_polish_plain(h0.cpu(), src_n.cpu(), tar_n.cpu(), 3.0,
                                     None, *schedule)
        row = {
            "N": n, "launches_per_call": launched,
            "kernel_us": 1e3 * median_device_ms(
                lambda: KP.anneal_polish(h0, src_n, tar_n, 3.0, None,
                                         *schedule), runs=5, reps=20),
            "kernel_host_ms": host_ms(
                lambda: P.anneal_polish(h0, src_n, tar_n, 3.0)),
            "eager_host_ms": host_ms(
                lambda: P._anneal_polish_eager(h0, src_n, tar_n, 3.0, None,
                                               *schedule), runs=3),
            "corner_gap_plain_px": (apply_homography(h_k.cpu(), corners.cpu())
                                    - apply_homography(h_p, corners.cpu())
                                    ).norm(dim=-1).max().item(),
            "corner_gap_eager_px": (apply_homography(h_k, corners)
                                    - apply_homography(h_e, corners)
                                    ).norm(dim=-1).max().item(),
            "same_bits_twice": torch.equal(
                h_k, P.anneal_polish(h0, src_n, tar_n, 3.0)),
            "moved": not torch.equal(h_k, h0)}
        polish[f"N{n}"] = row
        check(launched == 1 and row["corner_gap_plain_px"] <= 1e-2
              and row["corner_gap_eager_px"] <= 1e-2
              and row["same_bits_twice"] and row["moved"],
              f"anneal_polish against its plain version and the eager "
              f"polish: {row}")
    times["anneal_polish"] = polish
    # The port's Table 8: every kernel, its plain SoA version and the eager
    # AoS solver at the reference's smallest, middle and largest batches.
    t8 = table8.run_table(batches=(1, 10_000, b1))
    times["table8"] = t8
    # The same in float64: K5, its plain version and the eager float64 op,
    # and the accuracy of the float32 kernels against K5 on exact quads.
    t8_64 = fp64_table.run_table(batches=(1, 10_000, b1))
    times["table8_fp64"] = t8_64
    times["fp64_accuracy"] = fp64_table.accuracy_check()
    times["ndlt_fp64_accuracy"] = fp64_table.ndlt_fp64_accuracy()
    emit("times", card=smi, **times)

    # ---- contract lines -----------------------------------------------------
    print(smi, flush=True)
    # K1 and K2 at their main-path shapes (paired timing above); K3, K4 and
    # K5 at B = 2^20 from the Table-8 rows, kernel and plain version alike.
    timed = {"aca_solve": (times["k1_float32"]["ms"],
                           times["k1_float32"]["plain_ms"]),
             "aca_solve_score": (times[f"k2_B{b2}_N2000"]["ms"],
                                 times[f"k2_B{b2}_N2000"]["plain_ms"])}
    for rows, registry in ((t8, SOLVE_KERNELS), (t8_64, FP64_SOLVE_KERNELS)):
        for r in rows:
            key = registry[r["solver"]].key
            if r["batch"] == b1 and key not in timed:
                timed[key] = (r["kernel_ms"], r["plain_soa_ms"])
    # The bound of each kernel at the shape its time was taken at
    # (bench/roofline.py): bytes at 3.35 TB/s against arithmetic, counted
    # from the plain version by element type, each type at its own rate: 67
    # TFLOP/s in float32 and 34 in float64 (K5-ho and K5-ndlt do both).
    bounds = {"aca_solve_score": k2_bound(b2, 1)}
    work = {"aca_solve_score": {"bytes_per_hyp": 68, "ops_per_hyp": per_hyp,
                                "ops_per_pair": per_pair}}
    for registry, dt in ((SOLVE_KERNELS, torch.float32),
                         (FP64_SOLVE_KERNELS, torch.float64)):
        for solve in registry.values():
            ops = roofline.solve_ops(solve.plain, dt)
            nbytes = 25 * torch.finfo(dt).bits // 8
            bounds[solve.key] = roofline.bound_ms(
                b1 * nbytes, {k: b1 * v for k, v in ops.items()})
            work[solve.key] = {"bytes_per_hyp": nbytes, "ops_per_hyp": ops}
    emit("bounds", card=smi, memory_bytes_per_s=roofline.H100_BYTES_PER_S,
         flops=roofline.H100_FLOPS,
         work=work)
    # library_ms: no single PyTorch call computes any of these functions
    # whole (the yardsticks above time a dominant step, not the function).
    # launches: the main path's; launches_adaptive: the adaptive path's;
    # launches_pipeline: the VO pipeline's (frames_to_poses fused and
    # general, planar_slam raw and smoothed); launches_sharded: the sharded
    # phase's (the multi-device layer at world size 1); launches_real: the
    # headline's, the image-grounded benchmark's and the wall fixture's.
    # Each path was driven with the counts set to 0 just before it.
    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name],
         "launches_adaptive": launches_adaptive[name],
         "launches_pipeline": launches_pipeline[name],
         "launches_real": launches_real[name],
         "launches_sharded": launches_sharded[name],
         "max_abs_err": errors[name],
         "ms": timed[name][0], "plain_ms": timed[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name, (source, replaces) in kernel_sources.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--gloo-rank":
        sys.exit(gloo_rank(int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
