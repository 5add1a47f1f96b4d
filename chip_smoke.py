#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU, and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's hand-written CUDA kernels from ``sks_tpu_torch/csrc``
(``nvcc``, sm_90a), holds each against its plain PyTorch version at the main
path's shapes, drives the main path (the batched ACA solve and
``find_homography``) through the kernels with the launch counters reset, checks
the results against the synthetic truth, holds the fused CUDA path against the
port's general path on the CPU, and times kernels and path with CUDA events.

Output: one JSON line per phase; then the card's name and power limit as
``nvidia-smi`` prints them; then a JSON line with every kernel's route, source,
launches on the main path, error against its plain version and times; and last
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without the last line.  Without a CUDA device, or outside the
repository, it exits non-zero at once.  Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REPLACES = {
    "aca_solve": "sks_tpu/kernels/aca_pallas.py:69",
    "aca_solve_score": "sks_tpu/kernels/aca_pallas.py:197",
}
SOURCE = "sks_tpu_torch/csrc/aca.cu"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``, from CUDA events around ``reps`` calls.

    A spin kernel first holds the stream while the host enqueues all the
    calls, so the events time the device's work back to back and not the
    host's launch overhead (a K1 launch is shorter than its Python wrapper).
    """
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's clocks
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel, plain, runs: int = 25, reps: int = 10):
    """Median device ms per call of a kernel and of its plain version, timed
    in turns (plain, kernel, kernel, plain, ...) after a warm-up."""
    import torch

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
    from sks_tpu_torch.geom.homography import apply_homography, normalize_h
    from sks_tpu_torch.kernels import _build
    from sks_tpu_torch.kernels import aca_cuda as K
    from sks_tpu_torch.robust import polish as P
    from sks_tpu_torch.robust import ransac as R
    from sks_tpu_torch.robust.ransac import (
        RansacConfig,
        fused_kernel_threshold,
        ransac_homography,
        ransac_homography_fused,
        sample_minimal_sets,
    )
    from sks_tpu_torch.utils.synth import (
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
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(time.perf_counter() - t0, 3), nvcc=_build.find_nvcc(),
         flags=list(_build.NVCC_FLAGS), ptxas=ptxas)

    gen = torch.Generator(device=dev).manual_seed(20261016)
    errors = {"aca_solve": 0.0, "aca_solve_score": 0.0}

    # ---- 3. K1 against its plain version -----------------------------------
    b1 = 1 << 20
    q_src, q_tar = random_quad_pairs(gen, b1)
    s_soa, t_soa = K.to_soa(q_src), K.to_soa(q_tar)
    k1 = []
    for b in (b1, 1000):
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
    b2 = 65536
    k2 = []
    for n in (2000, 2047):
        src, tar, _ = random_correspondences(gen, (), n, 0.5)
        n_out = n // 2
        tar = tar.clone()
        tar[:n_out] = torch.rand((n_out, 2), generator=gen, device=dev) * 640.0
        idx = sample_minimal_sets(gen, n, b2)
        s, t = K.to_soa(src[idx]), K.to_soa(tar[idx])
        pts = torch.cat([src.T, tar.T]).contiguous()
        w = (torch.rand(n, generator=gen, device=dev) >= 0.1).float()
        for scoring in ("inliers", "msac", "magsac"):
            thr = fused_kernel_threshold(
                RansacConfig(threshold=3.0, scoring=scoring))
            sk = K.aca_solve_score_soa(s, t, pts, thr, w, scoring)
            sp = K.aca_solve_score_soa_plain(s, t, pts, thr, w, scoring)
            torch.cuda.synchronize()
            d = (sk - sp).abs()
            maxd = d.max().item()
            errors["aca_solve_score"] = max(errors["aca_solve_score"], maxd)
            case = {"N": n, "scoring": scoring, "max_abs_diff": maxd,
                    "max_score": sk.max().item()}
            if scoring == "inliers":
                frac = (d == 0).float().mean().item()
                case["equal_frac"] = frac
                check(frac >= 0.999 and maxd <= 1.0,
                      f"K2 inliers N={n}: equal on {frac}, max diff {maxd}")
            else:
                ok = torch.allclose(sk, sp, rtol=1e-5, atol=1e-4)
                rel = (d / sp.abs().clamp(min=1e-3)).max().item()
                case["max_rel_diff"] = rel
                check(ok, f"K2 {scoring} N={n}: max rel diff {rel}")
            k2.append(case)
    emit("k2_vs_plain", B=b2, cases=k2)

    # ---- 5. main path, through the kernels ---------------------------------
    def problem(seed, n, outlier_frac):
        """n matches with 0.5 px noise; a random outlier_frac of them junk."""
        g = torch.Generator(device=dev).manual_seed(seed)
        src, tar, h = random_correspondences(g, (), n, 0.5)
        out = torch.randperm(n, generator=g, device=dev)[:int(n * outlier_frac)]
        tar = tar.clone()
        tar[out] = torch.rand((out.numel(), 2), generator=g, device=dev) * 640.0
        true_inl = torch.ones(n, dtype=torch.bool, device=dev)
        true_inl[out] = False
        return src, tar, h, true_inl

    corners = torch.tensor([[0.0, 0.0], [640.0, 0.0], [640.0, 480.0],
                            [0.0, 480.0]], device=dev)
    problems = {"50pct": (problem(1, 2000, 0.5), 2048),
                "90pct": (problem(2, 2000, 0.9), 65536)}

    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    # The bench.py headline: a 2^20 batch of quads solved by K1.
    h_batch = K.aca_h_cuda(q_src, q_tar)
    fits = {}
    for name, ((src, tar, h_true, true_inl), iters) in problems.items():
        fits[name] = sks_tpu_torch.find_homography(
            src, tar, ransac_reproj_threshold=3.0, max_iters=iters)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)

    reproj = (apply_homography(h_batch, q_src) - q_tar).norm(dim=-1)
    finite = torch.isfinite(reproj).all(-1)
    med = reproj[finite].median().item()
    main = {"launches": launches, "k1_batch": b1,
            "k1_finite_frac": finite.float().mean().item(),
            "k1_median_reproj_px": med}
    check(main["k1_finite_frac"] > 0.999 and med < 0.01,
          f"K1 batch solve: {main}")
    for name, ((src, tar, h_true, true_inl), iters) in problems.items():
        h, mask = fits[name]
        check(h.shape == (3, 3) and mask.shape == (src.shape[0],)
              and mask.dtype == torch.bool, f"{name}: output shapes")
        err = (apply_homography(h, corners)
               - apply_homography(h_true, corners)).norm(dim=-1).mean().item()
        agree = (mask == true_inl).float().mean().item()
        main[name] = {"max_iters": iters, "corner_err_px": err,
                      "inlier_agreement": agree,
                      "num_inliers": int(mask.sum().item())}
        check(err < 1.0 and agree >= 0.95, f"{name}: {main[name]}")
    check(launches["aca_solve"] >= 1 and launches["aca_solve_score"] >= 2,
          f"main path launches {launches}")
    emit("main_path", **main)

    # ---- 6. port consistency: fused on CUDA == general on CPU --------------
    src, tar, _, _ = problems["50pct"][0]
    cfg = RansacConfig(num_hypotheses=2048, threshold=3.0)
    idx = sample_minimal_sets(gen, src.shape[0], cfg.num_hypotheses)
    res_f = ransac_homography_fused(None, src, tar, cfg, indices=idx)
    res_c = ransac_homography(None, src.cpu(), tar.cpu(), cfg,
                              indices=idx.cpu())
    hdiff = (normalize_h(res_f.h.cpu(), "fro")
             - normalize_h(res_c.h, "fro")).abs().max().item()
    same_mask = torch.equal(res_f.inlier_mask.cpu(), res_c.inlier_mask)
    emit("port_consistency", h_max_fro_diff=hdiff, same_mask=same_mask,
         num_inliers_cuda=int(res_f.num_inliers), num_inliers_cpu=int(res_c.num_inliers))
    check(same_mask and hdiff <= 1e-4, "fused CUDA vs general CPU path differ")

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
    src, tar, _, _ = problems["50pct"][0]
    pts = torch.cat([src.T, tar.T]).contiguous()
    for b in (b2, 2048):
        idx = sample_minimal_sets(gen, src.shape[0], b)
        s, t = K.to_soa(src[idx]), K.to_soa(tar[idx])
        ms_k, ms_p = paired_ms(
            lambda: K.aca_solve_score_soa(s, t, pts, 9.0),
            lambda: K.aca_solve_score_soa_plain(s, t, pts, 9.0,
                                                torch.ones(pts.shape[1], device=dev),
                                                "inliers"),
        )
        times[f"k2_B{b}_N2000"] = {
            "B": b, "N": 2000, "ms": ms_k, "plain_ms": ms_p,
            "pairs_per_s": b * 2000 / (ms_k * 1e-3),
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
    # (weighted NDLT with the 9x9 Jacobi), and the annealed LM polish.
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
    emit("times", card=smi, **times)

    # ---- contract lines -----------------------------------------------------
    print(smi, flush=True)
    kernels = [
        {"name": "aca_solve", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["aca_solve"], "launches": launches["aca_solve"],
         "max_abs_err": errors["aca_solve"], "ms": times["k1_float32"]["ms"],
         "plain_ms": times["k1_float32"]["plain_ms"]},
        {"name": "aca_solve_score", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["aca_solve_score"],
         "launches": launches["aca_solve_score"],
         "max_abs_err": errors["aca_solve_score"],
         "ms": times[f"k2_B{b2}_N2000"]["ms"],
         "plain_ms": times[f"k2_B{b2}_N2000"]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
