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
    """Each kernel's registers and spills from ``nvcc -Xptxas -v`` output."""
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
    return out


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
    from sks_tpu_torch.bench import fp64_table, table8
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
        for b in (b1, 1000):
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
    check(launches["aca_solve_score"] >= 2 and launches["sks_solve"] >= 2
          and launches["ge_solve"] >= 2
          and all(launches[k] >= 1 for k in kernel_sources),
          f"main path launches {launches}")
    check(launches_fp64_fits["fp64_aca"] >= 1
          and launches_fp64_fits["fp64_sks"] >= 1
          and launches_fp64_fits["aca_solve_score"] == 0,
          f"float64 fits must run K5 and not K2: {launches_fp64_fits}")
    emit("main_path", **main)

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
    emit("port_consistency", **consistency)

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
    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errors[name],
         "ms": timed[name][0], "plain_ms": timed[name][1]}
        for name, (source, replaces) in kernel_sources.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
