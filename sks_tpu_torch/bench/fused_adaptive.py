"""The adaptive loop on the card: the fused-versus-eager crossover, and fits.

The counterpart of ``sks_tpu/bench/fused_adaptive.py``, and the measurement
behind ``robust.ransac.FUSED_ADAPTIVE_MIN_CHUNK``.  Two tables, float32, on
one CUDA card:

1. **Per chunk** (:func:`crossover`): one ``_eval_chunk`` (draw + solve +
   score + top-K) with ``fused=True`` (the fused kernel K2, then the eager
   re-score of its top-K) against ``fused=False`` (the solve kernel K1, then
   eager scoring of every hypothesis), per chunk size and point count.
   ``*_device_ms`` is device time by CUDA events
   (``bench.table8.device_ms``); ``*_host_ms`` is the host clock to a
   ``synchronize``, the median of ``HOST_RUNS`` calls taken in turns
   (eager, fused, fused, eager, ...): the loop waits for each chunk before
   it decides on the next, so the host time is what a chunk costs it, and
   the crossover is read from it (:func:`crossover_chunk`: the smallest
   size from which the fused chunk is no slower at every point count).
   ``*_peak_bytes`` is ``torch.cuda.max_memory_allocated()`` over the
   device-time runs: the eager chunk holds several (B, N) float32
   temporaries.
2. **End to end** (:func:`end_to_end`): ``find_homography(confidence=0.999)``
   on N = 2,000 points at a low and a high outlier rate, ``method='ransac'``
   (eager chunks) and ``method='fused'``: chunks evaluated (K1 and K2
   launches), hypotheses drawn, host ms to a ``synchronize`` (median over
   generators seeded apart) and the corner error against the true H.

Run on a machine with a CUDA card, from the repository root:

    python -m sks_tpu_torch.bench.fused_adaptive [--out PATH]
"""

from __future__ import annotations

import json
import statistics
import time

import torch

import sks_tpu_torch.robust.ransac as ransac
from sks_tpu_torch.bench.table8 import card_line, median_device_ms
from sks_tpu_torch.geom.homography import apply_homography
from sks_tpu_torch.kernels import LAUNCHES
from sks_tpu_torch.robust.api import find_homography
from sks_tpu_torch.utils.synth import random_correspondences

__all__ = [
    "CHUNK_SIZES",
    "POINT_COUNTS",
    "crossover",
    "crossover_chunk",
    "end_to_end",
    "run",
    "to_markdown",
]

#: The size grid of the per-chunk table: the schedule's own stages from 256
#: (x4 a stage) and its cap, ``ransac.ADAPTIVE_MAX_CHUNK``.
CHUNK_SIZES = (256, 1024, 4096, 16384, 65536, 131072)
POINT_COUNTS = (512, 2000)
HOST_RUNS = 15
DEVICE_RUNS = 3
#: (label, outlier fraction, max_iters) of the end-to-end fits.
FITS = (("outliers_0.50", 0.5, 1 << 21), ("outliers_0.95", 0.95, 1 << 21))


def contaminated(generator: torch.Generator, n: int, outlier_frac: float,
                 noise: float = 0.5):
    """(src, tar, H_true, true_inlier_mask) on the generator's device: n
    matches with ``noise`` px of noise, a random ``outlier_frac`` of the
    targets replaced by uniform junk."""
    dev = generator.device
    src, tar, h = random_correspondences(generator, (), n, noise)
    out = torch.randperm(n, generator=generator, device=dev)[
        :int(n * outlier_frac)]
    tar = tar.clone()
    tar[out] = torch.rand((out.numel(), 2), generator=generator,
                          device=dev) * 640.0
    inl = torch.ones(n, dtype=torch.bool, device=dev)
    inl[out] = False
    return src, tar, h, inl


def _host_ms_in_turns(fns: dict, runs: int) -> dict:
    """Median host ms of each ``fn()`` to a ``synchronize``, after a warm-up;
    the functions run in turns, the order reversed every round, so that a
    drift of the shared host's clock falls on all alike."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    acc = {name: [] for name in fns}
    for i in range(runs):
        for name in (reversed(fns) if i % 2 else fns):
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            acc[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(ms) for name, ms in acc.items()}


def crossover(point_counts=POINT_COUNTS, sizes=CHUNK_SIZES, seed: int = 0,
              host_runs: int = HOST_RUNS) -> list[dict]:
    """One fused and one eager chunk evaluation per chunk size and point
    count: device ms, host ms and peak bytes each.  Row dicts."""
    if not torch.cuda.is_available():
        raise RuntimeError("crossover times chunks on the card and needs one")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for n in point_counts:
        src, tar, _, _ = contaminated(gen, n, 0.6)
        for b in sizes:
            row = {"N": n, "chunk": b}
            chunks = {}
            for name, fused in (("eager", False), ("fused", True)):
                cfg = ransac.RansacConfig(num_hypotheses=b, threshold=3.0,
                                          fused=fused)

                def chunk(cfg=cfg):
                    return ransac._eval_chunk(gen, src, tar, cfg, None)

                chunks[name] = chunk
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                row[f"{name}_device_ms"] = median_device_ms(chunk,
                                                            DEVICE_RUNS)
                row[f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated()
            for name, ms in _host_ms_in_turns(chunks, host_runs).items():
                row[f"{name}_host_ms"] = ms
            row["fused_wins"] = row["fused_host_ms"] <= row["eager_host_ms"]
            rows.append(row)
    return rows


def crossover_chunk(rows) -> int | None:
    """The smallest chunk size of the grid from which the fused chunk is no
    slower than the eager one, by host ms, at that size and every larger one,
    at every point count of the table; None if it loses at the largest.

    Near a point count's own crossover the two chunks tie within the spread
    of the host's clock, so the value can move by one size from run to run.
    """
    best = None
    for size in sorted({r["chunk"] for r in rows}, reverse=True):
        if not all(r["fused_wins"] for r in rows if r["chunk"] == size):
            break
        best = size
    return best


def end_to_end(n_points: int = 2000, fits=FITS, generators: int = 10,
               confidence: float = 0.999) -> list[dict]:
    """``find_homography(confidence=)`` per outlier rate and method."""
    if not torch.cuda.is_available():
        raise RuntimeError("end_to_end times fits on the card and needs one")
    dev = torch.device("cuda", 0)
    corners = torch.tensor([[0.0, 0.0], [640.0, 0.0], [640.0, 480.0],
                            [0.0, 480.0]], device=dev)
    rows = []
    for label, frac, max_iters in fits:
        src, tar, h_true, inl = contaminated(
            torch.Generator(device=dev).manual_seed(int(frac * 100)),
            n_points, frac)
        sizes = [c for c, k in ransac._chunk_schedule(
            256, -(-max_iters // 256), 4, 2, ransac.ADAPTIVE_MAX_CHUNK)
            for _ in range(k)]
        for method in ("ransac", "fused"):
            def fit(seed):
                return find_homography(
                    src, tar, method=method, confidence=confidence,
                    max_iters=max_iters,
                    generator=torch.Generator(device=dev).manual_seed(seed))

            fit(0)  # warm-up
            torch.cuda.synchronize()
            ms, chunks, fused_chunks, errs, agree = [], [], [], [], []
            for seed in range(1, generators + 1):
                before = dict(LAUNCHES)
                t0 = time.perf_counter()
                h, mask = fit(seed)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                k1 = LAUNCHES["aca_solve"] - before["aca_solve"]
                k2 = LAUNCHES["aca_solve_score"] - before["aca_solve_score"]
                chunks.append(k1 + k2)
                fused_chunks.append(k2)
                errs.append((apply_homography(h, corners)
                             - apply_homography(h_true, corners)
                             ).norm(dim=-1).mean().item())
                agree.append((mask == inl).float().mean().item())
            rows.append({
                "problem": label, "N": n_points, "outlier_frac": frac,
                "method": method, "confidence": confidence,
                "max_iters": max_iters, "generators": generators,
                "host_ms_median": statistics.median(ms),
                "host_ms_min": min(ms), "host_ms_max": max(ms),
                "chunks": chunks, "fused_chunks": fused_chunks,
                "hypotheses": [sum(sizes[:c]) for c in chunks],
                "corner_err_px_median": statistics.median(errs),
                "corner_err_px_max": max(errs),
                "inlier_agreement_min": min(agree),
            })
    return rows


def to_markdown(result) -> str:
    lines = [
        "| N | chunk | eager host ms | fused host ms | eager device ms "
        "| fused device ms | eager peak MB | fused peak MB | fused wins |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in result["crossover"]:
        lines.append(
            f"| {r['N']} | {r['chunk']} | {r['eager_host_ms']:.3f} "
            f"| {r['fused_host_ms']:.3f} | {r['eager_device_ms']:.3f} "
            f"| {r['fused_device_ms']:.3f} "
            f"| {r['eager_peak_bytes'] / 1e6:.0f} "
            f"| {r['fused_peak_bytes'] / 1e6:.0f} | {r['fused_wins']} |")
    lines += [
        "",
        "| problem | method | host ms median (min, max) | chunks (fused) "
        "| hypotheses | corner err px median (max) |",
        "|---|---|---|---|---|---|",
    ]
    for r in result["end_to_end"]:
        lines.append(
            f"| {r['problem']} | {r['method']} | {r['host_ms_median']:.1f} "
            f"({r['host_ms_min']:.1f}, {r['host_ms_max']:.1f}) "
            f"| {statistics.median(r['chunks'])} "
            f"({statistics.median(r['fused_chunks'])}) "
            f"| {statistics.median(r['hypotheses'])} "
            f"| {r['corner_err_px_median']:.3f} "
            f"({r['corner_err_px_max']:.3f}) |")
    return "\n".join(lines)


def run(generators: int = 10, host_runs: int = HOST_RUNS) -> dict:
    """Both tables, the crossover they give and the shipped constant."""
    rows = crossover(host_runs=host_runs)
    return {
        "card": card_line(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "dtype": "float32",
        "crossover": rows,
        "crossover_chunk": crossover_chunk(rows),
        "gate_shipped": ransac.FUSED_ADAPTIVE_MIN_CHUNK,
        "end_to_end": end_to_end(generators=generators),
    }


def main(argv=None) -> None:
    """Console entry point: print both tables; ``--out`` writes their JSON."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--generators", type=int, default=10,
                    help="fits per end-to-end row")
    args = ap.parse_args(argv)
    result = run(generators=args.generators)
    print(f"card: {result['card']}")
    print(to_markdown(result))
    print(f"crossover chunk (fused no slower from, at every N): "
          f"{result['crossover_chunk']}; FUSED_ADAPTIVE_MIN_CHUNK shipped "
          f"{result['gate_shipped']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
