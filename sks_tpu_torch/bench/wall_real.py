"""The stack on wall correspondences: the reference's real matches, or the
port's synthetic fixture.

The counterpart of ``sks_tpu/bench/wall_real.py``.  Every entry point takes
the matches ``(src, tar)`` as (N, 2) float64 arrays:

1. :func:`solver_accuracy`: reference-shaped resampled quads
   (``data.wall.resample_quads``: random 4-point subsets, as
   ``GPU_Runtime Test.cu:52-78`` builds its batches) through all six
   ``ops.SOLVERS`` in float32, and through the six native float64 solves
   (``ops.fp64.SOLVERS_FP64_H``, on the float64 quads; they stand for the
   JAX package's double-float pairs); per solver the median and 99th
   percentile of the defining quad's largest reprojection error (zero in
   exact arithmetic) and the finite fraction.  Eager ops on ``(B, 4, 2)``:
   no kernel of the repo launches.
2. :func:`throughput_real`: kernel K1's homographies/s on resampled quads
   at B = 2^20, in device time (``bench.harness.time_fn``); the JAX package
   times its chained Pallas loop on a TPU only, the port on a CUDA card.
3. :func:`robust_parity`: ``find_homography`` on all matches (on a CUDA
   card, float32 points take the fused route: one launch of K2), beside
   ``cv2.findHomography`` where cv2 imports: inliers under cv2's forward
   rule, the inlier sets' Jaccard index and the two models' disagreement
   over the data's bounding box.

The reference's file is not in the repository (``data/wall.py``): run on it
from the repository root, once it is there, with

    SKS_WALL_POINTS=/path/to/orig_pts_wall.txt python -m sks_tpu_torch.bench.wall_real [--out PATH]

which exits 0 with a message when the file is absent.  ``chip_smoke.py``
runs the three on the port's synthetic fixture (``data/fixture.py``: 2,000
matches, a known ``GT_H``, 15% outliers).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from sks_tpu_torch.bench.harness import time_fn
from sks_tpu_torch.data.wall import load_wall, resample_quads
from sks_tpu_torch.geom.homography import apply_homography
from sks_tpu_torch.ops import SOLVERS
from sks_tpu_torch.ops.fp64 import SOLVERS_FP64_H

__all__ = ["solver_accuracy", "throughput_real", "robust_parity", "run",
           "to_markdown", "main"]


def _quad_residual(h, src, tar):
    """Largest reprojection error of the defining quad, (B,)."""
    proj = apply_homography(h, src)
    return torch.amax(torch.linalg.norm(proj - tar, dim=-1), dim=-1)


def _stats(r: torch.Tensor, prefix: str, finite_key: str) -> dict:
    r = r.detach().cpu().double().numpy()
    r[~np.isfinite(r)] = np.nan
    return {f"{prefix}_median_px": float(np.nanmedian(r)),
            f"{prefix}_p99_px": float(np.nanpercentile(r, 99)),
            finite_key: float(np.mean(np.isfinite(r)))}


def solver_accuracy(src, tar, batch: int = 4096, seed: int = 11,
                    device="cuda") -> dict:
    """Per-solver residual statistics on resampled quads, float32 and
    float64 (see the module docstring).

    About 0.2% of reference-shaped resamples repeat a point (a degenerate
    4-point set, as the reference's modulo draw does too); the medians
    and percentiles are over the finite fits.
    """
    sq, tq = resample_quads(np.asarray(src), np.asarray(tar), batch, seed)
    s64 = torch.as_tensor(sq, dtype=torch.float64, device=device)
    t64 = torch.as_tensor(tq, dtype=torch.float64, device=device)
    s32, t32 = s64.float(), t64.float()
    out = {}
    for name, fn in SOLVERS.items():
        out[name] = _stats(_quad_residual(fn(s32, t32), s32, t32), "f32",
                           "finite_frac")
    for name, fn in SOLVERS_FP64_H.items():
        h = fn(s64, t64)
        h = h / h[..., 2:3, 2:3]
        out[name].update(_stats(_quad_residual(h, s64, t64), "f64",
                                "f64_finite_frac"))
    return out


def throughput_real(src, tar, batch: int = 1 << 20, device="cuda",
                    budget_s: float = 1.0) -> dict | None:
    """K1's homographies/s on resampled quads (None off a CUDA card)."""
    if torch.device(device).type != "cuda":
        return None
    from sks_tpu_torch.kernels import aca_cuda as K

    sq, tq = resample_quads(np.asarray(src), np.asarray(tar), batch)
    s = K.to_soa(torch.as_tensor(sq, dtype=torch.float32, device=device))
    t = K.to_soa(torch.as_tensor(tq, dtype=torch.float32, device=device))
    res = time_fn(K.aca_solve_soa, s, t, budget_s=budget_s)
    return {"batch": batch, "h_per_s": res.throughput(batch),
            "seconds_per_call": res.seconds_per_call, "iters": res.iters,
            "note": "kernel K1 on resampled quads, device time"}


def _forward(h, pts: np.ndarray) -> np.ndarray:
    q = np.concatenate([pts, np.ones_like(pts[:, :1])], 1) @ np.asarray(
        h, np.float64).T
    return q[:, :2] / q[:, 2:3]


def robust_parity(src, tar, threshold: float = 3.0, seed: int = 0,
                  device="cuda", indices=None) -> dict:
    """``find_homography`` against ``cv2.findHomography`` on all matches.

    The fit draws from a ``torch.Generator`` seeded ``seed`` on ``device``;
    ``indices=`` ((2048, 4) minimal sets) replaces the draws (the parity
    seam).  cv2's columns are None, and ``cv2`` is "unavailable", where cv2
    does not import.
    """
    from sks_tpu_torch.robust import find_homography

    a = np.asarray(src, np.float32)
    b = np.asarray(tar, np.float32)
    gen = torch.Generator(device=device).manual_seed(seed)
    h_t, mask_t = find_homography(
        torch.as_tensor(a, device=device), torch.as_tensor(b, device=device),
        method="ransac", ransac_reproj_threshold=threshold, max_iters=2048,
        generator=gen,
        indices=None if indices is None else torch.as_tensor(
            indices, device=device))
    h_ours = h_t.detach().cpu().double().numpy()
    mask_ours = mask_t.cpu().numpy()

    def fwd_mask(h):
        return np.sum((_forward(h, a) - b) ** 2, axis=1) < threshold ** 2

    m_ours = fwd_mask(h_ours)
    out = {"matches": int(a.shape[0]), "threshold_px": threshold,
           "h": h_ours.tolist(),
           "inliers_ours": int(m_ours.sum()),
           "inliers_ours_native_symmetric": int(mask_ours.sum()),
           "inliers_cv2": None, "inlier_jaccard": None,
           "corner_transfer_disagreement_px": None}
    try:
        import cv2
    except ImportError:
        out["cv2"] = "unavailable"
        return out
    h_cv, _ = cv2.findHomography(a, b, cv2.RANSAC, threshold,
                                 maxIters=2048, confidence=0.999)
    m_cv = fwd_mask(h_cv)
    out["inliers_cv2"] = int(m_cv.sum())
    out["inlier_jaccard"] = (int((m_ours & m_cv).sum())
                             / max(int((m_ours | m_cv).sum()), 1))
    # Both models map the data's bounding box (and its center): their
    # disagreement bounds the geometric difference of the fits.
    (x0, y0), (x1, y1) = a.min(0), a.max(0)
    corners = np.array([[x0, y0], [x1, y0], [x0, y1], [x1, y1],
                        [(x0 + x1) / 2, (y0 + y1) / 2]], np.float64)
    out["corner_transfer_disagreement_px"] = float(np.max(np.linalg.norm(
        _forward(h_ours, corners) - _forward(h_cv, corners), axis=-1)))
    return out


def run(src, tar, out_path: str | None = None, batch: int = 4096,
        device="cuda") -> dict:
    """All three measurements on ``(src, tar)``; prints and optionally
    writes the JSON."""
    result = {
        "n_matches": int(np.asarray(src).shape[0]),
        "device": str(device),
        "solver_accuracy": solver_accuracy(src, tar, batch, device=device),
        "robust_parity_full_set": robust_parity(src, tar, device=device),
        "throughput_real_quads": throughput_real(src, tar, device=device),
    }
    print(json.dumps(result, indent=1))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
        print("wrote", out_path)
        if out_path.endswith(".json"):
            md = out_path[:-5] + ".md"
            with open(md, "w") as f:
                f.write(to_markdown(result) + "\n")
            print("wrote", md)
    return result


def to_markdown(res: dict) -> str:
    """:func:`run`'s result as a Markdown report: the solver table (float32
    median and 99th percentile, float64 median), the robust fit against cv2
    and, on a card, K1's rate; the tables and bullets of the JAX package's
    ``wall_real.to_markdown``, its double-float column the native float64
    one."""
    sa = res["solver_accuracy"]
    rp = res["robust_parity_full_set"]
    lines = [
        "# WALL_REAL: the port on wall correspondences",
        "",
        f"{res['n_matches']:,} correspondences, device: {res['device']}.",
        "",
        "## Solver accuracy on reference-shaped resampled quads",
        "",
        "Max reprojection residual of the defining quad (zero in exact "
        "arithmetic; measures conditioning on the data's coordinates).",
        "",
        "| solver | f32 median px | f32 p99 px | f64 median px |",
        "|---|---|---|---|",
    ]
    for name, row in sa.items():
        f64 = row.get("f64_median_px")
        lines.append(
            f"| {name} | {row['f32_median_px']:.2e} "
            f"| {row['f32_p99_px']:.2e} "
            f"| {f'{f64:.1e}' if f64 is not None else '-'} |")
    lines += [
        "",
        "## Robust fit on the full set vs cv2",
        "",
        f"- inliers (cv2 forward rule, {rp['threshold_px']:g} px): ours "
        f"**{rp['inliers_ours']}** vs cv2 "
        f"**{rp['inliers_cv2'] if rp['inliers_cv2'] is not None else '-'}**",
        f"- inlier-set Jaccard: **{rp['inlier_jaccard'] or 0:.3f}**",
        f"- corner-transfer disagreement over the data bounding box: "
        f"**{rp['corner_transfer_disagreement_px'] or 0:.2f} px**",
    ]
    tp = res.get("throughput_real_quads")
    if tp:
        lines += [
            "",
            "## Throughput on resampled quads",
            "",
            f"Kernel K1 at B={tp['batch']:,}: **{tp['h_per_s']:.3e} H/s** "
            "(device time).",
        ]
    return "\n".join(lines)


def main(argv=None):
    """Console entry point (``python -m sks_tpu_torch.bench.wall_real``)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args(argv)
    data = load_wall()
    if data is None:
        print("no reference wall data (orig_pts_wall.txt absent; set "
              "SKS_WALL_POINTS) - skipping")
        return None
    return run(*data, args.out, args.batch)


if __name__ == "__main__":
    main()
