"""Image-grounded end-to-end benchmark: corner error against the truth, cv2
parity on the same matches, VO ATE.

The counterpart of ``sks_tpu/bench/real_pipeline.py``: pixels in, a
homography or a trajectory out, scored against the exact ground truth of
the renderer (``data/images.py``).

1. :func:`pair_parity`: P rendered planar pairs (``planar_pair``: a textured
   plane, an exact H, photometric nuisances; ``protocol='hard'`` adds blur
   and a stronger viewpoint change, ``'parallax'`` off-plane boxes through
   ``planar_pair_boxes``) at (480, 640).  The feature front end (512 corners
   on 3 pyramid levels, oriented patches, mutual-NN / ratio matching) makes
   the matches; ``find_homography`` fits them (2,048 hypotheses, 3 px; on a
   CUDA card a float32 fit takes the fused route, one launch of kernel K2
   a pair) and is scored by its largest corner error against the true H.
   Where cv2 imports, ``cv2.findHomography`` runs on the same matches at
   the same threshold and both models are scored under cv2's forward rule
   (inliers, agreement, Jaccard, cv2's corner error); elsewhere those
   columns are None.  ``esm=True`` adds the symmetric dense polish and its
   guard (``slam/tracking.py``).
2. :func:`sequence_ate`: a T-frame rendered sweep (``planar_sequence``) at
   (240, 320), 384 corners on 2 levels, consecutive pairs through
   ``slam.odometry.vo_trajectory`` (2,048 hypotheses, ``refine_iters=3``;
   one K2 launch for all pairs on the card), ATE against the true poses.
3. :func:`loop_closure_ate`: the closed circuit (``loop=True``), ATE of the
   raw chain, of pose-graph smoothing, and of smoothing with loop-closure
   edges between frames i and i + k, k in ``strides``.

Draws come from ``torch.Generator``s seeded per pair from ``(seed, i)``
(``utils.streams.pair_generators``), so the pixels differ from the JAX
package's for the same seed.  The parity seam: ``images=`` / ``frames=``
take renders made elsewhere (the JAX package's), and ``indices=`` the
minimal sets of each fit, as ``indices=`` does across the port.

Run on a machine with a CUDA card, from the repository root:

    python -m sks_tpu_torch.bench.real_pipeline [--pairs 8] [--frames 12]
        [--protocol easy|hard|parallax] [--esm] [--out PATH]

The photographs (``--texture``, ``--photo-suite``) need PIL and the sample
photographs of matplotlib and scikit-learn (``data.images.available_photos``).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from sks_tpu_torch.data.images import (
    planar_pair,
    planar_pair_boxes,
    planar_sequence,
)
from sks_tpu_torch.features.matching import match_frames_oriented
from sks_tpu_torch.geom.homography import apply_homography
from sks_tpu_torch.robust import find_homography
from sks_tpu_torch.robust.api import fused_by_default
from sks_tpu_torch.robust.ransac import RansacConfig
from sks_tpu_torch.slam.odometry import closure_candidates, vo_trajectory
from sks_tpu_torch.slam.pipeline import _match_pairs_cached
from sks_tpu_torch.utils.streams import pair_generators

__all__ = ["pair_parity", "sequence_ate", "loop_closure_ate", "run",
           "run_photo_suite", "main"]

#: Hard-protocol nuisances: defocus blur on the second view, ~2x the default
#: viewpoint rotation, shifts large enough for ~1.2x scale change.  The easy
#: protocol is ``planar_pair``'s defaults.
_HARD_KW = dict(max_angle=0.28, max_shift=0.4, blur_sigma=1.0)

#: The columns that only cv2 fills.
_CV2_COLUMNS = ("inliers_cv2", "inliers_cv2_native", "inlier_agreement",
                "inlier_jaccard", "corner_err_cv2_px")


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _corner_err(h, h_true, shape) -> float:
    """Largest distance between the image corners mapped by ``h`` and by
    ``h_true``, in float32 on ``h_true``'s device."""
    hh, ww = shape
    dev = h_true.device
    corners = torch.tensor([[0.0, 0.0], [ww, 0.0], [0.0, hh], [ww, hh]],
                           dtype=torch.float32, device=dev)
    h = torch.as_tensor(h, dtype=torch.float32, device=dev)
    d = (apply_homography(h, corners)
         - apply_homography(h_true.float(), corners))
    return float(torch.linalg.norm(d, dim=-1).max())


def _texture(texture: str, shape, device):
    if texture == "procedural":
        return None
    from sks_tpu_torch.data.images import photo_texture

    name = "hopper" if texture == "photo" else texture
    tex = photo_texture(shape, name=name, device=device)
    if tex is None:
        raise RuntimeError(f"photograph {name!r} unavailable (PIL or the "
                           "sample photographs missing)")
    return tex


def _ransac_config(threshold: float, device) -> RansacConfig:
    """The VO fits' configuration: fused (one K2 launch a call) where
    ``find_homography`` would take the fused route."""
    return RansacConfig(num_hypotheses=2048, threshold=threshold,
                        refine_iters=3,
                        fused=fused_by_default(torch.device(device).type,
                                               torch.float32))


def pair_parity(seed: int, num_pairs: int = 8, shape=(480, 640),
                threshold: float = 3.0, method: str = "ransac",
                texture: str = "procedural", protocol: str = "easy",
                esm: bool = False, device="cuda", num_corners: int = 512,
                num_octaves: int = 3, *, images=None, indices=None):
    """Per-pair rows: matches, inliers, corner errors (see the module
    docstring).

    ``texture`` names a photograph ('hopper', 'flower', 'china'; 'photo' is
    'hopper') to render every pair from real pixels, the HPatches viewpoint
    protocol.  Pair i renders from stream 2i and fits from stream 2i + 1 of
    ``seed``.  ``images``: a sequence of the renderer's tuples, one a pair
    (``(img1, img2, h_true)``, for 'parallax' ``(img1, img2, h_true, mask1,
    mask2)``) in place of the renders; ``indices``: a sequence of (2048, 4)
    minimal sets in place of the fits' draws.
    """
    cv2 = _cv2()
    tex = _texture(texture, shape, device) if images is None else None
    kw = _HARD_KW if protocol == "hard" else {}
    gens = pair_generators(seed, 2 * num_pairs, device=device)
    rows = []
    for i in range(num_pairs):
        if images is not None:
            views = tuple(torch.as_tensor(x, device=device)
                          for x in images[i])
        elif protocol == "parallax":
            # Off-plane boxes in closer parallel planes: matches on them
            # are coherent outliers of another homography.
            views = planar_pair_boxes(gens[2 * i], shape, texture=tex)
        else:
            views = planar_pair(gens[2 * i], shape, texture=tex, **kw)
        img1, img2, h_true = views[:3]
        p1, p2, valid, _ = match_frames_oriented(img1, img2, num_corners,
                                                 num_octaves)
        v = valid.cpu().numpy()
        a = p1.cpu().numpy()[v].astype(np.float64)
        b = p2.cpu().numpy()[v].astype(np.float64)
        if a.shape[0] < 8:
            rows.append({"pair": i, "matches": int(a.shape[0]),
                         "skipped": "too few matches"})
            continue
        offplane = None
        if protocol == "parallax":
            def on(mask, pts):
                yy = np.clip(pts[:, 1].astype(int), 0, shape[0] - 1)
                xx = np.clip(pts[:, 0].astype(int), 0, shape[1] - 1)
                return mask.cpu().numpy()[yy, xx]

            offplane = on(views[3], a) | on(views[4], b)

        # Padded fit: invalid slots at the image center, masked out.
        center = torch.tensor([shape[1] / 2.0, shape[0] / 2.0],
                              dtype=p1.dtype, device=p1.device)
        p1f = torch.where(valid[..., None], p1, center)
        p2f = torch.where(valid[..., None], p2, center)
        h_ours, mask_padded = find_homography(
            p1f, p2f, method=method, ransac_reproj_threshold=threshold,
            max_iters=2048, generator=gens[2 * i + 1], point_mask=valid,
            indices=None if indices is None else torch.as_tensor(
                indices[i], device=p1.device))
        mask_ours = mask_padded.cpu().numpy()[v]

        # Both models under cv2's forward rule (the port's own mask is the
        # stricter symmetric transfer).
        def fwd_mask(h):
            h = np.asarray(h, np.float64)
            p = np.concatenate([a, np.ones_like(a[:, :1])], axis=1) @ h.T
            p = p[:, :2] / p[:, 2:3]
            return np.sum((p - b) ** 2, axis=1) < threshold * threshold

        h_np = h_ours.detach().cpu().double().numpy()
        m_ours = fwd_mask(h_np)
        row = {
            "pair": i,
            "matches": int(a.shape[0]),
            "inliers_ours": int(m_ours.sum()),
            "inliers_ours_native_symmetric": int(mask_ours.sum()),
            "corner_err_ours_px": _corner_err(h_ours, h_true, shape),
            **dict.fromkeys(_CV2_COLUMNS),
        }
        m_cv = None
        if cv2 is not None:
            h_cv, mask_cv = cv2.findHomography(
                a, b, cv2.RANSAC, threshold, maxIters=2048, confidence=0.999)
            m_cv = fwd_mask(h_cv)
            union = max(int(np.sum(m_ours | m_cv)), 1)
            row.update(
                inliers_cv2=int(m_cv.sum()),
                inliers_cv2_native=int(mask_cv.reshape(-1).astype(bool).sum()),
                inlier_agreement=float(np.mean(m_ours == m_cv)),
                inlier_jaccard=float(np.sum(m_ours & m_cv) / union),
                corner_err_cv2_px=_corner_err(h_cv, h_true, shape))
        if offplane is not None:
            # A planar fit must reject the off-plane matches: their leak
            # into each side's inlier set.
            row["offplane_match_frac"] = float(offplane.mean())
            row["offplane_inlier_leak_ours"] = int((m_ours & offplane).sum())
            row["offplane_inlier_leak_cv2"] = (
                None if m_cv is None else int((m_cv & offplane).sum()))
        if esm:
            from sks_tpu_torch.slam.tracking import (
                esm_guard,
                esm_polish_pair_symmetric,
            )

            h_esm, rms = esm_polish_pair_symmetric(img1, img2, h_ours,
                                                   iters=8)
            ok = esm_guard(h_ours, h_esm, p1f, p2f, mask_padded)
            h_sel = torch.where(ok, h_esm, h_ours)
            row["corner_err_esm_raw_px"] = _corner_err(h_esm, h_true, shape)
            row["corner_err_esm_px"] = _corner_err(h_sel, h_true, shape)
            row["esm_accepted"] = bool(ok)
            row["esm_rms"] = float(rms)
        rows.append(row)
    return rows


def _ate(poses, poses_gt) -> float:
    """RMSE of the camera positions (no alignment: both start at identity)."""
    d = poses[:, :3, 3].double().cpu() - poses_gt[:, :3, 3].double().cpu()
    return float(torch.sqrt(torch.mean(torch.sum(d * d, dim=-1))))


def _path_length(poses_gt) -> float:
    p = poses_gt[:, :3, 3].double().cpu()
    return float(torch.linalg.norm(torch.diff(p, dim=0), dim=-1).sum())


def _sequence(seed, num_frames, shape, texture, device, loop, frames):
    """(frames, poses_gt, k_mat, generator): the seam's render or our own."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if frames is not None:
        return (*(torch.as_tensor(x, device=device) for x in frames), gen)
    tex = _texture(texture, shape, device)
    return (*planar_sequence(gen, num_frames, shape, texture=tex, loop=loop),
            gen)


def _matches(frames, pairs, num_corners=384, num_octaves=2):
    """Padded matches of the (i, j) ``pairs``, each frame described once."""
    idx = torch.as_tensor(pairs, dtype=torch.long,
                          device=frames.device).reshape(-1, 2)
    return _match_pairs_cached(frames, idx[:, 0], idx[:, 1], num_corners,
                               num_octaves)


def sequence_ate(seed: int, num_frames: int = 12, shape=(240, 320),
                 threshold: float = 2.0, texture: str = "procedural",
                 esm_iters: int = 0, device="cuda", *, frames=None,
                 indices=None):
    """ATE of the VO chain on a rendered sweep against the true poses.

    ``texture`` names a photograph, as in :func:`pair_parity`.  ``frames``:
    ``(frames, poses_gt, k_mat)`` in place of the render; ``indices``: (T-1,
    2048, 4) minimal sets in place of the draws.
    """
    frames_, poses_gt, k_mat, gen = _sequence(seed, num_frames, shape,
                                              texture, device, False, frames)
    t = frames_.shape[0]
    p1s, p2s, masks = _matches(frames_, [(i, i + 1) for i in range(t - 1)])
    out = vo_trajectory(
        gen, p1s, p2s, k_mat, _ransac_config(threshold, device),
        plane_depth=3.0, point_mask=masks,
        frames=frames_ if esm_iters else None, esm_iters=esm_iters,
        indices=None if indices is None else torch.as_tensor(
            indices, device=p1s.device))
    ate = _ate(out["poses"], poses_gt)
    path = _path_length(poses_gt)
    return {
        "frames": t,
        "ate_rmse": ate,
        "path_length": path,
        "ate_pct_of_path": 100.0 * ate / max(path, 1e-9),
        "mean_inliers": float(out["num_inliers"].double().mean()),
        "num_inliers": out["num_inliers"].cpu().tolist(),
    }


def loop_closure_ate(seed: int, num_frames: int = 16, shape=(240, 320),
                     threshold: float = 2.0, strides=(4, 8),
                     texture: str = "procedural", device="cuda", *,
                     frames=None):
    """ATE of the raw chain, of smoothing, and of smoothing with
    loop-closure edges, on the closed circuit (``loop=True``).

    Consecutive pairs and the closure candidates (frames i and i + k, k in
    ``strides``: ``slam.odometry.closure_candidates``) are matched from one
    description of each frame; the three trajectories share the draws.
    """
    frames_, poses_gt, k_mat, gen = _sequence(seed, num_frames, shape,
                                              texture, device, True, frames)
    t = frames_.shape[0]
    p1s, p2s, masks = _matches(frames_, [(i, i + 1) for i in range(t - 1)])
    closures = closure_candidates(t, strides)
    c1s, c2s, cmasks = _matches(frames_, closures)
    cp = torch.as_tensor(closures, dtype=torch.long, device=p1s.device)
    config = _ransac_config(threshold, device)
    kw = dict(plane_depth=3.0, point_mask=masks)
    out_odo = vo_trajectory(gen, p1s, p2s, k_mat, config, **kw)
    out_smooth = vo_trajectory(gen, p1s, p2s, k_mat, config, smooth=True,
                               **kw)
    out_loop = vo_trajectory(gen, p1s, p2s, k_mat, config, smooth=True,
                             closure_pairs=cp, closure_pts1=c1s,
                             closure_pts2=c2s, closure_mask=cmasks, **kw)
    return {
        "frames": t,
        "texture": texture,
        "closure_edges": len(closures),
        "closure_mean_inliers": float(
            out_loop["closure_inliers"].double().mean()),
        "path_length": _path_length(poses_gt),
        "ate_odometry": _ate(out_odo["poses"], poses_gt),
        "ate_smooth_no_closures": _ate(out_smooth["poses"], poses_gt),
        "ate_smooth_with_closures": _ate(out_loop["poses"], poses_gt),
    }


def _mean(rows, key):
    vals = [r[key] for r in rows if r.get(key) is not None]
    return float(np.mean(vals)) if vals else None


def _summarize(pairs):
    """Means over the scored pairs; cv2's entries are None where its
    columns are."""
    scored = [r for r in pairs if "skipped" not in r]
    ratios = [r["corner_err_ours_px"] / max(r["corner_err_cv2_px"], 1e-9)
              for r in scored if r.get("corner_err_cv2_px") is not None]
    out = {
        "n": len(scored),
        "mean_inlier_agreement": _mean(scored, "inlier_agreement"),
        "mean_inlier_jaccard": _mean(scored, "inlier_jaccard"),
        "mean_corner_err_ours_px": _mean(scored, "corner_err_ours_px"),
        "max_corner_err_ours_px": (max(r["corner_err_ours_px"]
                                       for r in scored) if scored else None),
        "mean_corner_err_cv2_px": _mean(scored, "corner_err_cv2_px"),
        "max_corner_err_ratio_vs_cv2": max(ratios) if ratios else None,
    }
    if scored and "corner_err_esm_px" in scored[0]:
        out["mean_corner_err_esm_px"] = _mean(scored, "corner_err_esm_px")
    return out


def run(seed: int = 0, num_pairs: int = 8, num_frames: int = 12,
        texture: str = "procedural", protocol: str = "easy",
        esm: bool = False, device="cuda"):
    pairs = pair_parity(seed, num_pairs, texture=texture, protocol=protocol,
                        esm=esm, device=device)
    ate = sequence_ate(seed, num_frames, texture=texture, device=device)
    ate["texture"] = texture
    return {
        "texture": texture,
        "protocol": protocol,
        "pairs": pairs,
        "pair_summary": _summarize(pairs),
        "sequence": ate,
    }


def run_photo_suite(seed: int = 0, num_pairs: int = 8, num_frames: int = 12,
                    esm: bool = False, device="cuda"):
    """Every available photograph, easy and hard protocols, and a
    photo-textured VO sequence each; with ``esm`` the polish column on every
    pair and each sequence also with ``esm_iters=8``.  Empty where no
    photograph is available."""
    from sks_tpu_torch.data.images import available_photos

    out = {"textures": {}, "protocols": ("easy", "hard"), "esm": esm}
    all_rows = {"easy": [], "hard": []}
    for name in available_photos():
        entry = {}
        for protocol in ("easy", "hard"):
            rows = pair_parity(seed, num_pairs, texture=name,
                               protocol=protocol, esm=esm, device=device)
            entry[protocol] = {"pairs": rows, "summary": _summarize(rows)}
            all_rows[protocol].extend(rows)
        entry["sequence"] = sequence_ate(seed, num_frames, texture=name,
                                         device=device)
        if esm:
            entry["sequence_esm"] = sequence_ate(
                seed, num_frames, texture=name, esm_iters=8, device=device)
        out["textures"][name] = entry
    out["overall"] = {p: _summarize(all_rows[p]) for p in all_rows}
    return out


def main(argv=None):
    """Console entry point: print the summaries; ``--out`` writes the JSON."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--texture", default="procedural",
                    choices=("procedural", "photo", "hopper", "flower",
                             "china"),
                    help="a photograph renders the pairs and the sequence "
                         "from real pixels ('photo' = 'hopper')")
    ap.add_argument("--protocol", choices=("easy", "hard", "parallax"),
                    default="easy")
    ap.add_argument("--photo-suite", action="store_true",
                    help="every available photograph x {easy, hard} and "
                         "photo VO sequences")
    ap.add_argument("--esm", action="store_true",
                    help="add the dense ESM polish column (and ESM VO rows)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.photo_suite:
        summary = run_photo_suite(args.seed, args.pairs, args.frames,
                                  esm=args.esm)
        print(json.dumps(summary["overall"], indent=1))
        for name, entry in summary["textures"].items():
            print(name, "sequence:", json.dumps(entry["sequence"]))
    else:
        summary = run(args.seed, args.pairs, args.frames,
                      texture=args.texture, protocol=args.protocol,
                      esm=args.esm)
        print(json.dumps(summary["pair_summary"], indent=1))
        print(json.dumps(summary["sequence"], indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"wrote {args.out}")
    return summary


if __name__ == "__main__":
    main()
