"""Driver of the ``slam-vga`` configuration: ``planar_slam`` on T = 16
rendered frames at (480, 640), with loop closures, the dense ESM polish and
pose-graph relaxation.

A request is one call ``planar_slam(seed, frames, k_mat, config, ...)`` on
a float32 CUDA video chunk, timed from the call to the relaxed poses, the
relative poses, the closures' metric measurements and the inlier counts of
the pairs and of the closures on the host; it fits T-1 consecutive pairs
and one closure a candidate (i, i+k) of each stride k, the JAX capstone's
``total_pairs``.  The chunks are rendered at set-up from the seed
(``core/gen_frames.py``: the sweep of the ``vo-vga`` cells, a texture and
nuisances of the seed's) and served in turn; their answers are checked
after the window against the plain reference (``core/ref_slam.py``), which
detects, matches, fits, polishes, poses, chains and relaxes in float64 on
its own, and the relaxed poses also against the reference's exact
Gauss-Newton of the program's own pose graph.
"""

from __future__ import annotations

import random

import torch

from benchmark.core import gen_frames, ref_slam


class Cell:
    """One cell of this configuration under one traffic mix."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.call = None

    def setup(self) -> None:
        """Render the chunks, load the program, warm up on a chunk of its
        own."""
        from sks_tpu_torch import planar_slam
        from sks_tpu_torch.robust.ransac import RansacConfig

        c = self.config
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        pool, warm = int(self.traffic["pool"]), int(self.traffic["warmup"])
        seqs = [gen_frames.planar_sequence(
            gen, int(c["num_frames"]), tuple(c["frame_hw"]),
            float(c["focal_px"]), float(c["frame_noise"]))
            for _ in range(pool + warm)]
        self.frames = [f for f, _, _ in seqs]
        self.k_mat = seqs[0][2]
        ransac = RansacConfig(num_hypotheses=int(c["num_hypotheses"]),
                              threshold=float(c["threshold_px"]),
                              refine_iters=int(c["refine_iters"]),
                              fused=bool(self.traffic["fused"]))
        kw = dict(num_corners=int(c["num_corners"]),
                  num_octaves=int(c["num_octaves"]),
                  plane_depth=float(c["plane_depth"]),
                  strides=tuple(c["strides"]), smooth=bool(c["smooth"]),
                  esm_iters=int(c["esm_iters"]))

        def call(seed, frames):
            out = planar_slam(seed, frames, self.k_mat, ransac, **kw)
            if "closure_rel" not in out:
                raise RuntimeError(
                    "planar_slam returns no closure_rel: the check of the "
                    "pose-graph relaxation needs the closures' measurements")
            return (out["poses"].double().cpu(), out["rel"].double().cpu(),
                    out["num_inliers"].cpu(), out["closure_inliers"].cpu(),
                    out["closure_rel"].double().cpu())

        self.call = call
        for i in range(warm):
            self.call(self._stream(pool + i), self.frames[pool + i])
        self.frames = self.frames[:pool]

    def _stream(self, i: int) -> int:
        """The seed the caller passes for its pairs' minimal sets."""
        return (self.seed * 1_000_003 + i) % (1 << 62)

    def request(self, i: int):
        """Serve request ``i``: (poses (T, 4, 4), rel (T-1, 4, 4) float64,
        num_inliers (T-1,), closure_inliers (E,), closure_rel (E, 4, 4)
        float64), on the host."""
        j = i % len(self.frames)
        return self.call(self._stream(j), self.frames[j])

    @staticmethod
    def units(answer) -> int:
        """The pairs fitted: T-1 consecutive pairs and the closures."""
        return int(answer[2].shape[0] + answer[3].shape[0])

    def release(self) -> None:
        self.call = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self, served: int) -> list[int]:
        distinct = min(served, len(self.frames))
        k = min(distinct, int(self.traffic["check_sample"]))
        return sorted(random.Random(self.seed).sample(range(distinct), k))

    def reference(self, i: int, dtype=torch.float64):
        """The plain reference's answer to request ``i``, in ``dtype``:
        (poses, rel, num_inliers, closure_inliers, closure_rel)."""
        gen = torch.Generator(device=self.device).manual_seed(
            self._stream(i) ^ 0x5A5A5A5A)
        return ref_slam.slam(self.frames[i], self.k_mat, self.config,
                             int(self.traffic["ref_hypotheses"]), gen, dtype)

    def control(self, i: int):
        """The control's answer to request ``i``: the reference computed in
        bfloat16, in the program's place."""
        return self.reference(i, torch.bfloat16)

    def compare(self, answer, ref) -> dict:
        """The numbers compared for one request:

        * the largest rotation and translation gap over the T relaxed poses;
        * the largest relative inlier gap over the consecutive pairs and
          over the closures that the reference gates in;
        * the relaxation's own gap: the relaxed poses against the
          reference's exact Gauss-Newton (``ref_slam.relax``, float64) of
          the pose graph the answer itself measured (its relative poses,
          closure measurements and inlier counts), so that fit noise, which
          both sides share, drops out and a relaxation left out or run on
          another graph shows;
        * the polish's own gap: the median, over the consecutive pairs and
          the gated closures, of the translation gap between each edge's
          measurement and the reference's, which the dense polish brings
          from the features' level to the pixels';

        and how many closures the reference gates in (information, not
        compared)."""
        poses, rel, ninl, ninl_c, rel_c = answer
        poses_ref, rel_ref, ninl_ref, ninl_c_ref, rel_c_ref = ref
        rot = ref_slam.rot_gap_deg(poses, poses_ref)
        trans = torch.linalg.norm(poses[:, :3, 3] - poses_ref[:, :3, 3],
                                  dim=-1)
        closures = ref_slam.closure_pairs(poses.shape[0],
                                          self.config["strides"])
        own = ref_slam.relax(rel, ninl, rel_c, ninl_c, closures)
        relax_rot = ref_slam.rot_gap_deg(poses, own)
        relax_trans = torch.linalg.norm(poses[:, :3, 3] - own[:, :3, 3],
                                        dim=-1)

        def gap(n, n_ref):
            return ((n.double() - n_ref.double()).abs()
                    / n_ref.double().clamp(min=1))

        gated = ninl_c_ref >= ref_slam.CLOSURE_MIN_INLIERS
        closure = gap(ninl_c, ninl_c_ref)[gated]
        edges = torch.cat([rel, rel_c[gated]])
        edges_ref = torch.cat([rel_ref, rel_c_ref[gated]])
        edge_trans = torch.linalg.norm(edges[:, :3, 3] - edges_ref[:, :3, 3],
                                       dim=-1)

        def worst(x):
            if not x.numel():
                return 0.0
            x = x.max()
            return float(x) if bool(torch.isfinite(x)) else float("inf")

        def median(x):
            x = x.median()
            return float(x) if bool(torch.isfinite(x)) else float("inf")

        return {"pose_rot_gap_deg": worst(rot), "pose_trans_gap": worst(trans),
                "relax_rot_gap_deg": worst(relax_rot),
                "relax_trans_gap": worst(relax_trans),
                "edge_trans_gap_median": median(edge_trans),
                "inlier_gap": worst(gap(ninl, ninl_ref)),
                "closure_inlier_gap": worst(closure),
                "closures_gated_min": float(gated.sum())}
