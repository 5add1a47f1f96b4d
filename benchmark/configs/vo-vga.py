"""Driver of the ``vo-vga`` configuration: ``frames_to_poses`` on T = 16
rendered frames at (480, 640).

A request is one call ``frames_to_poses(seed, frames, k_mat, config, ...)``
on a float32 CUDA video chunk, timed from the call to the T-1 relative poses
and inlier counts on the host; it poses T-1 pairs.  The chunks are rendered
at set-up from the seed (``core/gen_frames.py``: the same trajectory, a
texture and nuisances of the seed's) and served in turn; their answers are
checked after the window against the plain reference (``core/ref_vo.py``),
which detects, describes, matches, fits and poses in float64 on its own.
"""

from __future__ import annotations

import random

import torch

from benchmark.core import gen_frames, ref_vo


class Cell:
    """One cell of this configuration under one traffic mix."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.call = None

    def setup(self) -> None:
        """Render the chunks, load the program, warm up on a chunk of its
        own."""
        from sks_tpu_torch import frames_to_poses
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
                  plane_depth=float(c["plane_depth"]))

        def call(seed, frames):
            out = frames_to_poses(seed, frames, self.k_mat, ransac, **kw)
            return out["rel"].double().cpu(), out["num_inliers"].cpu()

        self.call = call
        for i in range(warm):
            self.call(self._stream(pool + i), self.frames[pool + i])
        self.frames = self.frames[:pool]

    def _stream(self, i: int) -> int:
        """The seed the caller passes for its pairs' minimal sets."""
        return (self.seed * 1_000_003 + i) % (1 << 62)

    def request(self, i: int):
        """Serve request ``i``: (rel (T-1, 4, 4) float64, num_inliers
        (T-1,)), on the host."""
        j = i % len(self.frames)
        return self.call(self._stream(j), self.frames[j])

    @staticmethod
    def units(answer) -> int:
        return int(answer[1].shape[0])

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
        (rel, num_inliers, matches of each pair)."""
        gen = torch.Generator(device=self.device).manual_seed(
            self._stream(i) ^ 0x5A5A5A5A)
        return ref_vo.poses(self.frames[i], self.k_mat, self.config,
                            int(self.traffic["ref_hypotheses"]), gen, dtype)

    def control(self, i: int):
        """The control's answer to request ``i``: the reference computed in
        bfloat16, in the program's place."""
        return self.reference(i, torch.bfloat16)[:2]

    def compare(self, answer, ref) -> dict:
        """The numbers compared for one request, over its pairs; and the
        smallest share of a pair's matches that the reference keeps as
        inliers (information, not compared)."""
        rel, ninl = answer
        rel_ref, ninl_ref, matches = ref
        r = rel[:, :3, :3].transpose(-1, -2) @ rel_ref[:, :3, :3]
        cos = ((r.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2).clamp(-1, 1)
        rot = torch.rad2deg(torch.arccos(cos))
        trans = torch.linalg.norm(rel[:, :3, 3] - rel_ref[:, :3, 3], dim=-1)
        inl = ((ninl.double() - ninl_ref.double()).abs()
               / ninl_ref.double().clamp(min=1))

        def worst(x):
            x = x.max()
            return float(x) if bool(torch.isfinite(x)) else float("inf")

        return {"rot_gap_deg": worst(rot), "trans_gap": worst(trans),
                "inlier_gap": worst(inl),
                "inlier_share_min": float((ninl_ref.double()
                                           / matches.double().clamp(min=1))
                                          .min())}
