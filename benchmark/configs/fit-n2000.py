"""Driver of the ``fit-n2000`` configuration: ``find_homography`` on
N = 2,000 matches, the cv2-shaped call.

A request is one call ``find_homography(src, tar, ...)`` on float32 CUDA
tensors, timed from the call to H and the mask on the host.  The requests
are drawn at set-up from the seed (``core/gen_fit.py``) and served in turn;
their answers are checked after the window against the plain reference
(``core/ref_fit.py``), which draws its own minimal sets from the seed and
refits in float64.
"""

from __future__ import annotations

import random

import torch

from benchmark.core import gen_fit, ref_fit


class Cell:
    """One cell of this configuration under one traffic mix."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.fit = None

    # -- the program ---------------------------------------------------------

    def _call_kwargs(self) -> dict:
        kw = dict(ransac_reproj_threshold=float(self.config["threshold_px"]),
                  max_iters=int(self.config["max_iters"]),
                  refine_iters=int(self.config["refine_iters"]),
                  solver=self.config["solver"])
        kw.update(self.traffic.get("call", {}))
        return kw

    def setup(self) -> None:
        """Draw the requests, load the program, warm up on requests of their
        own (the window's shapes, and the kernels built)."""
        import sks_tpu_torch

        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        pool, warm = int(self.traffic["pool"]), int(self.traffic["warmup"])
        src, tar, _, _ = gen_fit.fit_requests(
            gen, pool + warm, self.config, self.traffic["outlier_share"])
        self.src, self.tar = src[:pool], tar[:pool]
        self.fit = sks_tpu_torch.find_homography
        self.kwargs = self._call_kwargs()
        for i in range(warm):
            self._serve(src[pool + i], tar[pool + i])

    def _serve(self, src, tar):
        h, mask = self.fit(src, tar, **self.kwargs)
        return h.double().cpu(), mask.cpu()

    def request(self, i: int):
        """Serve request ``i``: (H (3, 3) float64, mask (N,) bool), on the
        host."""
        j = i % self.src.shape[0]
        return self._serve(self.src[j], self.tar[j])

    @staticmethod
    def units(answer) -> int:
        return 1

    def release(self) -> None:
        """Drop what the program holds on the device before the check."""
        self.fit = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def sample(self, served: int) -> list[int]:
        """The requests checked: a sample drawn from the seed among the
        distinct requests served."""
        distinct = min(served, self.src.shape[0])
        k = min(distinct, int(self.traffic["check_sample"]))
        return sorted(random.Random(self.seed).sample(range(distinct), k))

    def reference(self, i: int, dtype=torch.float64):
        """The plain reference's answer to request ``i``, in ``dtype``."""
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed * 1_000_003 + i) % (1 << 63))
        h, mask = ref_fit.fit(self.src[i], self.tar[i],
                              float(self.config["threshold_px"]),
                              int(self.traffic["ref_hypotheses"]), gen, dtype)
        return h.double().cpu(), mask.cpu()

    def control(self, i: int):
        """The control's answer to request ``i``: the reference computed in
        bfloat16, in the program's place."""
        return self.reference(i, torch.bfloat16)

    def compare(self, answer, ref) -> dict:
        """The numbers compared for one request."""
        h, mask = answer
        h_ref, mask_ref = ref
        w, hgt = (float(v) for v in self.config["image_wh"])
        return {"corner_gap_px": ref_fit.corner_gap(h, h_ref, w, hgt),
                "mask_flips": int((mask != mask_ref).sum())}
