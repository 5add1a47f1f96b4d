"""Distributed BA at a realistic scale: K cameras x L landmarks on a mesh.

Port of ``sks_tpu/bench/ba_scale.py``: the landmark-sharded Schur solver
(``parallel.sharded_ba``) at the default width of ``slam.ba.
synth_ba_problem`` (K = 20, L = 10,240), reporting seconds a step and the
RMS reprojection after each.  It runs on the initialized process group (the
ranks on one 'lm' axis), or, where there is none, on a group of its own of
world size 1 on the rank's device (NCCL on the card), torn down after.

Run:  python -m sks_tpu_torch.bench.ba_scale [--cams 20] [--points 10240]
      [--iters 8] [--float64] [--cpu] [--out PATH]
"""

from __future__ import annotations

import json
import time

import torch
import torch.distributed as dist

from sks_tpu_torch.parallel.distributed import replicate_to_mesh
from sks_tpu_torch.parallel.mesh import local_device, make_mesh
from sks_tpu_torch.parallel.sharded_ba import (
    gather_problem,
    shard_problem,
    sharded_gauss_newton_step,
)
from sks_tpu_torch.slam.ba import BAProblem, rms_reprojection, synth_ba_problem

__all__ = ["run"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(num_cams: int = 20, num_points: int = 10_240, iters: int = 8,
        seed: int = 0, damping: float = 1e-4, dtype=torch.float32,
        device_type: str = "cuda") -> dict:
    """One warm-up step, then ``iters`` timed steps from the initial problem.

    The problem is drawn from ``seed`` on the rank's device and broadcast
    from rank 0.  Returns the JAX package's keys: ``backend`` is the device
    type, ``devices`` the world size; ``converged`` holds when the last RMS
    is under 1.2 x the 0.5 px observation noise.
    """
    own = not dist.is_initialized()
    if own:
        dev = local_device(device_type)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1, rank=0)
    try:
        mesh = make_mesh({"lm": -1}, device_type)
        gen = torch.Generator(device=mesh.device).manual_seed(seed)
        gt, prob = synth_ba_problem(gen, num_cams, num_points, dtype=dtype)
        prob = BAProblem(*(replicate_to_mesh(x, mesh) for x in (
            prob.poses, prob.points, prob.intrinsics, prob.obs, prob.mask)))
        shard = shard_problem(prob, mesh)

        rms = [float(rms_reprojection(prob))]
        p = sharded_gauss_newton_step(mesh, shard, damping)  # warm-up
        _sync(mesh.device)
        t0 = time.perf_counter()
        p = shard
        for _ in range(iters):
            p = sharded_gauss_newton_step(mesh, p, damping)
            rms.append(float(rms_reprojection(gather_problem(p, mesh))))
        _sync(mesh.device)
        dt = (time.perf_counter() - t0) / iters

        # Camera-center RMS against the truth (gauge: camera 0 fixed).
        d = p.poses[:, :3, 3] - gt.poses[:, :3, 3]
        pose_rms = float(torch.sqrt(torch.mean(torch.sum(d * d, -1))))
        return {
            "backend": mesh.device.type,
            "devices": dist.get_world_size(),
            "cams": num_cams,
            "points": num_points,
            "dtype": str(dtype).removeprefix("torch."),
            "observations": int(prob.mask.sum()),
            "sec_per_iteration": dt,
            "rms_reprojection_px": rms,
            "pose_center_rms": pose_rms,
            "converged": rms[-1] < 1.2 * 0.5,  # ~ the 0.5 px noise floor
        }
    finally:
        if own:
            dist.destroy_process_group()


def main(argv=None) -> dict:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=20)
    ap.add_argument("--points", type=int, default=10_240)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = run(args.cams, args.points, args.iters, args.seed,
              dtype=torch.float64 if args.float64 else torch.float32,
              device_type="cpu" if args.cpu else "cuda")
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
