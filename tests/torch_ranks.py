"""Gloo ranks for the port's multi-process tests (tests/test_torch_parallel*.py).

Imported, :func:`launch` starts ``world`` fresh Python processes running this
file, each one rank of a ``torch.distributed`` gloo group on the CPU (spawned,
never forked: the pytest process has JAX and XLA threads loaded), and
returns a handle whose ``wait()`` kills every rank and fails when the group
does not finish within its limit (a hung rendezvous must not outlive its
test).  Each rank joins through a file store under the test's temporary
directory (no TCP port to collide across pytest workers), runs one suite of
checks on the inputs the parent saved to an ``.npz``, and writes its
results to ``rank<r>.npz``.

Run as a script, it is that rank, and imports only torch, numpy and
``sks_tpu_torch``:

    python tests/torch_ranks.py SUITE RANK WORLD DIR
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Group:
    """The processes of one launched group."""

    def __init__(self, procs, directory, world, limit):
        self.procs, self.dir, self.world = procs, directory, world
        self.deadline = time.monotonic() + limit

    def wait(self) -> list[dict]:
        """Each rank's results, by rank; raises (after killing every rank)
        if one fails or the group outlives its limit."""
        try:
            for p in self.procs:
                left = self.deadline - time.monotonic()
                p.wait(timeout=max(left, 0.1))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"world {self.world}: the ranks did not "
                                 f"finish in time; {self._logs()}") from None
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [r for r, p in enumerate(self.procs) if p.returncode]
        if bad:
            raise AssertionError(f"world {self.world}: ranks {bad} failed; "
                                 f"{self._logs()}")
        return [dict(np.load(os.path.join(self.dir, f"rank{r}.npz")))
                for r in range(self.world)]

    def _logs(self) -> str:
        out = []
        for r in range(self.world):
            with open(os.path.join(self.dir, f"rank{r}.log")) as f:
                out.append(f"rank {r}:\n{f.read()[-3000:]}")
        return "\n".join(out)


def launch(suite: str, world: int, inputs: dict, directory,
           limit: float = 240.0) -> Group:
    """Start ``world`` ranks of ``suite`` on ``inputs`` (numpy arrays and
    scalars) in ``directory``; returns at once."""
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(directory, "inputs.npz"), **inputs)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": ROOT, "LOCAL_WORLD_SIZE": str(max(world // 2, 1))}
    procs = []
    for r in range(world):
        log = open(os.path.join(directory, f"rank{r}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), suite, str(r),
             str(world), directory], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL))
        log.close()
    return Group(procs, directory, world, limit)


# --- the rank's side ----------------------------------------------------------


def _core(inp, world, rank):
    """mesh, the sharded refinement, BA, pose graph and RANSAC, ba_scale and
    the data-parallel train steps."""
    import torch
    import torch.distributed as dist

    from sks_tpu_torch.bench import ba_scale
    from sks_tpu_torch.models import create_train_state, train_step
    from sks_tpu_torch.models.iterative import create_ihn_state, ihn_train_step
    from sks_tpu_torch.parallel import (
        global_mesh,
        make_mesh,
        replicate_to_mesh,
        shard_graph,
        sharded_ho_h,
        sharded_ndlt_h,
        sharded_optimize_posegraph,
        sharded_ransac_homography,
    )
    from sks_tpu_torch.parallel.mesh import all_gather, psum
    from sks_tpu_torch.parallel.sharded_ba import (
        gather_problem,
        shard_problem,
        sharded_gauss_newton_step,
    )
    from sks_tpu_torch.robust.ransac import RansacConfig
    from sks_tpu_torch.slam.ba import BAProblem
    from sks_tpu_torch.slam.posegraph import PoseGraph

    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = {}
    hyp = make_mesh(None, "cpu")
    grid = make_mesh({"dp": 2, "mp": -1}, "cpu")
    out["mesh_hyp"] = np.array([hyp.size("hyp")])
    out["mesh_dp_mp"] = np.array([grid.shape["dp"], grid.shape["mp"]])
    mine = torch.tensor([float(rank)], dtype=torch.float64)
    out["gather_mp_dp"] = all_gather(grid, ("mp", "dp"), mine).numpy()
    out["gather_dp"] = all_gather(grid, "dp", mine).numpy()
    out["psum_mp"] = psum(grid, "mp", mine).numpy()
    out["replicated"] = replicate_to_mesh(mine, hyp).numpy()

    pts = make_mesh({"pts": -1}, "cpu")
    out["ndlt"] = sharded_ndlt_h(pts, t["ndlt_src"], t["ndlt_tar"],
                                 t["ndlt_w"]).numpy()
    n_rag = int(inp["ragged"])
    out["ndlt_ragged"] = sharded_ndlt_h(pts, t["ndlt_src"][:n_rag],
                                        t["ndlt_tar"][:n_rag],
                                        t["ndlt_w"][:n_rag]).numpy()
    out["ho"] = sharded_ho_h(pts, t["ho_src"], t["ho_tar"]).numpy()
    out["ho_ragged"] = sharded_ho_h(pts, t["ho_src"][:n_rag],
                                    t["ho_tar"][:n_rag]).numpy()

    lm = make_mesh({"lm": -1}, "cpu")
    prob = BAProblem(*(t[f"ba_{k}"] for k in ("poses", "points",
                                              "intrinsics", "obs", "mask")))
    step = sharded_gauss_newton_step(lm, shard_problem(prob, lm), 1e-6)
    whole = gather_problem(step, lm)
    out["ba_poses"], out["ba_points"] = whole.poses.numpy(), whole.points.numpy()

    edge = make_mesh({"edge": -1}, "cpu")
    graph = PoseGraph(*(t[f"pg_{k}"] for k in ("poses", "edges", "meas",
                                               "weights")))
    out["pg_poses"] = sharded_optimize_posegraph(
        edge, shard_graph(graph, edge), gn_iters=3, cg_iters=40).poses.numpy()

    cfg = RansacConfig(num_hypotheses=int(inp["rs_b"]),
                       threshold=float(inp["rs_threshold"]))
    src, tar, idx = t["rs_src"], t["rs_tar"], t["rs_indices"]
    for name, kw in (("rs_general", dict(indices=idx)),
                     ("rs_fused", dict(indices=idx, fused=True)),
                     ("rs_seeded", {}), ("rs_seeded_fused", dict(fused=True))):
        res = sharded_ransac_homography(hyp, 7, src, tar, cfg, **kw)
        out[f"{name}_h"] = res.h.numpy()
        out[f"{name}_mask"] = res.inlier_mask.numpy()
    host = global_mesh(None, "host", "cpu")
    res = sharded_ransac_homography(host, 7, src, tar, cfg,
                                    axis=("host", "hyp"))
    out["host_shape"] = np.array([host.shape["host"], host.shape["hyp"]])
    out["rs_host_h"] = res.h.numpy()

    scale = ba_scale.run(num_cams=4, num_points=256, iters=5,
                         dtype=torch.float64, device_type="cpu")
    out["ba_scale_rms"] = np.array(scale["rms_reprojection_px"])
    out["ba_scale_converged"] = np.array(scale["converged"])
    out["ba_scale_devices"] = np.array(scale["devices"])

    world_group = dist.group.WORLD
    for name, create, step_fn, kw in (
            ("hnet", create_train_state, train_step, {}),
            ("ihn", create_ihn_state, ihn_train_step, {"iters": 2})):
        model, state = create(torch.Generator().manual_seed(3), 32,
                              dtype=torch.float64, device="cpu", **kw)
        _, loss = step_fn(model, state, t["dp_pair"], t["dp_offsets"],
                          group=world_group)
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        first = flat.clone()
        dist.broadcast(first, src=0)
        out[f"{name}_loss"] = loss.numpy()
        out[f"{name}_params_off_rank0"] = (flat - first).abs().max().numpy()
        if rank == 0:
            out[f"{name}_params"] = flat.numpy()
    return out


def _pipeline(inp, world, rank):
    """The sharded VO entry points."""
    import dataclasses

    import torch

    from sks_tpu_torch.parallel import make_mesh
    from sks_tpu_torch.robust.ransac import RansacConfig
    from sks_tpu_torch.slam.pipeline import (
        sharded_frames_to_poses,
        sharded_planar_slam,
    )

    frames, k_mat = torch.from_numpy(inp["frames"]), torch.from_numpy(
        inp["k_mat"])
    cfg = RansacConfig(num_hypotheses=int(inp["num_hypotheses"]),
                       refine_iters=2)
    kw = dict(num_corners=int(inp["num_corners"]))
    out = {}
    mesh = make_mesh({"frame": -1}, "cpu")
    for route, fused in (("fused", True), ("general", False)):
        res = sharded_frames_to_poses(mesh, 5, frames, k_mat,
                                      dataclasses.replace(cfg, fused=fused),
                                      **kw)
        for k, v in res.items():
            out[f"f2p_{route}_{k}"] = v.numpy()
    mesh = make_mesh({"pair": -1}, "cpu")
    res = sharded_planar_slam(mesh, None, frames, k_mat, cfg,
                              strides=tuple(inp["strides"].tolist()),
                              indices=torch.from_numpy(inp["draws"]), **kw)
    for k, v in res.items():
        out[f"slam_{k}"] = v.numpy()
    return out


SUITES = {"core": _core, "pipeline": _pipeline}


def _main(suite: str, rank: int, world: int, directory: str) -> None:
    import torch

    from sks_tpu_torch.parallel import initialize_multihost

    torch.set_num_threads(1)
    initialize_multihost(num_processes=world, process_id=rank,
                         device_type="cpu",
                         init_method="file://" + os.path.join(directory,
                                                              "store"),
                         timeout=60)
    inp = dict(np.load(os.path.join(directory, "inputs.npz")))
    out = SUITES[suite](inp, world, rank)
    np.savez(os.path.join(directory, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
