"""``planar_slam`` against the benchmark's plain SLAM reference
(``benchmark/core/ref_slam.py``), on the CPU at a small size.

The scene is the benchmark's sweep (``benchmark/core/gen_frames.py``) at
144 x 192 with the VGA cell's field of view, T = 10, closures at strides 4
and 8 (8 closures), 128 corners and ``esm_iters=2``.  The program is run
through its entry point; the reference fits, polishes, poses, chains and
relaxes the same frames in float64 on its own, with draws of its own.  The
dense polish and the pose graph are also held to the reference's one by one.
"""

from __future__ import annotations

import pytest
import torch

import sks_tpu_torch
from benchmark.core import gen_frames, ref_fit, ref_slam
from sks_tpu_torch.robust.ransac import RansacConfig
from sks_tpu_torch.slam.posegraph import PoseGraph, optimize_posegraph
from sks_tpu_torch.slam.tracking import esm_polish_pair_symmetric

T, HW, FOCAL = 10, (144, 192), 90.0  # 300 px at 640 wide, scaled
CONFIG = {"num_corners": 128, "num_octaves": 2, "threshold_px": 2.0,
          "esm_iters": 2, "strides": [4, 8], "plane_depth": 3.0}
E = len(ref_slam.closure_pairs(T, CONFIG["strides"]))


@pytest.fixture(scope="module")
def scene():
    gen = torch.Generator().manual_seed(4)
    frames, _, k_mat = gen_frames.planar_sequence(gen, T, HW, FOCAL, 0.005)
    return frames, k_mat


@pytest.fixture(scope="module")
def answers(scene):
    frames, k_mat = scene
    out = sks_tpu_torch.planar_slam(
        7, frames, k_mat, RansacConfig(num_hypotheses=256, threshold=2.0,
                                       refine_iters=2, fused=True),
        num_corners=CONFIG["num_corners"], num_octaves=CONFIG["num_octaves"],
        plane_depth=CONFIG["plane_depth"], strides=tuple(CONFIG["strides"]),
        smooth=True, esm_iters=CONFIG["esm_iters"])
    ref = ref_slam.slam(frames, k_mat, CONFIG, 2048,
                        torch.Generator().manual_seed(8))
    return out, ref


def _rot_deg(a, b):
    r = a[..., :3, :3].transpose(-1, -2) @ b[..., :3, :3]
    cos = ((r.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2).clamp(-1, 1)
    return torch.rad2deg(torch.arccos(cos))


def test_relaxed_poses_match_the_reference(answers):
    """The two fit from different minimal sets, so a pair's consensus can
    differ by a point or two; on this size's 50-100 inliers a pair that
    moves a relative pose by up to 0.4 deg and 0.02 (rehearsed on 9
    seeds: relaxed poses 0.09-0.28 deg and 0.006-0.016 apart).  The bounds
    leave 3-4x that."""
    out, (poses_ref, rel_ref, _, _, _) = answers
    poses = out["poses"].double()
    assert poses.shape == poses_ref.shape == (T, 4, 4)
    assert _rot_deg(poses, poses_ref).max() < 1.0
    assert (poses[:, :3, 3] - poses_ref[:, :3, 3]).norm(dim=-1).max() < 0.05
    assert _rot_deg(out["rel"].double(), rel_ref).max() < 1.5


def test_inlier_counts_match_the_reference(answers):
    """Each count is that of the model kept after the guard, re-scored at
    2 px: the rehearsal's counts agreed within 1 of 50-100 (2%); the bound
    is 10%, and a closure is gated in by both or by neither."""
    out, (_, _, ninl_ref, ninl_c_ref, _) = answers
    ninl, ninl_c = out["num_inliers"], out["closure_inliers"]
    assert ninl.shape == ninl_ref.shape == (T - 1,)
    assert ninl_c.shape == ninl_c_ref.shape == (E,)

    def gap(n, n_ref):
        return ((n.double() - n_ref.double()).abs()
                / n_ref.double().clamp(min=1)).max()

    assert gap(ninl, ninl_ref) <= 0.1
    assert gap(ninl_c, ninl_c_ref) <= 0.1
    gate = ref_slam.CLOSURE_MIN_INLIERS
    assert torch.equal(ninl_c >= gate, ninl_c_ref >= gate)


def test_the_relaxation_is_the_exact_one_of_its_own_graph(answers):
    """The program's relaxed poses against the reference's exact
    Gauss-Newton (float64) of the graph the program returns: its relative
    poses, closure measurements and inlier counts.  The fits' noise drops
    out, so what is left is the CG's remainder and float32 rounding (read
    2.1e-6 deg and 5.2e-8 here, where the relaxation moves the poses by
    0.79 deg and 0.032); the bounds leave 100x that, and a relaxation left
    out would miss them by 3,000x."""
    out, _ = answers
    rel, rel_c = out["rel"].double(), out["closure_rel"].double()
    assert rel_c.shape == (E, 4, 4)
    own = ref_slam.relax(rel, out["num_inliers"], rel_c,
                         out["closure_inliers"],
                         ref_slam.closure_pairs(T, CONFIG["strides"]))
    poses, chain = out["poses"].double(), ref_slam.chain(rel)
    assert ref_slam.rot_gap_deg(poses, own).max() < 2e-4
    assert (poses[:, :3, 3] - own[:, :3, 3]).norm(dim=-1).max() < 1e-5
    assert (chain[:, :3, 3] - own[:, :3, 3]).norm(dim=-1).max() > 1e-3


def test_the_symmetric_polish_matches_the_reference(scene):
    """From the fit of frames 0 -> 4 moved by (0.7, -0.5) px, both polishes
    land at the same photometric optimum.  They differ by design in the coarse
    level's half-pixel conjugation, the Huber weights' form and the
    program's early stop: the rehearsal put them 0.005-0.12 px apart at
    the image corners (96 x 128 to 240 x 320); the bound is 0.25 px."""
    frames, _ = scene
    h0 = ref_fit.fit(*_matches(frames, 0, 4), 2.0, 2048,
                     torch.Generator().manual_seed(3))[0]
    h0 = h0 + torch.tensor([[0.0, 0.0, 0.7], [0.0, 0.0, -0.5],
                            [0.0, 0.0, 0.0]], dtype=h0.dtype)
    h_prog, _ = esm_polish_pair_symmetric(frames[0], frames[4], h0.float(),
                                          iters=8)
    h_ref = ref_slam.esm_symmetric(frames[0].double(), frames[4].double(),
                                   h0, 8)
    gap = ref_fit.corner_gap(h_prog.double(), h_ref, HW[1], HW[0])
    moved = ref_fit.corner_gap(h0, h_ref, HW[1], HW[0])
    assert gap < 0.25 and moved > 4 * gap


def _matches(frames, i, j):
    from benchmark.core import ref_vo

    f = frames[[i, j]].double()
    xy, valid, scale = ref_vo.corners_pyramid(f, 128, 2)
    desc = ref_vo.describe(f, xy, scale)
    idx2, ok = ref_vo.match(desc[:1], desc[1:], valid[:1], valid[1:])
    return xy[0][ok[0]], xy[1][idx2[0]][ok[0]]


def _graph(seed=0, k=10):
    """A random 10-pose graph: odometry edges and closures at strides 4 and
    8 measured with noise, weights 20-220, one closure gated out; the poses
    start from the odometry chain."""
    gen = torch.Generator().manual_seed(seed)
    dt = torch.float64
    scale = torch.tensor([0.3, 0.3, 0.3, 0.1, 0.1, 0.1], dtype=dt)
    truth = ref_slam.se3_exp(torch.randn((k, 6), generator=gen, dtype=dt)
                             * scale)
    truth[0] = torch.eye(4, dtype=dt)
    edges = [(i, i + 1) for i in range(k - 1)] + ref_slam.closure_pairs(
        k, (4, 8))
    noise = ref_slam.se3_exp(0.02 * torch.randn((len(edges), 6),
                                                generator=gen, dtype=dt))
    meas = torch.stack([ref_slam.inv_se3(truth[i]) @ truth[j]
                        for i, j in edges]) @ noise
    weights = 20 + 200 * torch.rand(len(edges), generator=gen, dtype=dt)
    weights[-1] = 0.0
    chain = [torch.eye(4, dtype=dt)]
    for e in range(k - 1):
        chain.append(chain[-1] @ meas[e])
    return torch.stack(chain), edges, meas, weights


@pytest.mark.parametrize("gn_iters,cg_iters,bound",
                         [(1, 80, 1e-9), (5, 30, 1e-5)])
def test_the_pose_graph_matches_dense_gauss_newton(gn_iters, cg_iters, bound):
    """float64.  One Gauss-Newton step with 80 CG steps, more than the 60
    unknowns, is the reference's exact solve to rounding (read 5.5e-11);
    the call's 5 steps of 30 leave the CG's unconverged remainder (read
    7.0e-8), under 1e-4 of how far the relaxation moves the poses."""
    poses, edges, meas, weights = _graph()
    graph = PoseGraph(poses=poses, edges=torch.tensor(edges), meas=meas,
                      weights=weights)
    prog = optimize_posegraph(graph, gn_iters=gn_iters,
                              cg_iters=cg_iters).poses
    ref = ref_slam.posegraph(poses, edges, meas, weights, iters=gn_iters)
    assert (ref[:, :3, 3] - poses[:, :3, 3]).abs().max() > 0.05
    assert (prog - ref).abs().max() < bound
