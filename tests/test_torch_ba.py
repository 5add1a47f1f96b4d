"""Port parity, bundle adjustment (``slam/ba.py``) against JAX, and the
checkpoints of ``slam/checkpoint.py``.

Problems come from the JAX package's ``synth_ba_problem`` and cross to the
port through ``utils.convert.ba_problem_from``; the JAX side is jitted on
the CPU backend.  Tolerances: in float64 (both sides run the same
Jacobians, blocks and solves; only summation order differs) poses and
points within 1e-6 of each field's largest entry after a step and after
five: camera 0 is gauged by a 1e12 diagonal, so the Schur system is
ill-conditioned and a reordered sum moves the solve by ~3e-7 relative.  In float32 that gauge
leaves the first steps' solves with few digits and the two packages' paths
part; both converge, and the converged reprojection RMS agrees within
1e-4 relative and the camera rotations within 1e-3 (the scale of the scene
is free, so positions are compared by their RMS only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_np

import sks_tpu.slam.ba as jb

import sks_tpu_torch.slam.ba as tb
from sks_tpu_torch.slam.checkpoint import latest_step, restore_state, save_state
from sks_tpu_torch.slam.posegraph import PoseGraph
from sks_tpu_torch.utils.convert import ba_problem_from


def _carry(problem) -> tb.BAProblem:
    return ba_problem_from({k: np.asarray(v) for k, v in
                            dataclasses.asdict(problem).items()})


@pytest.fixture(scope="module")
def problem64():
    """(gt, init) of K = 4 cameras and L = 64 landmarks in float64."""
    return jb.synth_ba_problem(jax.random.PRNGKey(0), num_cams=4,
                               num_points=64, dtype=jnp.float64)


def _close(got: tb.BAProblem, want, rtol):
    """Within ``rtol`` of each field's largest entry."""
    for name in ("poses", "points"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(to_np(getattr(got, name)), w, rtol=0,
                                   atol=rtol * np.abs(w).max())


def test_normal_blocks_and_residuals_match_jax(problem64):
    _, init = problem64
    ours = _carry(init)
    rng = np.random.default_rng(1)
    dx_c = rng.normal(0.0, 0.01, (4, 6))
    dx_p = rng.normal(0.0, 0.01, (64, 3))
    np.testing.assert_allclose(
        to_np(tb.ba_residuals(ours, torch.from_numpy(dx_c),
                              torch.from_numpy(dx_p))),
        np.asarray(jax.jit(jb.ba_residuals)(init, dx_c, dx_p)), atol=1e-9)
    for got, want in zip(tb.build_normal_blocks(ours),
                         jax.jit(jb.build_normal_blocks)(init)):
        want = np.asarray(want)
        np.testing.assert_allclose(to_np(got), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


def test_gauss_newton_step_and_run_ba_match_jax(problem64):
    _, init = problem64
    ours = _carry(init)
    _close(tb.gauss_newton_step(ours), jb.gauss_newton_step(init), 1e-6)
    want = jb.run_ba(init, iters=5)
    got = tb.run_ba(ours, iters=5)
    _close(got, want, 1e-6)
    np.testing.assert_allclose(float(tb.rms_reprojection(got)),
                               float(jb.rms_reprojection(want)), rtol=1e-6)
    assert float(tb.rms_reprojection(ours)) > 10.0 > 1.0 > float(
        tb.rms_reprojection(got))


def test_float32_ba_converges_where_jax_does():
    _, init = jb.synth_ba_problem(jax.random.PRNGKey(0), num_cams=8,
                                  num_points=512, dtype=jnp.float32)
    want = jb.run_ba(init, iters=6, damping=1e-4)
    got = tb.run_ba(_carry(init), iters=6, damping=1e-4)
    rms_j, rms_t = (float(jb.rms_reprojection(want)),
                    float(tb.rms_reprojection(got)))
    np.testing.assert_allclose(rms_t, rms_j, rtol=1e-4)
    assert rms_t < 1.2 * 0.5  # the 0.5 px observation noise
    np.testing.assert_allclose(to_np(got.poses[:, :3, :3]),
                               np.asarray(want.poses[:, :3, :3]), atol=1e-3)


def test_masked_observations_reach_the_exact_optimum(problem64):
    """Exact observations (the ground truth's projections), a third of them
    dropped: GN reaches reprojection ~0 (the JAX package's own test)."""
    gt, init = problem64
    gt_t = _carry(gt)
    gt_t.obs = torch.zeros_like(gt_t.obs)
    gt_t.mask = torch.ones_like(gt_t.mask)
    exact = _carry(init)
    exact.obs = tb.ba_residuals(gt_t)  # the exact projections
    exact.mask[:, ::3] = 0.0
    out = tb.run_ba(exact, iters=6)
    assert float(tb.rms_reprojection(exact)) > 1.0
    assert float(tb.rms_reprojection(out)) < 1e-6


def test_synth_ba_problem_is_the_reference_problem():
    gen = torch.Generator().manual_seed(0)
    gt, init = tb.synth_ba_problem(gen, num_cams=6, num_points=256,
                                   dtype=torch.float64)
    assert init.poses.shape == (6, 4, 4) and init.points.shape == (256, 3)
    assert init.obs.shape == (6, 256, 2) and init.mask.shape == (6, 256)
    assert 0.7 < float(init.mask.mean()) < 0.9
    np.testing.assert_allclose(float(tb.rms_reprojection(gt)), 0.5,
                               rtol=0.15)
    out = tb.run_ba(init, iters=6, damping=1e-4)
    assert float(tb.rms_reprojection(init)) > 5.0
    assert float(tb.rms_reprojection(out)) < 1.2 * 0.5


def test_checkpoint_round_trip(tmp_path, problem64):
    _, init = problem64
    ours = _carry(init)
    assert latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        restore_state(tmp_path)
    save_state(tmp_path, 3, ours)
    save_state(tmp_path, 10, tb.gauss_newton_step(ours))
    plain = {"step": 7, "poses": ours.poses, "nested": {
        "pair": (torch.arange(4), 2.5)}}
    save_state(tmp_path / "plain", 7, plain)
    assert latest_step(tmp_path) == 10
    # With a template: the dataclass, on the template's device and dtype.
    back = restore_state(tmp_path, step=3, template=ours)
    assert isinstance(back, tb.BAProblem)
    for f in dataclasses.fields(back):
        assert torch.equal(getattr(back, f.name), getattr(ours, f.name))
    latest = restore_state(tmp_path, template=ours)
    assert torch.equal(latest.poses, tb.gauss_newton_step(ours).poses)
    # Without one: dicts of CPU tensors.
    as_dict = restore_state(tmp_path, step=3)
    assert set(as_dict) == {f.name for f in dataclasses.fields(ours)}
    assert torch.equal(as_dict["points"], ours.points)
    got = restore_state(tmp_path / "plain")
    assert got["step"] == 7 and torch.equal(got["poses"], ours.poses)
    assert torch.equal(got["nested"]["pair"][0], torch.arange(4))
    assert got["nested"]["pair"][1] == 2.5
    # A pose graph restores into its dataclass; a wrong shape is refused.
    graph = PoseGraph(poses=ours.poses, edges=torch.tensor([[0, 1]]),
                      meas=ours.poses[:1], weights=torch.ones(1))
    save_state(tmp_path / "graph", 0, graph)
    assert torch.equal(restore_state(tmp_path / "graph",
                                     template=graph).edges, graph.edges)
    with pytest.raises(ValueError, match="shape"):
        restore_state(tmp_path, step=3, template=dataclasses.replace(
            ours, points=ours.points[:5]))
