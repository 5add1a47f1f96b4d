"""Port parity, the pose graph (``slam/posegraph.py``) against JAX.

One seeded numpy graph (a drifted chain of 8 poses with odometry edges and
two loop closures) goes to both packages; the port's copy comes through
``utils.convert.posegraph_from``.  The JAX side is jitted on the CPU
backend.  Tolerance: optimized poses within 1e-4 (float32, matrix-free
Gauss-Newton with a fixed number of CG steps on both sides), residuals
within 1e-5.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from torch_parity import to_np

import sks_tpu.slam.posegraph as jpg
from sks_tpu.geom.lie import se3_exp as jse3_exp

import sks_tpu_torch.slam.posegraph as tpg
from sks_tpu_torch.utils.convert import posegraph_from

K_NODES = 8


@pytest.fixture(scope="module")
def graph():
    """(numpy graph fields, ground-truth poses)."""
    rng = np.random.default_rng(11)
    xi = np.zeros((K_NODES, 6), np.float32)
    xi[:, 0] = np.linspace(0.0, 0.7, K_NODES)
    xi[:, 4] = np.linspace(0.0, 0.3, K_NODES)
    poses_gt = np.asarray(jax.jit(jse3_exp)(xi))
    edges = np.array([(i, i + 1) for i in range(K_NODES - 1)]
                     + [(0, 4), (2, 7)], np.int32)
    inv = np.linalg.inv
    meas = np.stack([inv(poses_gt[i]) @ poses_gt[j] for i, j in edges])
    noise = jax.jit(jse3_exp)(
        (rng.normal(size=(K_NODES, 6)) * 0.02).astype(np.float32))
    poses0 = [poses_gt[0]]
    for i in range(1, K_NODES):
        poses0.append(poses0[-1] @ meas[i - 1] @ np.asarray(noise[i]))
    fields = {"poses": np.stack(poses0).astype(np.float32), "edges": edges,
              "meas": meas.astype(np.float32),
              "weights": rng.uniform(0.5, 2.0, len(edges)).astype(np.float32)}
    return fields, poses_gt


def _jax_graph(fields):
    return jpg.PoseGraph(**{k: jax.numpy.asarray(v) for k, v in fields.items()})


def test_posegraph_from_carries_the_jax_graph(graph):
    fields, _ = graph
    g = _jax_graph(fields)
    got = posegraph_from({k: np.asarray(v)
                          for k, v in dataclasses.asdict(g).items()})
    assert got.edges.dtype == torch.int64
    for k, v in fields.items():
        np.testing.assert_array_equal(to_np(getattr(got, k)), v)
    with pytest.raises(ValueError, match="fields"):
        posegraph_from({"poses": fields["poses"]})


def test_residuals_match_jax_and_weight_zero_disables_an_edge(graph):
    fields, _ = graph
    dx = (np.random.default_rng(1).normal(size=(K_NODES, 6)) * 0.01).astype(
        np.float32)
    want = np.asarray(jax.jit(jpg.posegraph_residuals)(_jax_graph(fields),
                                                       dx))
    got = tpg.posegraph_residuals(posegraph_from(fields), torch.from_numpy(dx))
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=1e-5)
    w = fields["weights"].copy()
    w[3] = 0.0
    r = tpg.posegraph_residuals(posegraph_from({**fields, "weights": w}))
    assert float(torch.sum(r[3] ** 2)) == 0.0
    assert float(torch.sum(r[2] ** 2)) > 0.0


@pytest.mark.parametrize("dense", [False, True])
def test_optimize_matches_jax(graph, dense):
    fields, poses_gt = graph
    if dense:
        jfn = functools.partial(jpg.optimize_posegraph_dense, gn_iters=5)
        tfn = functools.partial(tpg.optimize_posegraph_dense, gn_iters=5)
    else:
        jfn = functools.partial(jpg.optimize_posegraph, gn_iters=5,
                                cg_iters=30)
        tfn = functools.partial(tpg.optimize_posegraph, gn_iters=5,
                                cg_iters=30)
    want = np.asarray(jax.jit(jfn)(_jax_graph(fields)).poses)
    got = tfn(posegraph_from(fields)).poses
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=1e-4)
    # The relaxation moves the drifted chain towards the truth.
    before = float(tpg.ate_rmse(torch.from_numpy(fields["poses"]),
                                torch.from_numpy(poses_gt)))
    after = float(tpg.ate_rmse(got, torch.from_numpy(poses_gt)))
    assert after < 0.5 * before, (before, after)
    np.testing.assert_allclose(
        after, float(jpg.ate_rmse(want, poses_gt)), rtol=0, atol=1e-5)


def test_dense_and_matrix_free_agree(graph):
    fields, _ = graph
    g = posegraph_from(fields)
    cg = tpg.optimize_posegraph(g, gn_iters=6, cg_iters=40).poses
    dense = tpg.optimize_posegraph_dense(g, gn_iters=6).poses
    np.testing.assert_allclose(to_np(cg), to_np(dense), rtol=0, atol=1e-4)
