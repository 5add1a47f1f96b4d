"""Port parity, the multi-device layer (``sks_tpu_torch/parallel``), on gloo
ranks on the CPU.

One group of world size 2 and one of 4 run every check of the ``core``
suite of ``tests/torch_ranks.py`` at once, as spawned processes; while they
run, this process computes the references: the port's single-device forms
and the JAX package's sharded forms on its 8-device CPU mesh.  Every rank
must return the same result (the forms' outputs are replicated), and:

* the mesh layout, its gathers along a tuple of axes (rank-major in the
  tuple's order) and its reductions, as ``tests/test_parallel.py`` lays
  meshes out;
* the sharded pose graph equals the port's single-device form and the JAX
  sharded form within 1e-4, the bound ``tests/test_torch_posegraph.py``
  holds the CG pose graph to (against JAX, and against the dense solve):
  the 1e6 gauge prior leaves float64 CG unable to pin the solve below
  ~1e-7 at any step count, and 40 steps carry a rounding difference
  further (each rank maps its edges' cotangents back to the twists before
  the reduction, the single form after it: ~7e-6 apart);
* the sharded BA step equals the port's single-device step within 1e-7 of
  each field's largest entry (float64; the 1e12 gauge on camera 0 carries
  the reordered landmark sums to ~1e-8 of it, where the JAX test's 1e-8
  absolute bound holds in JAX's own order) and the JAX sharded step within
  the port-vs-JAX bound of ``tests/test_torch_ba.py``, 1e-6 of the largest
  entry;
* sharded NDLT and HO equal the single-device forms within 5e-6 after
  ``normalize_h(..., 'fro')`` (the JAX tests' bound), a ragged point count
  included, and the JAX sharded forms within 5e-5 (XLA contracts
  multiply-adds, the port does not);
* sharded RANSAC on JAX's own draws (``fold_in(key, d)``, d < 8, injected
  through ``indices=``) gives the single fit's H and inlier mask on those
  draws, and JAX's sharded fit within the bound of
  ``tests/test_torch_ransac.py``; the fused fit equals the general one; a
  seeded fit equals the single fit on the ranks' streams, and the same on a
  ``('host', 'hyp')`` mesh;
* ``bench/ba_scale.run`` converges at a small size;
* a data-parallel train step of 2 (and 4) ranks equals one rank on the
  whole batch of 16, in float64: loss and parameters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import apply_h, contaminated, plane_h, to_np
from torch_ranks import launch

import sks_tpu.robust.ransac as jr
from sks_tpu.parallel import make_mesh as jmake_mesh
from sks_tpu.parallel.sharded_ba import shard_problem as jshard_problem
from sks_tpu.parallel.sharded_ba import sharded_gauss_newton_step as jsharded_gn
from sks_tpu.parallel.sharded_posegraph import (
    shard_graph as jshard_graph,
    sharded_optimize_posegraph as jsharded_pg,
)
from sks_tpu.parallel.sharded_ransac import (
    sharded_ransac_homography as jsharded_ransac,
)
from sks_tpu.parallel.sharded_refine import sharded_ho_h as jsharded_ho
from sks_tpu.parallel.sharded_refine import sharded_ndlt_h as jsharded_ndlt
from sks_tpu.slam.posegraph import PoseGraph as JPoseGraph

import sks_tpu_torch.robust.ransac as tr
from sks_tpu_torch.geom.homography import normalize_h
from sks_tpu_torch.models import create_train_state, train_step
from sks_tpu_torch.models.deep_homography import synth_training_batch
from sks_tpu_torch.models.iterative import create_ihn_state, ihn_train_step
from sks_tpu_torch.ops.ho import ho_h
from sks_tpu_torch.ops.ndlt import ndlt_h
from sks_tpu_torch.slam.ba import BAProblem, gauss_newton_step
from sks_tpu_torch.slam.posegraph import PoseGraph, optimize_posegraph
from sks_tpu_torch.utils.streams import pair_generators

T = torch.from_numpy
KEY = jax.random.PRNGKey(0)
WORLDS = (2, 4)
RAGGED = 1021  # a point count that splits over neither 2 nor 4
RS_B, RS_N, RS_THRESHOLD = 512, 128, 4.0


def _fro(h) -> np.ndarray:
    return to_np(normalize_h(torch.as_tensor(np.asarray(h)), "fro"))


def _problems():
    """Every input of the ``core`` suite, numpy, with the JAX-made BA
    problem and ring graph of ``tests/test_slam.py``."""
    from test_slam import _ba_setup, _ring_graph

    rng = np.random.default_rng(0)
    out = {"ragged": np.array(RAGGED)}
    for name, n, noise in (("ndlt", 1024, 1.0), ("ho", 512, 0.5)):
        h = plane_h(rng)
        src = rng.uniform((0.0, 0.0), (640.0, 480.0), (n, 2))
        tar = apply_h(h, src) + noise * rng.normal(size=(n, 2))
        out[f"{name}_src"] = src.astype(np.float32)
        out[f"{name}_tar"] = tar.astype(np.float32)
    out["ndlt_w"] = (rng.uniform(size=1024) > 0.2).astype(np.float32)

    _, prob = jax.jit(_ba_setup)(KEY)
    for k in ("poses", "points", "intrinsics", "obs", "mask"):
        out[f"ba_{k}"] = np.asarray(getattr(prob, k))
    # 14 edges: world 4 pads two.
    graph, _ = jax.jit(lambda k: _ring_graph(k, n=14))(KEY)
    for k in ("poses", "edges", "meas", "weights"):
        out[f"pg_{k}"] = np.asarray(getattr(graph, k))

    src, tar, _, _ = contaminated(5, n=RS_N, outlier_frac=0.5, noise=0.5)
    out["rs_src"], out["rs_tar"] = src, tar
    out["rs_b"], out["rs_threshold"] = np.array(RS_B), np.array(RS_THRESHOLD)
    # The JAX sharded fit's own draws on its 8-device mesh.
    out["rs_indices"] = np.asarray(jax.jit(lambda k: jnp.concatenate([
        jr.sample_minimal_sets(jax.random.fold_in(k, d), RS_N, RS_B // 8)
        for d in range(8)]))(KEY))

    coarse = rng.uniform(size=(16, 8, 8))
    fine = rng.uniform(size=(16, 24, 24))
    offsets = rng.uniform(-8.0, 8.0, (16, 4, 2))
    pair, off = synth_training_batch(None, 16, 32, dtype=torch.float64,
                                     draws=(T(coarse), T(fine), T(offsets)))
    out["dp_pair"], out["dp_offsets"] = pair.numpy(), off.numpy()
    return out


@pytest.fixture(scope="module")
def problems():
    return _problems()


@pytest.fixture(scope="module")
def launched(problems, tmp_path_factory):
    return {w: launch("core", w, problems, tmp_path_factory.mktemp(f"core{w}"))
            for w in WORLDS}


def _jax_refs(p):
    """The JAX package's sharded forms on its 8-device CPU mesh."""
    out = {}
    mesh = jmake_mesh({"pts": 8})
    out["ndlt"] = jax.jit(lambda s, t, w: jsharded_ndlt(mesh, s, t, w))(
        p["ndlt_src"], p["ndlt_tar"], p["ndlt_w"])
    out["ho"] = jax.jit(lambda s, t: jsharded_ho(mesh, s, t))(
        p["ho_src"], p["ho_tar"])
    from sks_tpu.slam.ba import BAProblem as JBAProblem

    prob = JBAProblem(*(jnp.asarray(p[f"ba_{k}"]) for k in (
        "poses", "points", "intrinsics", "obs", "mask")))
    lm = jmake_mesh({"lm": 8})
    step = jsharded_gn(lm, jshard_problem(prob, lm), 1e-6)
    out["ba_poses"], out["ba_points"] = step.poses, step.points
    pad = -p["pg_edges"].shape[0] % 8
    graph = JPoseGraph(
        poses=jnp.asarray(p["pg_poses"]),
        edges=jnp.concatenate([p["pg_edges"], np.zeros((pad, 2),
                                                       p["pg_edges"].dtype)]),
        meas=jnp.concatenate([p["pg_meas"], np.broadcast_to(np.eye(4),
                                                            (pad, 4, 4))]),
        weights=jnp.concatenate([p["pg_weights"], np.zeros(pad)]))
    edge = jmake_mesh({"edge": 8})
    out["pg_poses"] = jsharded_pg(edge, jshard_graph(graph, edge),
                                  gn_iters=3, cg_iters=40).poses
    hyp = jmake_mesh({"hyp": 8})
    jcfg = jr.RansacConfig(num_hypotheses=RS_B, threshold=RS_THRESHOLD)
    out["rs"] = jax.jit(lambda s, t: jsharded_ransac(hyp, KEY, s, t, jcfg))(
        p["rs_src"], p["rs_tar"])
    return {k: v if k == "rs" else np.asarray(v) for k, v in out.items()}


def _dp_single(p):
    """One train step of each model on the whole batch, on one process."""
    out = {}
    for name, create, step_fn, kw in (
            ("hnet", create_train_state, train_step, {}),
            ("ihn", create_ihn_state, ihn_train_step, {"iters": 2})):
        model, state = create(torch.Generator().manual_seed(3), 32,
                              dtype=torch.float64, device="cpu", **kw)
        _, loss = step_fn(model, state, T(p["dp_pair"]), T(p["dp_offsets"]))
        out[f"{name}_loss"] = loss.numpy()
        out[f"{name}_params"] = torch.cat(
            [q.detach().reshape(-1) for q in model.parameters()]).numpy()
    return out


@pytest.fixture(scope="module")
def refs(problems, launched):
    """References, computed while the ranks run."""
    p = problems
    t = {k: T(np.array(v)) for k, v in p.items()}
    out = {"jax": _jax_refs(p), "dp": _dp_single(p)}
    out["ndlt"] = ndlt_h(t["ndlt_src"], t["ndlt_tar"], t["ndlt_w"])
    out["ndlt_ragged"] = ndlt_h(t["ndlt_src"][:RAGGED],
                                t["ndlt_tar"][:RAGGED], t["ndlt_w"][:RAGGED])
    out["ho"] = ho_h(t["ho_src"], t["ho_tar"])
    out["ho_ragged"] = ho_h(t["ho_src"][:RAGGED], t["ho_tar"][:RAGGED])
    step = gauss_newton_step(BAProblem(*(t[f"ba_{k}"] for k in (
        "poses", "points", "intrinsics", "obs", "mask"))), 1e-6)
    out["ba_poses"], out["ba_points"] = step.poses, step.points
    out["pg_poses"] = optimize_posegraph(PoseGraph(*(t[f"pg_{k}"] for k in (
        "poses", "edges", "meas", "weights"))), gn_iters=3,
        cg_iters=40).poses
    cfg = tr.RansacConfig(num_hypotheses=RS_B, threshold=RS_THRESHOLD)
    out["rs_general"] = tr.ransac_homography(None, t["rs_src"], t["rs_tar"],
                                             cfg, indices=t["rs_indices"])
    for w in WORLDS:
        # Rank d's draws: stream d of seed 7.
        idx = torch.cat([tr.sample_minimal_sets(g, RS_N, RS_B // w)
                         for g in (pair_generators(7, 1, offset=d)[0]
                                   for d in range(w))])
        out[f"rs_seeded_{w}"] = tr.ransac_homography(
            None, t["rs_src"], t["rs_tar"], cfg, indices=idx)
    return out


@pytest.fixture(scope="module")
def ranks(launched, refs):
    return {w: g.wait() for w, g in launched.items()}


def _each_rank(ranks, name):
    """(world, rank, value) of ``name`` on every rank; the ranks agree."""
    for w, outs in ranks.items():
        for r, out in enumerate(outs):
            np.testing.assert_array_equal(out[name], outs[0][name],
                                          err_msg=f"{name} world {w} rank {r}")
            yield w, r, out[name]


@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh_shapes_and_collectives(ranks, world):
    outs = ranks[world]
    for r, out in enumerate(outs):
        assert out["mesh_hyp"].tolist() == [world]
        assert out["mesh_dp_mp"].tolist() == [2, world // 2]
        assert out["replicated"].tolist() == [0.0]
        dp, mp = divmod(r, world // 2)
        # Rank-major in the tuple's order: ('mp', 'dp') puts dp innermost.
        want = [dd * (world // 2) + mm for mm in range(world // 2)
                for dd in range(2)]
        assert out["gather_mp_dp"].tolist() == want
        assert out["gather_dp"].tolist() == [d * (world // 2) + mp
                                             for d in range(2)]
        assert out["psum_mp"].tolist() == [sum(dp * (world // 2) + m
                                               for m in range(world // 2))]
        assert out["host_shape"].tolist() == [2, world // 2]


@pytest.mark.parametrize("name", ["ndlt", "ndlt_ragged", "ho", "ho_ragged"])
def test_sharded_refine_matches_single_device_and_jax(ranks, refs, name):
    want = _fro(refs[name])
    for w, r, h in _each_rank(ranks, name):
        np.testing.assert_allclose(_fro(h), want, atol=5e-6)
        if "ragged" not in name:
            np.testing.assert_allclose(_fro(h), _fro(refs["jax"][name]),
                                       atol=5e-5)


@pytest.mark.parametrize("field", ["poses", "points"])
def test_sharded_ba_step_matches_single_device_and_jax(ranks, refs, field):
    name = f"ba_{field}"
    want, jax_ = to_np(refs[name]), refs["jax"][name]
    for w, r, got in _each_rank(ranks, name):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-7 * np.abs(want).max())
        np.testing.assert_allclose(got, jax_, rtol=0,
                                   atol=1e-6 * np.abs(jax_).max())


def test_sharded_posegraph_matches_single_device_and_jax(ranks, refs):
    want, jax_ = to_np(refs["pg_poses"]), refs["jax"]["pg_poses"]
    for w, r, got in _each_rank(ranks, "pg_poses"):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got, jax_, rtol=0, atol=1e-4)


def test_sharded_ransac_on_jax_draws_is_the_single_fit(ranks, refs):
    single, jres = refs["rs_general"], refs["jax"]["rs"]
    for w, r, h in _each_rank(ranks, "rs_general_h"):
        mask = ranks[w][r]["rs_general_mask"]
        np.testing.assert_allclose(h, to_np(single.h), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(mask, to_np(single.inlier_mask))
        np.testing.assert_allclose(_fro(h), _fro(jres.h), atol=1e-4)
        agree = np.mean(mask == np.asarray(jres.inlier_mask))
        assert agree >= 0.995, agree


@pytest.mark.parametrize("fused, general", [("rs_fused", "rs_general"),
                                             ("rs_seeded_fused", "rs_seeded")])
def test_sharded_ransac_fused_equals_general(ranks, fused, general):
    for w, r, h in _each_rank(ranks, f"{fused}_h"):
        out = ranks[w][r]
        np.testing.assert_allclose(_fro(h), _fro(out[f"{general}_h"]),
                                   atol=1e-6)
        np.testing.assert_array_equal(out[f"{fused}_mask"],
                                      out[f"{general}_mask"])


def test_seeded_sharded_ransac_draws_the_ranks_streams(ranks, refs):
    for w, r, h in _each_rank(ranks, "rs_seeded_h"):
        single = refs[f"rs_seeded_{w}"]
        np.testing.assert_allclose(h, to_np(single.h), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(ranks[w][r]["rs_seeded_mask"],
                                      to_np(single.inlier_mask))
        # A ('host', 'hyp') mesh linearizes to the same ranks' streams.
        np.testing.assert_array_equal(ranks[w][r]["rs_host_h"], h)


def test_ba_scale_converges_on_gloo_ranks(ranks):
    for w, r, rms in _each_rank(ranks, "ba_scale_rms"):
        out = ranks[w][r]
        assert bool(out["ba_scale_converged"]), rms
        assert int(out["ba_scale_devices"]) == w
        assert rms[0] > 5.0 and rms[-1] < 0.6, rms


@pytest.mark.parametrize("model", ["hnet", "ihn"])
def test_data_parallel_train_step_equals_one_rank(ranks, refs, model):
    want = refs["dp"]
    for w, outs in ranks.items():
        for r, out in enumerate(outs):
            np.testing.assert_allclose(out[f"{model}_loss"],
                                       want[f"{model}_loss"], rtol=1e-12)
            assert float(out[f"{model}_params_off_rank0"]) == 0.0
        np.testing.assert_allclose(outs[0][f"{model}_params"],
                                   want[f"{model}_params"], rtol=0,
                                   atol=1e-10)


def test_make_mesh_needs_a_group_and_a_layout():
    """In this process (no group): a mesh needs one; the axis sizes must
    hold the world, one -1 taking the rest; 'cuda' needs a card."""
    from sks_tpu_torch.parallel.mesh import _resolve, local_device, make_mesh

    with pytest.raises(RuntimeError, match="initialize_multihost"):
        make_mesh(None, "cpu")
    assert _resolve({"dp": 2, "mp": -1}, 8) == {"dp": 2, "mp": 4}
    assert _resolve({"hyp": 8}, 8) == {"hyp": 8}
    for bad in ({"hyp": 3}, {"a": -1, "b": -1}, {"a": 3, "b": -1}):
        with pytest.raises(ValueError):
            _resolve(bad, 8)
    assert local_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="device_type"):
        local_device("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            local_device("cuda")
