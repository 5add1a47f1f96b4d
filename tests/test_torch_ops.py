"""Port parity, ops and geometry: sks_tpu_torch against sks_tpu on one input.

Covers ops/aca, geom/homography, ops/linalg, ops/ndlt, ops/affine, the solver
registries and the package itself.  Inputs are seeded numpy; the JAX side runs
jitted on the CPU backend.
"""

import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import jit_of
from torch_parity import apply_h, fro, plane_h, quads, to_np

import sks_tpu.geom.homography as jgeom
import sks_tpu.ops as jops
from sks_tpu.ops import linalg as jlinalg

import sks_tpu_torch
import sks_tpu_torch.geom.homography as tgeom
import sks_tpu_torch.ops as tops
from sks_tpu_torch.ops import linalg as tlinalg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jaca = importlib.import_module("sks_tpu.ops.aca")
jndlt = importlib.import_module("sks_tpu.ops.ndlt")
tndlt = importlib.import_module("sks_tpu_torch.ops.ndlt")

# Tolerances after normalize_h('fro').  f64: 1e-12.  f32: the port rounds
# every op on its own (as the CUDA kernels do, built with -fmad=false) and so
# equals the JAX package's aca_core evaluated op by op in numpy float32 bit
# for bit; XLA on the CPU contracts multiply-adds into FMAs, which ACA's
# float32 conditioning at pixel scale turns into up to 4e-5 on the
# normalized H (measured over 2048 quads).
ATOL = {np.float32: 5e-5, np.float64: 1e-12}


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_aca_h_matches_jax(dt):
    src, tar = quads(0, 256, dt)
    hj = jit_of(jops.aca_h)(src, tar)
    ht = tops.aca_h(torch.from_numpy(src), torch.from_numpy(tar))
    assert ht.dtype == torch.from_numpy(src).dtype and ht.shape == (256, 3, 3)
    np.testing.assert_allclose(fro(to_np(ht)), fro(hj), rtol=0, atol=ATOL[dt])
    # Bit for bit against the JAX package's own core, op by op in numpy.
    hn = jaca.aca_core(*src.reshape(-1, 8).T, *tar.reshape(-1, 8).T)
    np.testing.assert_array_equal(to_np(ht), np.stack(hn, -1).reshape(-1, 3, 3))


def test_aca_normalized_matches_jax():
    src, tar = quads(1, 128, np.float64)
    hj = jit_of(jops.aca)(src, tar)
    ht = tops.aca(torch.from_numpy(src), torch.from_numpy(tar))
    np.testing.assert_allclose(to_np(ht), np.asarray(hj), rtol=1e-10)
    np.testing.assert_allclose(to_np(ht)[:, 2, 2], 1.0)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_aca_valid_mask_matches_jax(dt):
    src, tar = quads(2, 64, dt)
    # Collinear anchors in either plane: P on the line M-N.
    src[:8, 2] = src[:8, 0] + 0.5 * (src[:8, 1] - src[:8, 0])
    tar[8:12, 2] = tar[8:12, 0] + 2.0 * (tar[8:12, 1] - tar[8:12, 0])
    mj = np.asarray(jit_of(jops.aca_valid_mask)(src, tar))
    mt = to_np(tops.aca_valid_mask(torch.from_numpy(src), torch.from_numpy(tar)))
    assert not mt[:12].any() and mt[12:].all()
    np.testing.assert_array_equal(mt, mj)


def _geom_case(name):
    rng = np.random.default_rng(3)
    hs = np.stack([plane_h(rng) for _ in range(4)]).astype(np.float32)
    pts = rng.uniform(0.0, 640.0, (4, 32, 2)).astype(np.float32)
    tar = np.stack([apply_h(h, p) for h, p in zip(hs, pts)]).astype(np.float32)
    tar = tar + rng.normal(0.0, 1.0, tar.shape).astype(np.float32)
    return {
        "apply_homography": ("apply_homography", (hs, pts)),
        "inv_h": ("inv_h", (hs,)),
        "normalize_last": ("normalize_h", (hs, "last")),
        "normalize_fro": ("normalize_h", (hs, "fro")),
        "symmetric_transfer_error": ("symmetric_transfer_error",
                                     (hs, pts, tar)),
        "reprojection_error": ("reprojection_error", (hs, pts, tar)),
    }[name]


@pytest.mark.parametrize("name", [
    "apply_homography", "inv_h", "normalize_last", "normalize_fro",
    "symmetric_transfer_error", "reprojection_error",
])
def test_geom_matches_jax(name):
    fn_name, args = _geom_case(name)
    jfn, tfn = getattr(jgeom, fn_name), getattr(tgeom, fn_name)
    arrays = [a for a in args if isinstance(a, np.ndarray)]
    rest = [a for a in args if not isinstance(a, np.ndarray)]
    out_j = jax.jit(lambda *a: jfn(*a, *rest))(*arrays)
    out_t = tfn(*[torch.from_numpy(a) for a in arrays], *rest)
    # float32 at pixel scale; XLA's FMA contraction moves the reverse transfer
    # of the symmetric error (through the adjugate) by up to ~1e-3 px^2.
    atol = 2e-3 if name == "symmetric_transfer_error" else 1e-4
    np.testing.assert_allclose(to_np(out_t), np.asarray(out_j), rtol=1e-5,
                               atol=atol)


def test_homography_from_pose_matches_jax():
    rng = np.random.default_rng(4)
    k = np.broadcast_to(np.array([[500.0, 0, 300], [0, 520.0, 200], [0, 0, 1]]),
                        (3, 3, 3)).copy()
    r = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(3)])
    t = rng.normal(size=(3, 3))
    n = rng.normal(size=(3, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.uniform(2.0, 5.0, 3)
    hj = jax.jit(jgeom.homography_from_pose)(k, k, r, t, n, d)
    ht = tgeom.homography_from_pose(*(torch.from_numpy(a) for a in
                                      (k, k, r, t, n, d)))
    np.testing.assert_allclose(to_np(ht), np.asarray(hj), rtol=1e-10,
                               atol=1e-10)


def _sym(seed, dt):
    a = np.random.default_rng(seed).normal(size=(6, 9, 9))
    return (a @ np.swapaxes(a, -1, -2)).astype(dt)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_jacobi_eigh_matches_jax(dt):
    a = _sym(5, dt)
    wj, vj = jax.jit(jlinalg.jacobi_eigh)(a)
    wt, vt = tlinalg.jacobi_eigh(torch.from_numpy(a))
    wj, vj, wt, vt = map(to_np, (wj, vj, wt, vt))
    scale = np.abs(wj).max()
    np.testing.assert_allclose(wt / scale, wj / scale, atol=1e-4)
    # Eigenvectors up to sign.
    sign = np.sign(np.sum(vt * vj, axis=-2, keepdims=True))
    np.testing.assert_allclose(vt * sign, vj, atol=1e-4)
    # And they do diagonalize the input.
    recon = vt @ (wt[..., None] * np.swapaxes(vt, -1, -2))
    np.testing.assert_allclose(recon / scale, a / scale, atol=1e-4)


def test_mm_highest_is_exact_f32_product():
    rng = np.random.default_rng(6)
    a = rng.normal(size=(5, 3, 3)).astype(np.float32)
    b = rng.normal(size=(5, 3, 3)).astype(np.float32)
    out = to_np(tlinalg.mm_highest(torch.from_numpy(a), torch.from_numpy(b)))
    ref = np.asarray(jax.jit(jlinalg.mm_highest)(a, b))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_hartley_matches_jax():
    rng = np.random.default_rng(7)
    pts = rng.uniform(0.0, 640.0, (3, 40, 2)).astype(np.float32)
    w = (rng.uniform(size=(3, 40)) > 0.3).astype(np.float32)
    nj, pj = jax.jit(jndlt._hartley)(pts, w)
    nt, pt = tndlt._hartley(torch.from_numpy(pts), torch.from_numpy(w))
    np.testing.assert_allclose(to_np(nt), np.asarray(nj), rtol=1e-5, atol=1e-5)
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-5)
    cj = np.asarray(jax.jit(lambda *p: jndlt._t_matrix(*p))(*pj))
    ct = to_np(tndlt._t_matrix(*pt))
    np.testing.assert_allclose(ct, cj, rtol=1e-5, atol=1e-5)
    cj = np.asarray(jax.jit(lambda *p: jndlt._t_inv_matrix(*p))(*pj))
    ct = to_np(tndlt._t_inv_matrix(*pt))
    np.testing.assert_allclose(ct, cj, rtol=1e-5, atol=1e-5)


def _ndlt_inputs(seed, dt, batch=(3,), n=40):
    rng = np.random.default_rng(seed)
    h = plane_h(rng)
    src = rng.uniform((0.0, 0.0), (640.0, 480.0), (*batch, n, 2))
    tar = apply_h(h, src) + rng.normal(0.0, 0.5, src.shape)
    w = (rng.uniform(size=(*batch, n)) > 0.2).astype(np.float64)
    return src.astype(dt), tar.astype(dt), w.astype(dt), h


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_ndlt_h_weighted_matches_jax(dt):
    src, tar, w, h_true = _ndlt_inputs(8, dt)
    hj = jax.jit(jndlt.ndlt_h)(src, tar, w)
    ht = tndlt.ndlt_h(*(torch.from_numpy(a) for a in (src, tar, w)))
    # Up to sign and scale, after the 9x9 Jacobi eigensolve: 1e-4.
    np.testing.assert_allclose(fro(to_np(ht)), fro(hj), atol=1e-4)
    # And near the truth (0.5 px noise on 40 points, ~80% weighted).
    np.testing.assert_allclose(fro(to_np(ht)), fro(np.broadcast_to(h_true, ht.shape)),
                               atol=2e-2)


def test_ndlt_batched_weights_on_one_point_set():
    """One point set under K weight sets (the IRLS refit shape) == a loop."""
    src, tar, w, _ = _ndlt_inputs(9, np.float32, batch=(), n=60)
    ws = np.stack([w, np.roll(w, 7), np.ones_like(w)])
    ht = tndlt.ndlt_h(torch.from_numpy(src), torch.from_numpy(tar),
                      torch.from_numpy(ws))
    hj = jax.jit(jax.vmap(lambda ww: jndlt.ndlt_h(src, tar, ww)))(ws)
    np.testing.assert_allclose(fro(to_np(ht)), fro(hj), atol=1e-4)


def test_ndlt_normalized_matches_jax():
    src, tar, _, _ = _ndlt_inputs(10, np.float64, batch=(2,), n=8)
    hj = jax.jit(jndlt.ndlt)(src, tar)
    ht = tndlt.ndlt(torch.from_numpy(src), torch.from_numpy(tar))
    np.testing.assert_allclose(to_np(ht), np.asarray(hj), rtol=1e-6, atol=1e-6)
    # The N-point form takes the matrix eigensolvers, as the JAX package's
    # does; inverse iteration is ndlt_core's (the kernel's) alone.
    he = tndlt.ndlt(torch.from_numpy(src), torch.from_numpy(tar),
                    eig_method="eigh")
    np.testing.assert_allclose(to_np(he), np.asarray(hj), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown method"):
        tndlt.ndlt_h(torch.from_numpy(src), torch.from_numpy(tar),
                     eig_method="invit")


def test_ndlt_core_jacobi_matches_jax():
    """ndlt_core(eig='jacobi', 6 sweeps) against the JAX core, jitted (~30 s
    on the CPU; the inverse-iteration form is in test_torch_solvers.py).
    The 9x9 eigensolve amplifies XLA's FMA contraction: measured 1.7e-4 on
    the worst of 256 quads and 1.3e-6 on the median, after
    normalize_h('fro')."""
    src, tar = quads(14, 256)
    tcomps = [torch.from_numpy(src).reshape(-1, 8)[:, i] for i in range(8)]
    tcomps += [torch.from_numpy(tar).reshape(-1, 8)[:, i] for i in range(8)]
    hj = jax.jit(lambda s, t: jnp.stack(jndlt.ndlt_core(
        *[s.reshape(-1, 8)[:, i] for i in range(8)],
        *[t.reshape(-1, 8)[:, i] for i in range(8)]), -1))(src, tar)
    ht = torch.stack(tndlt.ndlt_core(*tcomps), -1)
    d = np.abs(fro(to_np(ht).reshape(-1, 3, 3))
               - fro(np.asarray(hj).reshape(-1, 3, 3))).max(axis=(1, 2))
    assert d.max() <= 1e-3 and np.median(d) <= 5e-6, (d.max(), np.median(d))


@pytest.mark.parametrize("name", ["affine_3pt_h", "affine_3pt",
                                  "affine_valid_mask"])
def test_affine_matches_jax(name):
    src, tar = quads(11, 64, np.float64)
    src[:4, 2] = src[:4, 0] + 0.25 * (src[:4, 1] - src[:4, 0])
    args = (src,) if name == "affine_valid_mask" else (src, tar)
    out_j = np.asarray(jax.jit(getattr(jops, name))(*args))
    out_t = to_np(getattr(tops, name)(*(torch.from_numpy(a) for a in args)))
    if name == "affine_valid_mask":
        np.testing.assert_array_equal(out_t, out_j)
        assert not out_t[:4].any() and out_t[4:].all()
    else:
        # Rows 4+ only: the collinear rows have det A1 ~ 0 and blow up.
        np.testing.assert_allclose(out_t[4:], out_j[4:], rtol=1e-10, atol=1e-8)


def test_cv2_shaped_exact_transforms_match_jax():
    import sks_tpu.robust.api as japi

    src, tar = quads(12, 16, np.float64)
    hj = np.asarray(jax.jit(japi.get_perspective_transform)(src, tar))
    ht = to_np(sks_tpu_torch.get_perspective_transform(src, tar))
    np.testing.assert_allclose(ht, hj, rtol=1e-10)
    aj = np.asarray(jax.jit(japi.get_affine_transform)(src[:, :3], tar[:, :3]))
    at = to_np(sks_tpu_torch.get_affine_transform(src[:, :3], tar[:, :3]))
    assert at.shape == (16, 2, 3)
    np.testing.assert_allclose(at, aj, rtol=1e-10, atol=1e-8)


def test_solver_registry_holds_what_is_ported():
    """Every solver of the JAX package's registries, under the same names."""
    assert set(tops.SOLVERS) == set(jops.SOLVERS) == set(tops.SOLVERS_H)
    assert set(tops.SOLVERS_H) == set(jops.SOLVERS_H)
    src, tar = quads(13, 8, np.float64)
    # float64 on both sides: measured gaps 2e-15 to 3e-15 for the
    # straight-line cores, 1e-14 for NDLT's Jacobi; every solver is held at
    # the ACA check's 1e-12.
    for name in tops.SOLVERS_H:
        ht = tops.solve_h(name, torch.from_numpy(src), torch.from_numpy(tar))
        np.testing.assert_allclose(
            fro(to_np(ht)), fro(jit_of(jops.SOLVERS_H[name])(src, tar)),
            atol=1e-12)
    with pytest.raises(KeyError, match="unknown solver"):
        tops.SOLVERS_H["nope"]


def test_precision_pinned_at_import():
    if os.environ.get("SKS_TPU_NO_GLOBAL_PRECISION"):
        pytest.skip("the precision pin is opted out in this environment")
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_package_imports_without_jax():
    code = ("import sys, sks_tpu_torch, sks_tpu_torch.kernels._build, "
            "sks_tpu_torch.kernels.baselines_cuda, "
            "sks_tpu_torch.kernels.sks_cuda, sks_tpu_torch.bench.table8, "
            "sks_tpu_torch.utils.synth, sks_tpu_torch.utils.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'sks_tpu.')) or m == 'sks_tpu']; "
            "assert not bad, bad")
    env = dict(os.environ, SKS_TPU_NO_GLOBAL_PRECISION="")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_synth_correspondences_are_exact():
    from sks_tpu_torch.utils.synth import (
        random_correspondences,
        random_quad_pairs,
    )

    g = torch.Generator().manual_seed(0)
    src, tar, h = random_correspondences(g, (3,), 50, 0.0, torch.float64)
    assert src.shape == tar.shape == (3, 50, 2) and h.shape == (3, 3, 3)
    assert float(src[..., 0].min()) >= 0 and float(src[..., 0].max()) < 640
    np.testing.assert_allclose(to_np(tgeom.apply_homography(h, src)),
                               to_np(tar), atol=1e-9)
    qs, qt = random_quad_pairs(g, 64)
    h4 = tops.aca(qs, qt)
    np.testing.assert_allclose(to_np(tgeom.apply_homography(h4, qs)),
                               to_np(qt), atol=0.05)
