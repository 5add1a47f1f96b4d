"""Port parity, ops/aca_rect: sks_tpu_torch against sks_tpu on one input.

Inputs are seeded numpy; the JAX side runs jitted on the CPU backend.
Tolerances after the unit-Frobenius normalization: float64 1e-12; float32
5e-5, the gap that XLA's contraction of multiply-adds opens on ACA's float32
conditioning at pixel scale (the port rounds every operation on its own).
"""

import numpy as np
import pytest
import torch

from conftest import jit_of
from torch_parity import apply_h, fro, quads, to_np

import sks_tpu.ops as jops

import sks_tpu_torch
import sks_tpu_torch.ops as tops

T = torch.from_numpy
ATOL = {np.float32: 5e-5, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]


def _rects(seed, batch, dt):
    """Target quads (in rect_corners order), rect origins, sizes and square
    sides, each seeded numpy of dtype ``dt``."""
    rng = np.random.default_rng(seed)
    _, tar = quads(seed, batch, dt)
    origin = rng.uniform(-20.0, 60.0, (batch, 2)).astype(dt)
    size = rng.uniform(64.0, 256.0, (batch, 2)).astype(dt)
    side = rng.uniform(64.0, 256.0, (batch,)).astype(dt)
    return tar, origin, size, side


@pytest.mark.parametrize("dt", DTYPES)
def test_rect_corners_matches_jax(dt):
    _, origin, size, _ = _rects(0, 32, dt)
    cj = np.asarray(jit_of(jops.rect_corners)(origin, size))
    ct = tops.rect_corners(T(origin), T(size))
    assert ct.shape == (32, 4, 2) and ct.dtype == T(origin).dtype
    np.testing.assert_array_equal(to_np(ct), cj)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", ["aca_rect_h", "aca_rect"])
def test_aca_rect_matches_jax(name, dt):
    tar, origin, size, _ = _rects(1, 128, dt)
    hj = jit_of(getattr(jops, name))(tar, origin, size)
    ht = getattr(tops, name)(T(tar), T(origin), T(size))
    assert ht.shape == (128, 3, 3) and ht.dtype == T(tar).dtype
    np.testing.assert_allclose(fro(to_np(ht)), fro(hj), rtol=0, atol=ATOL[dt])
    if name == "aca_rect":
        np.testing.assert_allclose(to_np(ht)[:, 2, 2], 1.0)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", ["aca_square_h", "aca_square"])
def test_aca_square_matches_jax(name, dt):
    tar, origin, _, side = _rects(2, 128, dt)
    hj = jit_of(getattr(jops, name))(tar, origin, side)
    ht = getattr(tops, name)(T(tar), T(origin), T(side))
    np.testing.assert_allclose(fro(to_np(ht)), fro(hj), rtol=0, atol=ATOL[dt])
    if name == "aca_square":
        np.testing.assert_allclose(to_np(ht)[:, 2, 2], 1.0)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("name", ["aca_qr_h", "aca_qr"])
def test_aca_qr_matches_jax(name, dt):
    tar, _, _, _ = _rects(3, 128, dt)
    hj = jit_of(getattr(jops, name))(tar)
    ht = getattr(tops, name)(T(tar))
    np.testing.assert_allclose(fro(to_np(ht)), fro(hj), rtol=0, atol=ATOL[dt])
    if name == "aca_qr":
        np.testing.assert_allclose(to_np(ht)[:, 2, 2], 1.0)


@pytest.mark.parametrize("dt", DTYPES)
def test_rect_family_equals_the_general_aca(dt):
    """Each specialization is ACA on its own source quad: the same H as
    ``aca`` on ``rect_corners`` (float64 to 1e-10; float32 to 2e-3, the
    general solver's own float32 conditioning at pixel scale)."""
    tar, origin, size, side = _rects(4, 64, dt)
    tol = 2e-3 if dt == np.float32 else 1e-10
    tt = T(tar)
    cases = [
        (tops.aca_rect(tt, T(origin), T(size)), T(origin), T(size)),
        (tops.aca_square(tt, T(origin), T(side)), T(origin),
         torch.stack([T(side), T(side)], -1)),
        (tops.aca_qr(tt), torch.zeros(64, 2, dtype=tt.dtype),
         torch.ones(64, 2, dtype=tt.dtype)),
    ]
    for h, o, s in cases:
        want = tops.aca(tops.rect_corners(o, s), tt)
        np.testing.assert_allclose(fro(to_np(h)), fro(to_np(want)), atol=tol)


def test_aca_rect_maps_the_rect_onto_the_quad():
    tar, origin, size, _ = _rects(5, 64, np.float64)
    h = to_np(tops.aca_rect(T(tar), T(origin), T(size)))
    corners = to_np(tops.rect_corners(T(origin), T(size)))
    for i in range(64):
        np.testing.assert_allclose(apply_h(h[i], corners[i]), tar[i],
                                   atol=1e-8)


def test_aca_rect_broadcasts_one_rect_over_a_batch():
    """The deep-homography layout: one fixed source rect, a batch of
    predicted corner sets."""
    tar, _, _, _ = _rects(6, 16, np.float32)
    origin = torch.tensor([0.0, 0.0])
    size = torch.tensor([128.0, 128.0])
    h = tops.aca_rect_h(T(tar), origin, size)
    assert h.shape == (16, 3, 3)
    one = tops.aca_rect_h(T(tar[3]), origin, size)
    assert torch.equal(h[3], one)


def test_ops_exports_every_name_of_the_jax_ops_but_the_df_ones():
    """sks_tpu_torch.ops exports what sks_tpu.ops does; the double-float
    emulation (DF, *_df64*, df_*) has native float64 in its place."""
    df = {"DF", "aca_df64", "aca_df64_h", "df_from_f64", "df_lift",
          "df_to_f64", "df64"}
    public = {n for n in dir(jops) if not n.startswith("_")}
    missing = sorted(n for n in public - df if not hasattr(tops, n))
    assert missing == []
    for n in ("aca_rect", "aca_rect_h", "aca_factors", "sks_factors",
              "sks_kernel_chain"):
        assert getattr(sks_tpu_torch, n) is getattr(tops, n)
        assert n in sks_tpu_torch.__all__
