"""Port parity, ops/factors: sks_tpu_torch against sks_tpu on one input.

Inputs are seeded numpy; the JAX side runs jitted on the CPU backend.  Each
factor and ``reconstruct()`` are compared after the unit-Frobenius
normalization: float64 to 1e-12, float32 to 5e-5 (XLA contracts
multiply-adds, the port rounds every operation on its own).
"""

import numpy as np
import pytest
import torch

from conftest import jit_of
from torch_parity import apply_h, fro, quads, to_np

import sks_tpu.ops as jops

import sks_tpu_torch.ops as tops

T = torch.from_numpy
ATOL = {np.float32: 5e-5, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]
B = 64

_SKS_FIELDS = ("h_s1", "h_k", "h_s2_inv")
_ACA_FIELDS = ("h_a1", "h_c", "h_a2_inv")


def _both(fn):
    def both(s, t):
        f = fn(s, t)
        return tuple(f), f.reconstruct()

    return both


# One function object per factorization, so jit_of caches its compilation.
_BOTH = {n: _both(getattr(jops, n)) for n in ("sks_factors", "aca_factors")}


def _jax_factors(name, src, tar):
    """The JAX factors and their ``reconstruct()``, from one jit."""
    return jit_of(_BOTH[name])(src, tar)


@pytest.mark.parametrize("dt", DTYPES)
def test_sks_factors_match_jax(dt):
    src, tar = quads(0, B, dt)
    fj, rj = _jax_factors("sks_factors", src, tar)
    ft = tops.sks_factors(T(src), T(tar))
    assert isinstance(ft, tops.SKSFactors) and ft._fields == (
        *_SKS_FIELDS, "params")
    for name, want in zip(_SKS_FIELDS, fj):
        got = getattr(ft, name)
        assert got.shape == (B, 3, 3) and got.dtype == T(src).dtype
        np.testing.assert_allclose(fro(to_np(got)), fro(want), rtol=0,
                                   atol=ATOL[dt], err_msg=name)
    assert ft.params.shape == (B, 4)
    # The kernel parameters are O(1)-O(10) numbers behind two divisions.
    np.testing.assert_allclose(to_np(ft.params), np.asarray(fj[3]),
                               rtol=5e-5 if dt == np.float32 else 1e-10,
                               atol=5e-5 if dt == np.float32 else 1e-12)
    np.testing.assert_allclose(fro(to_np(ft.reconstruct())), fro(rj), rtol=0,
                               atol=ATOL[dt])


@pytest.mark.parametrize("dt", DTYPES)
def test_aca_factors_match_jax(dt):
    src, tar = quads(1, B, dt)
    fj, rj = _jax_factors("aca_factors", src, tar)
    ft = tops.aca_factors(T(src), T(tar))
    assert isinstance(ft, tops.ACAFactors) and ft._fields == (
        *_ACA_FIELDS, "params")
    for name, want in zip(_ACA_FIELDS, fj):
        got = getattr(ft, name)
        assert got.shape == (B, 3, 3) and got.dtype == T(src).dtype
        np.testing.assert_allclose(fro(to_np(got)), fro(want), rtol=0,
                                   atol=ATOL[dt], err_msg=name)
    assert ft.params.shape == (B, 3)
    scale = np.abs(np.asarray(fj[3])).max(-1, keepdims=True)
    np.testing.assert_allclose(to_np(ft.params) / scale,
                               np.asarray(fj[3]) / scale, rtol=0,
                               atol=ATOL[dt])
    np.testing.assert_allclose(fro(to_np(ft.reconstruct())), fro(rj), rtol=0,
                               atol=ATOL[dt])


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("which", ["sks", "aca"])
def test_reconstruct_equals_the_solver(which, dt):
    """The factored product is the one-shot solver's H (float32 to 2e-3, the
    template's tolerance: the factored form divides where the fused core
    does not; float64 to 1e-9)."""
    src, tar = quads(2, B, dt)
    f = getattr(tops, which + "_factors")(T(src), T(tar))
    h = getattr(tops, which)(T(src), T(tar))
    rec = f.reconstruct()
    np.testing.assert_allclose(to_np(rec)[:, 2, 2], 1.0)
    np.testing.assert_allclose(fro(to_np(rec)), fro(to_np(h)),
                               atol=2e-3 if dt == np.float32 else 1e-9)


def test_sks_factor_structure():
    """H_S1 sends the anchors to (-1, 0), (1, 0); H_K fixes them; H_S2^-1
    returns them onto the target anchors."""
    src, tar = quads(3, B, np.float64)
    f = tops.sks_factors(T(src), T(tar))
    canon = np.array([[-1.0, 0.0], [1.0, 0.0]])
    for i in range(B):
        np.testing.assert_allclose(apply_h(to_np(f.h_s1[i]), src[i, :2]),
                                   canon, atol=1e-12)
        np.testing.assert_allclose(apply_h(to_np(f.h_k[i]), canon), canon,
                                   atol=1e-12)
        np.testing.assert_allclose(apply_h(to_np(f.h_s2_inv[i]), canon),
                                   tar[i, :2], atol=1e-9)


def test_aca_factor_structure():
    """H_A1 maps M, N, P to the canonical simplex; H_C fixes it; H_A2^-1
    returns it onto the target's M, N, P."""
    src, tar = quads(4, B, np.float64)
    f = tops.aca_factors(T(src), T(tar))
    simplex = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    for i in range(B):
        np.testing.assert_allclose(apply_h(to_np(f.h_a1[i]), src[i, :3]),
                                   simplex, atol=1e-12)
        np.testing.assert_allclose(apply_h(to_np(f.h_c[i]), simplex), simplex,
                                   atol=1e-12)
        np.testing.assert_allclose(apply_h(to_np(f.h_a2_inv[i]), simplex),
                                   tar[i, :3], atol=1e-9)


@pytest.mark.parametrize("dt", DTYPES)
def test_kernel_chain_matches_jax_and_multiplies_to_h_k(dt):
    src, tar = quads(5, B, dt)
    f = tops.sks_factors(T(src), T(tar))
    chain_t = tops.sks_kernel_chain(f.params)
    chain_j = jit_of(jops.sks_kernel_chain)(to_np(f.params))
    assert len(chain_t) == 4 and chain_t[0] is chain_t[3]
    for got, want in zip(chain_t, chain_j):
        # Entries are the parameters, 0 and 1, placed: exact.
        np.testing.assert_array_equal(to_np(got), np.asarray(want))
    h_e, h_t, h_g, h_e2 = chain_t
    prod = h_e @ h_t @ h_g @ h_e2
    tol = (1e-5 if dt == np.float32 else 1e-13) * float(f.h_k.abs().max())
    np.testing.assert_allclose(to_np(prod), to_np(f.h_k), atol=tol)


def test_kernel_params_sit_in_the_kernel_slots():
    src, tar = quads(6, 4, np.float64)
    f = tops.sks_factors(T(src), T(tar))
    a, b, u, v = (to_np(f.params[..., i]) for i in range(4))
    hk = to_np(f.h_k)
    np.testing.assert_array_equal(hk[:, 0], np.stack([a, b, u], -1))
    np.testing.assert_array_equal(hk[:, 1], np.tile([0.0, 1.0, 0.0], (4, 1)))
    np.testing.assert_array_equal(hk[:, 2], np.stack([u, v, a], -1))


def test_factors_of_one_unbatched_quad_pair():
    src, tar = quads(7, 1, np.float32)
    f = tops.aca_factors(T(src[0]), T(tar[0]))
    assert f.h_c.shape == (3, 3) and f.params.shape == (3,)
    g = tops.sks_factors(T(src[0]), T(tar[0]))
    assert g.h_k.shape == (3, 3) and g.params.shape == (4,)
    assert g.reconstruct().shape == (3, 3)
