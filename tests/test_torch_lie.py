"""Port parity, Lie groups: every function of ``geom/lie.py`` against JAX.

Inputs are seeded numpy float32; the JAX side is jitted on the CPU backend.
Tolerance: 1e-5 relative to the output's largest entry (float32; XLA
contracts multiply-adds, the port does not).  The logarithms of rotations
within 0.05 rad of pi are held to 1e-4: there the arccos of a cosine within
1e-3 of -1 turns a one-ulp difference of the trace into ~1e-5 of the angle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_np

import sks_tpu.geom.lie as jl
import sks_tpu_torch.geom.lie as tl

T = torch.from_numpy
RNG = np.random.default_rng(7)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=rtol * scale)


def _vecs(n, dim, scale):
    return (RNG.normal(size=(n, dim)) * scale).astype(np.float32)


def _rotations(n):
    """Rotations from axis-angles of every size: zero, tiny, generic and
    near pi."""
    w = _vecs(n, 3, 1.0)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    ang = np.concatenate([[0.0, 1e-5, 1e-3], RNG.uniform(0.01, 3.0, n - 6),
                          [np.pi - 1e-3, np.pi - 1e-2, 3.1]])
    return (w * ang[:, None].astype(np.float32)).astype(np.float32)


W = _rotations(32)
XI = np.concatenate([_vecs(32, 3, 0.5), W], axis=-1)
SL3 = _vecs(16, 8, 0.3)


@pytest.mark.parametrize("name,args", [
    ("hat3", (W,)),
    ("so3_exp", (W,)),
    ("se3_exp", (XI,)),
    ("sl3_exp", (SL3,)),
    ("mm_small", (_vecs(12, 9, 1.0).reshape(12, 3, 3),
                  _vecs(12, 9, 1.0).reshape(12, 3, 3))),
    ("expm3", (_vecs(12, 9, 0.3).reshape(12, 3, 3),)),
])
def test_maps_match_jax(name, args):
    want = jax.jit(getattr(jl, name))(*args)
    got = getattr(tl, name)(*(T(a) for a in args))
    _close(got, want)


def test_logs_match_jax():
    near_pi = np.linalg.norm(W, axis=-1) > np.pi - 0.05
    r = np.array(jax.jit(jl.so3_exp)(W))
    g = np.array(jax.jit(jl.se3_exp)(XI))
    for log, x in ((jl.so3_log, r), (jl.se3_log, g)):
        want = np.asarray(jax.jit(log)(x))
        got = getattr(tl, log.__name__)(T(x))
        _close(got[~near_pi], want[~near_pi])
        _close(got[near_pi], want[near_pi], rtol=1e-4)
    a = np.array(jax.jit(jl.sl3_exp)(SL3 * 0.02))
    _close(tl.logm3_near_identity(T(a)),
           jax.jit(jl.logm3_near_identity)(a))


def test_sl3_basis_matches_jax():
    np.testing.assert_array_equal(to_np(tl.sl3_basis()),
                                  np.asarray(jl.sl3_basis(jnp.float32)))


def test_se3_log_inverts_se3_exp():
    """Round trip away from theta = pi (where the axis sign is free)."""
    xi = XI[np.linalg.norm(XI[:, 3:], axis=-1) < 3.0]
    back = to_np(tl.se3_log(tl.se3_exp(T(xi))))
    np.testing.assert_allclose(back, xi, rtol=0, atol=2e-4)
    small = T(xi[:4] * 1e-4)
    np.testing.assert_allclose(to_np(tl.se3_log(tl.se3_exp(small))),
                               to_np(small), rtol=0, atol=1e-7)


def test_exp_and_log_have_finite_derivatives_at_zero():
    """The double-where pattern: derivatives at w = 0 stay finite."""
    zero = torch.zeros(2, 6)
    jac = torch.func.jacrev(lambda x: tl.se3_exp(x).sum(0))(zero)
    assert torch.isfinite(jac).all()
    eye = torch.eye(4).repeat(2, 1, 1)
    jac = torch.func.jacfwd(lambda g: tl.se3_log(g).sum(0))(eye)
    assert torch.isfinite(jac).all()
