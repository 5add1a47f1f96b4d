"""The port's solver heads (``sks_tpu_torch.models.heads``) against
``sks_tpu.models.heads``, and the autograd repair of ``ops.linalg`` under the
DLT and NDLT heads.

Inputs are seeded numpy, as in the JAX package's own head tests: 8 source
rectangles (origin in [0, 64)^2, size in [32, 128)^2) with corner offsets in
[-16, 16).  Tolerances:

* float32 H and its gradient against XLA on the CPU: 5e-5 of the largest
  entry (XLA contracts multiply-adds and the port does not; the gaps measured
  are 1e-7 to 3e-6);
* the NDLT head's gradient (8 Jacobi sweeps): in float64 against a central
  finite difference of the port itself, step 1e-6 px, within 1e-6 of the
  largest entry; in float32 against float64 on 512 rectangles, per
  rectangle over its largest entry: median 2e-6, 99th percentile 2e-4,
  largest 5e-3 (measured 6.2e-7 / 6.1e-6 / 9.4e-5, and 7.2e-7 / 4.3e-5 /
  1.8e-3 on rectangles whose corners normalize to exactly +-1; before
  ``jacobi_eigh`` held its rounding-level angles constant under autograd,
  the largest were 847 and 3,009); against ``jax.grad`` only in a ``slow``
  test (the JAX package marks its own NDLT gradient test slow, for its
  compile time): float64 within 1e-9, float32 within 5e-5;
* ``solve_unrolled`` and ``jacobi_eigh`` with and without a gradient:
  bit-equal, and the same aten ops without one as before the repair
  (counted by ``bench.esm_bench.dispatched_ops``; the counts are hard-coded
  from the code before the repair);
* ``torch.autograd.gradcheck`` in float64 at its default tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import jit_of
from sks_tpu.models import HEAD_METHODS as J_HEADS
from sks_tpu.models import offsets_to_h as j_offsets_to_h
from sks_tpu_torch.bench.esm_bench import dispatched_ops
from sks_tpu_torch.bench.ndlt_grad import gradient_tail
from sks_tpu_torch.geom.homography import apply_homography
from sks_tpu_torch.models import HEAD_METHODS, offsets_to_h
from sks_tpu_torch.ops.aca_rect import rect_corners
from sks_tpu_torch.ops.gpt import build_gpt_system, gpt_lu
from sks_tpu_torch.ops.linalg import jacobi_eigh, solve_unrolled
from torch_parity import fro, to_np

B = 8
RTOL = 5e-5


def _inputs(seed=3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    origin = rng.uniform(0.0, 64.0, (B, 2)).astype(dtype)
    size = rng.uniform(32.0, 128.0, (B, 2)).astype(dtype)
    offsets = rng.uniform(-16.0, 16.0, (B, 4, 2)).astype(dtype)
    weights = rng.normal(size=(B, 3, 3)).astype(dtype)
    return offsets, origin, size, weights


def _port_grad(method, offsets, origin, size, weights):
    """(H, d sum(W * H) / d offsets) of the port."""
    o = torch.tensor(offsets, requires_grad=True)
    h = offsets_to_h(o, torch.tensor(origin), torch.tensor(size), method)
    torch.sum(h * torch.tensor(weights)).backward()
    return h.detach(), o.grad


def _jax_grad(method, offsets, origin, size, weights):
    def loss(o):
        return jnp.sum(j_offsets_to_h(o, origin, size, method) * weights)

    return np.asarray(jax.jit(jax.grad(loss))(offsets))


def _close(got, want, rtol=RTOL):
    got, want = to_np(got), np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def test_heads_are_the_reference_heads():
    assert HEAD_METHODS == J_HEADS


@pytest.mark.parametrize("method", sorted(HEAD_METHODS))
def test_head_matches_jax(method):
    offsets, origin, size, _ = _inputs()
    want = jit_of(lambda o, og, sz, m=method: j_offsets_to_h(o, og, sz, m))(
        offsets, origin, size)
    got = offsets_to_h(torch.tensor(offsets), torch.tensor(origin),
                       torch.tensor(size), method)
    _close(got, want)


@pytest.mark.parametrize("method", ["aca_rect", "dlt", "ge"])
def test_head_gradient_matches_jax(method):
    """d sum(W * H) / d offsets, W a fixed random weighting of the entries."""
    args = _inputs()
    h, g = _port_grad(method, *args)
    assert torch.isfinite(g).all()
    _close(g, _jax_grad(method, *args))


def test_ndlt_head_gradient_matches_finite_difference():
    """The NDLT head differentiates through 8 Jacobi sweeps of a 9 x 9
    normal matrix; float64 central differences of the port stand in for the
    JAX compile here."""
    offsets, origin, size, weights = _inputs(dtype=np.float64)
    _, g = _port_grad("ndlt", offsets, origin, size, weights)
    eps = 1e-6
    fd = np.zeros_like(offsets)
    og, sz, w = (torch.tensor(x) for x in (origin, size, weights))
    for idx in np.ndindex(offsets.shape):
        hi, lo = offsets.copy(), offsets.copy()
        hi[idx] += eps
        lo[idx] -= eps
        f = [torch.sum(offsets_to_h(torch.tensor(x), og, sz, "ndlt") * w)
             for x in (hi, lo)]
        fd[idx] = (f[0] - f[1]).item() / (2 * eps)
    assert np.isfinite(fd).all()
    _close(g, fd, rtol=1e-6)


@pytest.mark.parametrize("exact", [False, True])
def test_ndlt_head_float32_gradient_tail(exact):
    """The float32 NDLT gradient against the float64 one (held against a
    finite difference above and against JAX below), over 512 rectangles:
    the whole distribution, since a tie's rotation angle amplifies rounding
    on a few rectangles only (``bench/ndlt_grad.py``)."""
    tail = gradient_tail(512, seed=11, exact=exact)
    assert tail["median"] <= 2e-6, tail
    assert tail["p99"] <= 2e-4, tail
    assert tail["max"] <= 5e-3, tail


@pytest.mark.slow
@pytest.mark.parametrize("dtype, rtol", [(np.float64, 1e-9),
                                         (np.float32, RTOL)])
def test_ndlt_head_gradient_matches_jax(dtype, rtol):
    """Measured 7.3e-15 (float64) and 3.5e-6 (float32) of the largest entry
    apart.  The two packages' float32 Jacobi paths need not agree rotation
    by rotation (XLA contracts multiply-adds, and a tie's angle follows
    the rounding); both reach the same eigenvector."""
    args = _inputs(dtype=dtype)
    _, g = _port_grad("ndlt", *args)
    _close(g, _jax_grad("ndlt", *args), rtol=rtol)


@pytest.mark.parametrize("method", sorted(HEAD_METHODS))
def test_head_maps_corners_and_backpropagates(method):
    offsets, origin, size, weights = _inputs()
    h, g = _port_grad(method, offsets, origin, size, weights)
    corners = rect_corners(torch.tensor(origin), torch.tensor(size))
    got = apply_homography(h, corners)
    np.testing.assert_allclose(to_np(got), to_np(corners) + offsets,
                               atol=5e-3)
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_unnormalized_aca_rect_proportional():
    offsets, origin, size, _ = _inputs()
    args = (torch.tensor(offsets), torch.tensor(origin), torch.tensor(size))
    hn = offsets_to_h(*args)
    hu = offsets_to_h(*args, normalize=False)
    np.testing.assert_allclose(fro(to_np(hu)), fro(to_np(hn)), atol=1e-5)


def test_unknown_head_raises():
    offsets, origin, size, _ = _inputs()
    with pytest.raises(ValueError, match="unknown head"):
        offsets_to_h(torch.tensor(offsets), torch.tensor(origin),
                     torch.tensor(size), "svd")


# ---- ops.linalg under autograd ---------------------------------------------

def _spd(seed=0, batch=64, n=9):
    m = np.random.default_rng(seed).normal(size=(batch, n, n))
    return torch.tensor((m @ m.transpose(0, 2, 1)).astype(np.float32))


def _quads(seed=0, batch=64):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0.0, 100.0, (batch, 4, 2)).astype(np.float32)
    tar = src + rng.normal(0.0, 5.0, (batch, 4, 2)).astype(np.float32)
    return torch.tensor(src), torch.tensor(tar)


def test_jacobi_eigh_values_equal_with_and_without_gradient():
    a = _spd()
    w0, v0 = jacobi_eigh(a)
    ag = a.clone().requires_grad_()
    w1, v1 = jacobi_eigh(ag)
    assert torch.equal(w0, w1.detach()) and torch.equal(v0, v1.detach())
    (w1.sum() + v1.abs().sum()).backward()
    assert torch.isfinite(ag.grad).all()


@pytest.mark.parametrize("pivot", [False, True])
def test_solve_unrolled_values_equal_with_and_without_gradient(pivot):
    """On the GPT systems of 64 quads (pivoting) and on 64 diagonally
    dominant 8 x 8 systems (none)."""
    if pivot:
        a, b = build_gpt_system(*_quads())
    else:
        rng = np.random.default_rng(4)
        a = torch.tensor((rng.normal(size=(64, 8, 8)) + 8 * np.eye(8))
                         .astype(np.float32))
        b = torch.tensor(rng.normal(size=(64, 8)).astype(np.float32))
    x0 = solve_unrolled(a, b, pivot=pivot)
    ag, bg = a.clone().requires_grad_(), b.clone().requires_grad_()
    x1 = solve_unrolled(ag, bg, pivot=pivot)
    assert torch.equal(x0, x1.detach())
    x1.sum().backward()
    assert torch.isfinite(ag.grad).all() and torch.isfinite(bg.grad).all()


# Non-view aten ops of each call without a gradient, counted on the code
# before the autograd repair: the IRLS refit, ``geom/pose.py`` and the VO
# tail call these eagerly, so the repair may not add a launch.
_OPS_JACOBI_64x9x9 = {
    "add": 2016, "clone": 2, "copy_": 1728, "div": 288, "eye": 1,
    "gather": 1, "ge": 288, "mul": 5760, "reciprocal": 288,
    "scalar_tensor": 576, "sort": 1, "sqrt": 576, "sub": 1152, "where": 288,
}
_OPS_GPT_LU_64x4x2 = {
    "_local_scalar_dense": 16, "_to_copy": 8, "abs": 8, "add": 16,
    "aminmax": 8, "arange": 8, "argmax": 8, "bmm": 8, "cat": 4, "copy_": 16,
    "mul": 36, "ne": 8, "neg": 4, "ones_like": 2, "reciprocal": 8,
    "scatter_": 8, "stack": 2, "sub": 16, "where": 8, "zeros": 8,
    "zeros_like": 1,
}


@pytest.mark.parametrize("case", ["jacobi_eigh", "gpt_lu"])
def test_no_gradient_path_dispatches_the_same_ops(case):
    if case == "jacobi_eigh":
        a = _spd()
        _, ops = dispatched_ops(lambda: jacobi_eigh(a))
        want = _OPS_JACOBI_64x9x9
    else:
        src, tar = _quads()
        _, ops = dispatched_ops(lambda: gpt_lu(src, tar))
        want = _OPS_GPT_LU_64x4x2
    assert dict(ops) == want


@pytest.mark.parametrize("pivot", [False, True])
def test_solve_unrolled_gradcheck(pivot):
    rng = np.random.default_rng(5)
    a = torch.tensor(rng.normal(size=(3, 4, 4)), requires_grad=True)
    b = torch.tensor(rng.normal(size=(3, 4, 2)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x, y: solve_unrolled(x, y, pivot=pivot), (a, b))


def test_jacobi_eigh_gradcheck():
    """Eigenvalues and sign-fixed eigenvectors of a symmetric 4 x 4 with
    distinct eigenvalues (10 sweeps: converged, so the derivative is the
    eigensystem's)."""
    s = torch.tensor(np.random.default_rng(6).normal(size=(2, 4, 4)),
                     requires_grad=True)

    def eig(x):
        w, v = jacobi_eigh(x + x.transpose(-1, -2), sweeps=10)
        return w, v * v[..., :1, :].sign()

    assert torch.autograd.gradcheck(eig, (s,))
