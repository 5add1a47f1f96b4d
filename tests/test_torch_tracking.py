"""Port parity, dense ESM tracking (``slam/tracking.py``) against JAX.

Inputs: a JAX-rendered plane texture (96 x 128), its view under a known
homography, a 64 x 80 template of the first at (24, 16), and a start a
couple of pixels off the truth; both packages get the same numpy arrays.
The JAX side runs jitted on the CPU backend.  To read its trajectory, the
JAX ``lax.while_loop`` is wrapped (through a fresh ``jax.jit`` of the
unjitted function, so that no cached trace skips the wrapper) so that each
iteration's model reaches the host through ``jax.debug.callback``; the
port's trajectory is its result at caps 0, 1, ..., since a run with cap k
is the first k iterations of any longer run.

Tolerances: models compared by the template's four corners mapped through
them, within 2e-3 px (the two sides differ only in float32 rounding: XLA
contracts multiply-adds and sums in its own order, and the port does
neither; seen: <= 3e-4 px), residuals within 1e-4 relative; the number of
accepted steps (steps that changed the model) equal.  Batched calls equal
their single calls to the same corner tolerance (a batched matrix product
on the CPU may round otherwise than a single one, and the iterations carry
the difference; seen: <= 5e-4 px).
"""

import jax
import numpy as np
import pytest
import torch

from torch_parity import to_np

import sks_tpu.slam.tracking as jt
from sks_tpu.data.images import plane_texture as jplane_texture
from sks_tpu.data.images import warp_image as jwarp_image

import sks_tpu_torch.slam.tracking as tt

T = torch.from_numpy
SHAPE, OX, OY, TH, TW = (96, 128), 24, 16, 64, 80
CORNER_TOL, CAP = 2e-3, 8
H_TRUE = np.array([[1.02, 0.01, 3.0], [-0.015, 0.99, -2.0],
                   [1e-4, -5e-5, 1.0]], np.float32)


def _shift(dx, dy):
    return np.array([[1, 0, dx], [0, 1, dy], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def scene():
    """(texture, its view under H_TRUE, template, start) as numpy."""
    base = np.array(jplane_texture(jax.random.PRNGKey(0), SHAPE))
    img2 = np.array(jax.jit(jwarp_image)(base, H_TRUE))
    tpl = base[OY:OY + TH, OX:OX + TW].copy()
    h0 = (H_TRUE @ _shift(1.5, -1.0)).astype(np.float32)
    return base, img2, tpl, h0


def _corners(h, ox=OX, oy=OY, w=TW, hgt=TH):
    c = np.array([[ox, oy], [ox + w, oy], [ox, oy + hgt], [ox + w, oy + hgt]],
                 np.float64)
    h = np.asarray(h, np.float64)
    p = c @ h[:2, :2].T + h[:2, 2]
    return p / (c @ h[2, :2] + h[2, 2])[:, None]


def _corner_gap(a, b, **kw):
    return np.abs(_corners(a, **kw) - _corners(b, **kw)).max()


def _jax_trajectory(monkeypatch, args, **static):
    """JAX ``esm_track`` with the model after each iteration recorded."""
    seen = []
    loop = jax.lax.while_loop

    def recording_loop(cond, body, init):
        def body_rec(carry):
            out = body(carry)
            jax.debug.callback(lambda h: seen.append(np.array(h)), out[0],
                               ordered=True)
            return out
        return loop(cond, body_rec, init)

    monkeypatch.setattr(jax.lax, "while_loop", recording_loop)
    fn = jax.jit(lambda *a: jt.esm_track.__wrapped__(*a, **static))
    h, rms = fn(*args)
    jax.block_until_ready(h)
    monkeypatch.setattr(jax.lax, "while_loop", loop)
    return seen, np.asarray(h), float(rms)


def _changes(models):
    return sum(not np.array_equal(a, b)
               for a, b in zip(models[:-1], models[1:]))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dof", [6, 8])
@pytest.mark.parametrize("photometric", [True, False])
def test_esm_track_matches_jax_step_by_step(scene, monkeypatch, photometric,
                                            dof, stride):
    _, img2, tpl, h0 = scene
    origin = np.array([OX, OY], np.float32)
    kw = dict(photometric=photometric, dof=dof, stride=stride)
    seen, h_j, rms_j = _jax_trajectory(monkeypatch, (tpl, img2, h0, origin),
                                       iters=CAP, **kw)
    ours = [tt.esm_track(T(tpl), T(img2), T(h0), origin=(OX, OY), iters=k,
                         **kw) for k in range(CAP + 1)]
    hs = [to_np(h) for h, _ in ours]
    # The JAX loop may stop early; the port's later iterations then freeze.
    traj_j = [h0] + seen + [h_j] * (CAP - len(seen))
    assert _changes(hs) == _changes(traj_j) >= 1
    for k in (1, 2, CAP):
        assert _corner_gap(hs[k], traj_j[k]) <= CORNER_TOL, k
    np.testing.assert_allclose(float(ours[CAP][1]), rms_j, rtol=1e-4)
    # It tracked toward the truth (the start is 1.5 px off).
    assert _corner_gap(hs[CAP], H_TRUE) < _corner_gap(h0, H_TRUE)


def test_esm_track_pyramid_matches_jax(scene):
    base, img2, _, _ = scene
    h0 = (H_TRUE @ _shift(2.5, -2.0)).astype(np.float32)
    h_j, rms_j = jt.esm_track_pyramid(base, img2, h0, levels=2, iters=6)
    h_t, rms_t = tt.esm_track_pyramid(T(base), T(img2), T(h0), levels=2,
                                      iters=6)
    kw = dict(ox=0, oy=0, w=SHAPE[1], hgt=SHAPE[0])
    assert _corner_gap(to_np(h_t), h_j, **kw) <= CORNER_TOL
    np.testing.assert_allclose(float(rms_t), float(rms_j), rtol=1e-4)
    assert _corner_gap(to_np(h_t), H_TRUE, **kw) < _corner_gap(h0, H_TRUE,
                                                                **kw)


@pytest.mark.parametrize("symmetric", [False, True])
def test_pair_polish_matches_jax(scene, symmetric):
    """The VO polish of a pair model: the central crop one way, and the
    symmetric two-level form ``fit_pair`` runs (its default caps)."""
    base, img2, _, _ = scene
    h0 = (H_TRUE @ _shift(0.8, -0.6)).astype(np.float32)
    if symmetric:
        h_j, rms_j = jt.esm_polish_pair_symmetric(base, img2, h0)
        h_t, rms_t = tt.esm_polish_pair_symmetric(T(base), T(img2), T(h0))
    else:
        h_j, rms_j = jt.esm_polish_pair(base, img2, h0, iters=6)
        h_t, rms_t = tt.esm_polish_pair(T(base), T(img2), T(h0), iters=6)
    kw = dict(ox=16, oy=16, w=SHAPE[1] - 32, hgt=SHAPE[0] - 32)
    assert _corner_gap(to_np(h_t), h_j, **kw) <= CORNER_TOL
    np.testing.assert_allclose(float(rms_t), float(rms_j), rtol=1e-4)
    assert _corner_gap(to_np(h_t), H_TRUE, **kw) < _corner_gap(h0, H_TRUE,
                                                                **kw)


def test_a_batch_equals_its_single_calls(scene):
    """One pass of the loop steps every element; an element that stops
    early (a NaN template never accepts a step and stops when its damping
    has grown past 1e6, after 12 iterations of the 16) is frozen while the
    others step on, as ``jax.vmap`` of the while_loop freezes it."""
    base, img2, tpl, h0 = scene
    starts = np.stack([h0, H_TRUE @ _shift(-2.0, 1.0),
                       H_TRUE @ _shift(0.5, 0.5), h0]).astype(np.float32)
    images = np.stack([img2, img2, img2, img2])
    tpls = np.stack([tpl, tpl, tpl, np.full_like(tpl, np.nan)])
    hb, rb = tt.esm_track(T(tpls), T(images), T(starts), origin=(OX, OY),
                          iters=16)
    for i in range(3):
        h1, r1 = tt.esm_track(T(tpls[i]), T(images[i]), T(starts[i]),
                              origin=(OX, OY), iters=16)
        assert _corner_gap(to_np(hb[i]), to_np(h1)) <= CORNER_TOL, i
        torch.testing.assert_close(rb[i], r1, rtol=1e-4, atol=0)
    h1, r1 = tt.esm_track(T(tpls[3]), T(images[3]), T(starts[3]),
                          origin=(OX, OY), iters=16)
    # The NaN template never accepts a step: its start stays, bit for bit.
    assert torch.equal(hb[3], T(starts[3])) and torch.equal(h1, hb[3])
    assert torch.isnan(rb[3]) and torch.isnan(r1)
    # The symmetric pair polish: P pairs (2P tracks) in one call.
    img1s = T(np.stack([base, img2, base]))
    img2s = T(np.stack([img2, base, img2]))
    h0s = T(np.stack([h0, np.linalg.inv(h0), H_TRUE]).astype(np.float32))
    hp, rp = tt.esm_polish_pair_symmetric(img1s, img2s, h0s, iters=4)
    kw = dict(ox=16, oy=16, w=SHAPE[1] - 32, hgt=SHAPE[0] - 32)
    for i in range(3):
        h1, r1 = tt.esm_polish_pair_symmetric(img1s[i], img2s[i], h0s[i],
                                              iters=4)
        assert _corner_gap(to_np(hp[i]), to_np(h1), **kw) <= CORNER_TOL, i
        torch.testing.assert_close(rp[i], r1, rtol=1e-4, atol=0)


def test_esm_loop_reads_nothing_back(scene, monkeypatch):
    """No host read inside the loop: every way a tensor reaches the host
    raises while the port tracks and polishes."""
    base, img2, tpl, h0 = scene

    def refuse(*_args, **_kwargs):
        raise AssertionError("a host read inside the ESM path")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    tt.esm_track(T(tpl), T(img2), T(h0), origin=(OX, OY), iters=3)
    tt.esm_polish_pair_symmetric(T(base), T(img2), T(h0), iters=2)
    tt.esm_guard(T(h0), T(h0), T(np.zeros((5, 2), np.float32)),
                 T(np.ones((5, 2), np.float32)),
                 torch.ones(5, dtype=torch.bool))


def test_a_singular_step_is_rejected_by_both():
    """A template that varies only along x + y makes the two translation
    columns of the Jacobian equal; with no damping the 2-DOF normal matrix
    is singular (its 1e-10 regularizer is below float32 resolution), both
    solves give non-finite steps, and both packages reject every one."""
    yy, xx = np.mgrid[0:12, 0:12].astype(np.float32)
    tpl = 0.01 * (xx + yy)
    img = tpl + 0.005
    eye = np.eye(3, dtype=np.float32)
    kw = dict(iters=3, damping=0.0, photometric=False, dof=2)
    h_j, rms_j = jt.esm_track(tpl, img, eye, **kw)
    h_t, rms_t = tt.esm_track(T(tpl), T(img), T(eye), **kw)
    np.testing.assert_array_equal(np.asarray(h_j), eye)
    np.testing.assert_array_equal(to_np(h_t), eye)
    np.testing.assert_allclose(float(rms_t), float(rms_j), rtol=1e-6)


def _guard_case(rng, n, inliers):
    p1 = rng.uniform(0.0, 100.0, (n, 2)).astype(np.float32)
    off = rng.normal(0.0, 1.0, (n, 2)).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[:inliers]] = True
    return p1, p1 + off, mask


@pytest.mark.parametrize("inliers", [7, 8])
def test_esm_guard_matches_jax(inliers):
    """Odd and even inlier counts, a model that moves the matches, one that
    keeps them, and a singular model (its transfer errors are not finite,
    so the median comparison fails on both sides)."""
    rng = np.random.default_rng(inliers)
    p1, p2, mask = _guard_case(rng, 12, inliers)
    eye = np.eye(3, dtype=np.float32)
    models = [_shift(0.3, -0.2), _shift(0.02, 0.01), eye,
              np.zeros((3, 3), np.float32),
              np.array([[1, 0, 0], [0, 1, 0], [0, 0, 0]], np.float32)]
    guard = jax.jit(jt.esm_guard)
    want = [bool(guard(eye, h, p1, p2, mask)) for h in models]
    got = tt.esm_guard(T(eye), T(np.stack(models)), T(p1), T(p2), T(mask))
    assert got.tolist() == want
    assert want[2] and not want[3] and not want[4]
    for h, w in zip(models, want):  # unbatched alike
        assert bool(tt.esm_guard(T(eye), T(h), T(p1), T(p2), T(mask))) == w


def test_esm_guard_averages_the_middle_values():
    """The median trap: with an even inlier count the guard's median is the
    mean of the two middle residuals (``jnp.nanmedian``), not the lower
    one (``torch.nanmedian``).  Four inliers whose residuals make the two
    rules decide the other way round: against the identity (the base model)
    r2 = 2 |p2 - p1|^2 = 2, 2, 8, 8 (mean of the middle 5, lower 2); against
    a shift by s = (1.5, 0) r2 = 2 |p2 - p1 - s|^2 = 4 for all four."""
    x1, y1 = 5.0 / 12.0, np.sqrt(1.0 - (5.0 / 12.0) ** 2)  # |.| = 1
    x2, y2 = 17.0 / 12.0, np.sqrt(4.0 - (17.0 / 12.0) ** 2)  # |.| = 2
    p2 = np.array([[x1, y1], [x1, -y1], [x2, y2], [x2, -y2], [50, 0],
                   [50, 0]], np.float32)
    p1 = np.zeros_like(p2)
    mask = np.array([True, True, True, True, False, False])
    eye, h_esm = np.eye(3, dtype=np.float32), _shift(1.5, 0.0)
    r2b = np.sort(2 * np.sum(p2 ** 2, -1)[mask])
    r2e = np.sort(2 * np.sum((p2 - [1.5, 0.0]) ** 2, -1)[mask])
    np.testing.assert_allclose(r2b, [2, 2, 8, 8], rtol=1e-5)
    np.testing.assert_allclose(r2e, [4, 4, 4, 4], rtol=1e-5)
    assert np.median(r2e) <= 1.1 * np.median(r2b)  # the mean rule: accept
    assert not r2e[1] <= 1.1 * r2b[1]  # the lower-median rule: reject
    want = bool(jax.jit(jt.esm_guard)(eye, h_esm, p1, p2, mask))
    got = bool(tt.esm_guard(T(eye), T(h_esm), T(p1), T(p2), T(mask)))
    assert got == want is True


@pytest.mark.parametrize("sampler", ["matmul", "matmul_bf16", "bilinear"])
def test_tpu_samplers_raise(scene, sampler):
    base, img2, tpl, h0 = scene
    with pytest.raises(ValueError, match="sampler"):
        tt.esm_track(T(tpl), T(img2), T(h0), sampler=sampler)
    with pytest.raises(ValueError, match="sampler"):
        tt.esm_polish_pair_symmetric(T(base), T(img2), T(h0),
                                     sampler=sampler)
