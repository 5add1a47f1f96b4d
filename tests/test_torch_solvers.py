"""Port parity, the Table-8 solvers: SKS, RHO-GE, GPT-LU, HO, NDLT and their
eigensolvers, against the JAX package on one seeded numpy input.

Each port core (``sks_tpu_torch.ops.*_core``) is the eager op, the plain
version of its CUDA kernel and the specification of the kernel's body.  Here
it is held against the same JAX core, jitted on the CPU; the kernels are held
against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py), where they agree bit for bit.

Tolerances, after ``normalize_h('fro')``, measured at B = 256 on
pixel-scale quads (tests/torch_parity.py::quads).  XLA on the CPU contracts
multiply-adds into FMAs and the port does not, so float32 results differ in
the last bits, and each solver amplifies that by its own conditioning:

* SKS, GE, GPT: up to 3.0e-5 (GE), held at 5e-5.  Their straight-line cores
  evaluated op by op in numpy float32 (no FMA) equal the port bit for bit.
* HO (closed form and Jacobi): up to 8.4e-5 over two seeds (the 3x3
  eigensolve amplifies the FMA differences), held at 2e-4.
* NDLT (Jacobi and inverse iteration): the 9x9 eigensolve amplifies more, up
  to 2.0e-4 on the worst quad and 1.7e-5 at the 99th percentile: held at
  1e-3 on the worst quad and 5e-6 on the median (measured 1.3e-6).

The JAX NDLT core takes ~30 s to jit on the CPU, so it is jitted once per
file (``jax_ndlt_invit``) and serves both the core and the K4-NDLT wrapper;
the Jacobi form is held in tests/test_torch_ops.py, on another worker.
"""

import functools
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import jit_of
from torch_parity import fro, quads, to_np

import sks_tpu.ops as jops
from sks_tpu.ops import linalg as jlinalg

import sks_tpu_torch.ops as tops
from sks_tpu_torch.kernels import baselines_cuda as tb
from sks_tpu_torch.kernels import sks_cuda as tsk
from sks_tpu_torch.kernels._soa import from_soa_h, to_soa
from sks_tpu_torch.ops import linalg as tlinalg

T = torch.from_numpy
B = 256

_MODS = ("sks", "ge", "gpt", "ho", "ndlt")
J = {m: import_module(f"sks_tpu.ops.{m}") for m in _MODS}
P = {m: import_module(f"sks_tpu_torch.ops.{m}") for m in _MODS}

_CORES = {
    "sks": ("sks", "sks_core", {}),
    "ge": ("ge", "ge_core", {}),
    "gpt": ("gpt", "gpt_core", {}),
    "ho_closed3": ("ho", "ho_core", {"eig_method": "closed3"}),
    "ho_jacobi": ("ho", "ho_core", {"eig_method": "jacobi"}),
}


def _jcomps(p):
    return [p.reshape(-1, 8)[:, i] for i in range(8)]


def _tcomps(p):
    return [T(p).reshape(-1, 8)[:, i] for i in range(8)]


def _jax_core(mod, name, kw, src, tar):
    core = getattr(J[mod], name)
    out = jax.jit(lambda s, t: jnp.stack(core(*_jcomps(s), *_jcomps(t), **kw),
                                         -1))(src, tar)
    return np.asarray(out).reshape(-1, 3, 3)


def _port_core(mod, name, kw, src, tar):
    core = getattr(P[mod], name)
    return to_np(torch.stack(core(*_tcomps(src), *_tcomps(tar), **kw),
                             -1)).reshape(-1, 3, 3)


@pytest.mark.parametrize("case", list(_CORES))
def test_core_matches_jax(case):
    mod, name, kw = _CORES[case]
    src, tar = quads(20, B)
    hj = _jax_core(mod, name, kw, src, tar)
    ht = _port_core(mod, name, kw, src, tar)
    np.testing.assert_allclose(fro(ht), fro(hj),
                               atol=2e-4 if mod == "ho" else 5e-5)


@pytest.mark.parametrize("case", ["sks", "ge", "gpt"])
def test_straight_line_core_equals_jax_core_op_by_op(case):
    """No FMA on either side: bit for bit against the JAX core in numpy."""
    mod, name, kw = _CORES[case]
    src, tar = quads(21, 64)
    hn = getattr(J[mod], name)(*_jcomps(src), *_jcomps(tar), **kw)
    hn = np.stack([np.broadcast_to(np.asarray(v, np.float32), (64,))
                   for v in hn], -1).reshape(-1, 3, 3)
    np.testing.assert_array_equal(_port_core(mod, name, kw, src, tar), hn)


@pytest.fixture(scope="module")
def jax_ndlt_invit():
    """(src, tar, JAX ndlt_core(eig='invit')) at B = 256: jitted once."""
    src, tar = quads(22, B)
    return src, tar, _jax_core("ndlt", "ndlt_core", {"eig": "invit"}, src, tar)


def _assert_ndlt_close(ht, hj):
    d = np.abs(fro(ht) - fro(hj)).max(axis=(1, 2))
    assert d.max() <= 1e-3 and np.median(d) <= 5e-6, (d.max(), np.median(d))


def test_ndlt_core_invit_matches_jax(jax_ndlt_invit):
    src, tar, hj = jax_ndlt_invit
    _assert_ndlt_close(_port_core("ndlt", "ndlt_core", {"eig": "invit"},
                                  src, tar), hj)


def test_k4_ndlt_plain_matches_jax_core(jax_ndlt_invit):
    """The K4-NDLT wrapper on CPU tensors (its plain version) against the JAX
    package's kernel body, jitted (its Pallas kernel's interpret-mode tests
    are marked slow in tests/test_kernels.py)."""
    src, tar, hj = jax_ndlt_invit
    s, t = to_soa(T(src)), to_soa(T(tar))
    ht = tb.ndlt_solve_soa(s, t)
    assert ht.shape == (9, B) and ht.dtype == torch.float32
    _assert_ndlt_close(to_np(from_soa_h(ht)), hj)
    assert torch.equal(ht, tb.ndlt_solve_soa_plain(s, t))


def test_cores_reject_unknown_eigensolvers():
    src, tar = quads(23, 4)
    with pytest.raises(ValueError, match="eig_method"):
        _port_core("ho", "ho_core", {"eig_method": "eigh"}, src, tar)
    with pytest.raises(ValueError, match="eig"):
        _port_core("ndlt", "ndlt_core", {"eig": "eigh"}, src, tar)


@pytest.mark.parametrize("name", ["sks", "rho_ge", "gpt_lu", "ho", "ndlt"])
@pytest.mark.parametrize("registry", ["SOLVERS", "SOLVERS_H"])
def test_registered_solver_matches_jax(registry, name):
    src, tar = quads(24, 64)
    hj = jit_of(getattr(jops, registry)[name])(src, tar)
    ht = getattr(tops, registry)[name](T(src), T(tar))
    assert ht.shape == (64, 3, 3) and ht.dtype == torch.float32
    # The N-point forms (ndlt_h: 8-sweep 9x9 Jacobi; ho_h: closed form) and
    # the pivoted solve of gpt_lu, at N = 4: measured <= 2.0e-5.
    np.testing.assert_allclose(fro(to_np(ht)), fro(hj), atol=1e-4)


def test_gpt_lu_methods_agree():
    src, tar = quads(25, 32, np.float64)
    hj = jit_of(functools.partial(J["gpt"].gpt_lu, method="lax"))(src, tar)
    hu = P["gpt"].gpt_lu(T(src), T(tar), method="unrolled")
    hl = P["gpt"].gpt_lu(T(src), T(tar), method="lax")
    np.testing.assert_allclose(to_np(hu), np.asarray(hj), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(to_np(hl), np.asarray(hj), rtol=1e-9, atol=1e-9)
    with pytest.raises(ValueError, match="method"):
        P["gpt"].gpt_lu(T(src), T(tar), method="qr")


def test_build_gpt_system_matches_jax():
    src, tar = quads(26, 16, np.float64)
    aj, bj = jax.jit(J["gpt"].build_gpt_system)(src, tar)
    at, bt = P["gpt"].build_gpt_system(T(src), T(tar))
    np.testing.assert_array_equal(to_np(at), np.asarray(aj))
    np.testing.assert_array_equal(to_np(bt), np.asarray(bj))


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_sks_valid_mask_matches_jax(dt):
    src, tar = quads(27, 64, dt)
    src[:6, 1] = src[:6, 0]                                   # M == N
    src[6:12, 2] = src[6:12, 0] + 0.3 * (src[6:12, 1] - src[6:12, 0])  # P on MN
    tar[12:16, 3] = tar[12:16, 0] + 2.0 * (tar[12:16, 1] - tar[12:16, 0])
    mj = np.asarray(jit_of(jops.sks_valid_mask)(src, tar))
    mt = to_np(tops.sks_valid_mask(T(src), T(tar)))
    assert not mt[:16].any() and mt[16:].all()
    np.testing.assert_array_equal(mt, mj)


def test_canon_matches_jax():
    src, _ = quads(28, 32, np.float64)
    for a, b in zip(P["sks"]._canon(T(src)), jax.jit(J["sks"]._canon)(src)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-12)


def test_ho_helpers_match_jax():
    rng = np.random.default_rng(29)
    pts = rng.uniform(0.0, 640.0, (3, 20, 2))
    w = (rng.uniform(size=(3, 20)) > 0.2).astype(np.float64)
    nj, pj = jax.jit(J["ho"]._iso_norm)(pts, w)
    nt, pt = P["ho"]._iso_norm(T(pts), T(w))
    np.testing.assert_allclose(to_np(nt), np.asarray(nj), rtol=1e-12)
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-12)
    g = rng.normal(size=(5, 3, 3))
    g = g @ np.swapaxes(g, -1, -2)
    np.testing.assert_allclose(to_np(P["ho"]._inv3_sym(T(g))),
                               np.asarray(jax.jit(J["ho"]._inv3_sym)(g)),
                               rtol=1e-9)


def test_ho_weighted_matches_jax():
    rng = np.random.default_rng(30)
    src, tar = quads(30, 8, np.float64)
    src = np.concatenate([src, src + rng.normal(0, 40, src.shape)], axis=-2)
    tar = np.concatenate([tar, tar + rng.normal(0, 1, tar.shape)], axis=-2)
    w = (rng.uniform(size=(8, 8)) > 0.2).astype(np.float64)
    hj = jax.jit(J["ho"].ho)(src, tar, w)
    ht = P["ho"].ho(T(src), T(tar), T(w))
    np.testing.assert_allclose(to_np(ht), np.asarray(hj), rtol=1e-7, atol=1e-7)


# --- the component eigensolvers and the unrolled solve ----------------------

def _psd(seed, n, batch=64, dt=np.float32):
    a = np.random.default_rng(seed).normal(size=(batch, n, n + 2))
    return (a @ np.swapaxes(a, -1, -2)).astype(dt)


def _rows(a, lib):
    n = a.shape[-1]
    conv = T if lib == "torch" else jnp.asarray
    return [[conv(np.ascontiguousarray(a[:, i, j])) for j in range(n)]
            for i in range(n)]


def _up_to_sign(v, ref):
    v, ref = np.stack(v, -1), np.stack(ref, -1)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
    return v * np.sign(np.sum(v * ref, -1, keepdims=True)), ref


@pytest.mark.parametrize("solver", ["jacobi", "invit"])
def test_component_eigensolvers_match_jax(solver):
    a = _psd(31, 4)
    jfn = {"jacobi": functools.partial(jlinalg.jacobi_smallest_col_core,
                                       sweeps=6),
           "invit": jlinalg.invit_smallest_col_core}[solver]
    tfn = {"jacobi": functools.partial(tlinalg.jacobi_smallest_col_core,
                                       sweeps=6),
           "invit": tlinalg.invit_smallest_col_core}[solver]
    vj = jax.jit(lambda m: jnp.stack(jfn([[m[:, i, j] for j in range(4)]
                                          for i in range(4)]), -1))(a)
    vt = tfn(_rows(a, "torch"))
    v, ref = _up_to_sign([to_np(x) for x in vt], list(np.asarray(vj).T))
    np.testing.assert_allclose(v, ref, atol=1e-4)
    # And it is the eigenvector of the smallest eigenvalue.
    _, e = np.linalg.eigh(a.astype(np.float64))
    v, ref = _up_to_sign(list(v.T), list(e[..., :, 0].T))
    np.testing.assert_allclose(v, ref, atol=1e-3)


def test_smallest_eigvec3_core_matches_jax():
    a = _psd(32, 3)
    comps = [a[:, 0, 0], a[:, 0, 1], a[:, 0, 2], a[:, 1, 1], a[:, 1, 2],
             a[:, 2, 2]]
    vj = jax.jit(lambda *c: jnp.stack(jlinalg.smallest_eigvec3_core(*c), -1))(
        *comps)
    vt = tlinalg.smallest_eigvec3_core(*(T(np.ascontiguousarray(c))
                                         for c in comps))
    v, ref = _up_to_sign([to_np(x) for x in vt], list(np.asarray(vj).T))
    np.testing.assert_allclose(v, ref, atol=1e-4)


@pytest.mark.parametrize("method", ["auto", "closed3", "jacobi", "eigh"])
def test_smallest_eigvec_sym_matches_jax(method):
    a = _psd(33, 3, dt=np.float64)
    vj = np.asarray(jax.jit(functools.partial(jlinalg.smallest_eigvec_sym,
                                              method=method))(a))
    vt = to_np(tlinalg.smallest_eigvec_sym(T(a), method=method))
    v, ref = _up_to_sign(list(vt.T), list(vj.T))
    np.testing.assert_allclose(v, ref, atol=1e-9)
    with pytest.raises(ValueError, match="unknown method"):
        tlinalg.smallest_eigvec_sym(T(a), method="invit")


@pytest.mark.parametrize("pivot", [False, True])
def test_solve_unrolled_matches_jax(pivot):
    rng = np.random.default_rng(34)
    a = rng.normal(size=(16, 6, 6))
    b = rng.normal(size=(16, 6, 2))
    xj = jax.jit(functools.partial(jlinalg.solve_unrolled, pivot=pivot))(a, b)
    xt = tlinalg.solve_unrolled(T(a), T(b), pivot=pivot)
    np.testing.assert_allclose(to_np(xt), np.asarray(xj), rtol=1e-9,
                               atol=1e-9)
    x1 = tlinalg.solve_unrolled(T(a), T(b[..., 0]), pivot=pivot)
    np.testing.assert_allclose(to_np(x1), np.asarray(xj)[..., 0], rtol=1e-9,
                               atol=1e-9)


def test_wrappers_are_the_registered_cores_on_cpu():
    """K3 and K4 on CPU tensors: their plain versions, and the AoS forms."""
    src, tar = quads(35, 100)
    s, t = to_soa(T(src)), to_soa(T(tar))
    np.testing.assert_array_equal(to_np(tsk.sks_h_cuda(T(src), T(tar))),
                                  to_np(tops.sks_h(T(src), T(tar))))
    np.testing.assert_array_equal(
        to_np(tb.baseline_h_cuda("rho_ge", T(src), T(tar))),
        to_np(tops.rho_ge(T(src), T(tar))))
    from sks_tpu_torch.kernels import SOLVE_KERNELS

    assert set(SOLVE_KERNELS) == set(tops.SOLVERS_H)
    for name, fn in tb.SOA_SOLVERS.items():
        assert SOLVE_KERNELS[name].kernel is fn
    for solve in SOLVE_KERNELS.values():
        assert torch.equal(solve.kernel(s, t), solve.plain(s, t))
