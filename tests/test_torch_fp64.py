"""Port parity, the fp64 solvers: ``ops/fp64.py`` and K5's plain version
against the JAX package's double-float twins, on one seeded numpy input.

The JAX package runs its solver cores on double-float pairs (``DF``, about
49 bits) because the TPU has no fp64; the port runs the same cores in native
float64 (53 bits).  Each JAX result is read as ``hi + lo`` in float64.

The JAX df64 references run under ``jax.disable_jit()``, each once per module
on 16 quads (about 25 s in all on a CPU; jitting ``ndlt_df64_h`` alone takes
over a minute).  Eagerly there is no XLA simplifier to undo the error-free
transforms.  The one exception is ACA's K5, which runs as the JAX package's
own test of it does: ``df64_solve_soa(kind='aca', tile=1)`` in Pallas
interpret mode, on 128 quads.

Tolerances.  Each H is compared after scaling: the up-to-scale ops after
``fro`` normalisation, the h22-normalised results relative to each H's
largest entry.  Measured on these inputs: at most 1.9e-13 for the ops
(NDLT), 3.9e-13 for K5's plain version against the ``*_df64_h`` twins
(NDLT), 8.3e-13 against the interpret-mode ACA kernel.  That is the df64
rounding (2^-49 per operation) through chains of a few hundred operations
and the solvers' conditioning.  Every bound is held at 1e-11.

A third witness: the repository's C++ float64 solvers
(``native/src/sks_native.cpp``, built with g++ by ``sks_tpu_torch.native``;
skipped without a compiler), h22-normalised, against K5's plain version
and the JAX df64 twins on the same 16 quads at the same bound (measured:
at most 7.1e-14, NDLT).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_parity import fro, quads, to_np

from sks_tpu.kernels import df64_pallas as jk5
from sks_tpu.ops import df64 as jdf

import sks_tpu_torch
from sks_tpu_torch.kernels import FP64_SOLVE_KERNELS, LAUNCHES
from sks_tpu_torch.kernels._soa import from_soa_h, to_soa
from sks_tpu_torch.kernels.fp64_cuda import (
    fp64_h_cuda,
    fp64_solve_soa,
    fp64_solve_soa_plain,
)
from sks_tpu_torch.ops import SOLVERS_H, fp64 as tf
from sks_tpu_torch.ops.ho import ho_core
from sks_tpu_torch.ops.ndlt import ndlt_core
from sks_tpu_torch.robust.api import fused_by_default

T = torch.from_numpy
TOL = 1e-11
KINDS = ("aca", "sks", "ge", "gpt", "ho", "ndlt")


def _f64(h) -> np.ndarray:
    """A JAX ``DF`` as float64: hi + lo."""
    return np.asarray(h.hi, np.float64) + np.asarray(h.lo, np.float64)


def _rel(h, ref) -> float:
    """Largest entry gap of each H over its reference's largest entry."""
    h, ref = np.asarray(h), np.asarray(ref)
    gap = np.abs(h - ref).max(axis=(-2, -1))
    return float(np.max(gap / np.abs(ref).max(axis=(-2, -1))))


_JAX_H = {"aca": jdf.aca_df64_h, "sks": jdf.sks_df64_h, "ge": jdf.ge_df64_h,
          "gpt": jdf.gpt_df64_h, "ho": jdf.ho_df64_h, "ndlt": jdf.ndlt_df64_h}


@pytest.fixture(scope="module")
def jax_df64():
    """(src, tar, {name: float64 H}) of every JAX df64 op on 16 quads,
    evaluated once, eagerly."""
    src, tar = quads(40, 16)
    with jax.disable_jit():
        out = {kind: _f64(fn(src, tar)) for kind, fn in _JAX_H.items()}
        out["aca_n"] = _f64(jdf.aca_df64(src, tar))
        out["sks_n"] = _f64(jdf.sks_df64(src, tar))
    return src, tar, out


@pytest.fixture(scope="module")
def jax_k5_aca():
    """(src, tar, (128, 3, 3) float64 H) of the JAX K5 for 'aca' on 128
    quads, in interpret mode."""
    src, tar = quads(41, 128)
    s, t = (jnp.asarray(to_np(to_soa(T(p)))).reshape(8, 1, 128)
            for p in (src, tar))
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(jk5.df64_solve_soa(s, t, kind="aca", tile=1),
                         np.float64)
    h = (out[:9] + out[9:]).reshape(9, 128)
    return src, tar, from_soa_h(T(h)).numpy()


def _k5_plain(kind, src, tar) -> np.ndarray:
    s, t = to_soa(T(src)), to_soa(T(tar))
    return to_np(from_soa_h(fp64_solve_soa_plain(s, t, kind)))


@pytest.mark.parametrize("kind", KINDS)
def test_k5_plain_matches_jax(kind, jax_df64, jax_k5_aca):
    if kind == "aca":
        src, tar, ref = jax_k5_aca
    else:
        src, tar, hs = jax_df64
        ref = hs[kind] / hs[kind][..., 2:3, 2:3]
    h = _k5_plain(kind, src, tar)
    assert h.dtype == np.float64 and h.shape == ref.shape
    assert _rel(h, ref) <= TOL
    np.testing.assert_array_equal(h[..., 2, 2], 1.0)


@pytest.mark.parametrize("kind", KINDS)
def test_k5_plain_matches_the_cpp_oracle(kind, jax_df64):
    """The third witness: the repository's C++ float64 solvers
    (``native/src/sks_native.cpp``, built by ``sks_tpu_torch.native``)
    against K5's plain version and the JAX df64 twins, h22-normalised, on
    the same 16 quads (measured: at most 7.1e-14, NDLT)."""
    from sks_tpu_torch import native

    if not native.available():
        pytest.skip("no C++ compiler to build the native float64 oracle")
    src, tar, hs = jax_df64
    ref = native.solve_batch(kind, src.astype(np.float64),
                             tar.astype(np.float64))
    assert ref.dtype == np.float64 and ref.shape == (16, 3, 3)
    assert _rel(_k5_plain(kind, src, tar), ref) <= TOL
    assert _rel(ref, hs[kind] / hs[kind][..., 2:3, 2:3]) <= TOL


_OPS = {
    "aca_fp64_h": ("aca", False), "aca_fp64": ("aca_n", True),
    "sks_fp64_h": ("sks", False), "sks_fp64": ("sks_n", True),
    "ndlt_fp64_h": ("ndlt", False), "ge_fp64_h": ("ge", False),
    "gpt_fp64_h": ("gpt", False), "ho_fp64_h": ("ho", False),
}


@pytest.mark.parametrize("name", list(_OPS))
def test_fp64_op_matches_jax(name, jax_df64):
    src, tar, hs = jax_df64
    key, normalized = _OPS[name]
    op = getattr(tf, name)
    h = op(T(src), T(tar))
    assert h.dtype == torch.float64 and h.shape == (16, 3, 3)
    h = to_np(h)
    if normalized:
        assert _rel(h, hs[key]) <= TOL
    else:
        assert np.abs(fro(h) - fro(hs[key])).max() <= TOL
    # float32 points widen exactly: float64 storage of the same values
    # gives the same H, bit for bit.
    h64 = to_np(op(T(src).double(), T(tar).double()))
    np.testing.assert_array_equal(h64, h)
    assert getattr(sks_tpu_torch, name) is op


def test_fp64_registries_follow_the_jax_kinds():
    assert tuple(tf.FP64_CORES) == tuple(jk5._CORES)
    assert set(FP64_SOLVE_KERNELS) == set(SOLVERS_H) == set(tf.SOLVERS_FP64_H)
    with open(jk5.__file__) as f:
        pallas_line = f.read().splitlines()[140]
    assert "pl.pallas_call" in pallas_line
    for solve in FP64_SOLVE_KERNELS.values():
        assert solve.key.startswith("fp64_") and solve.key in LAUNCHES
        assert solve.source == "sks_tpu_torch/csrc/fp64.cu"
        assert solve.replaces == "sks_tpu/kernels/df64_pallas.py:141"


@pytest.mark.parametrize("name", list(FP64_SOLVE_KERNELS))
def test_k5_wrapper_on_cpu_is_the_fp64_op(name):
    """On CPU tensors K5's wrapper runs its plain version and counts no
    launch; that is the registered float64 op divided by h22, from either
    storage dtype."""
    solve = FP64_SOLVE_KERNELS[name]
    src, tar = quads(42, 100)
    s, t = to_soa(T(src)), to_soa(T(tar))
    before = dict(LAUNCHES)
    h = solve.kernel(s, t)
    assert LAUNCHES == before
    assert h.dtype == torch.float64 and h.shape == (9, 100)
    assert torch.equal(h, solve.plain(s, t))
    assert torch.equal(solve.kernel(s.double(), t.double()), h)
    kind = solve.key.removeprefix("fp64_")
    assert torch.equal(from_soa_h(h), fp64_h_cuda(kind, T(src), T(tar)))
    op = to_np(tf.SOLVERS_FP64_H[name](T(src), T(tar)))
    np.testing.assert_array_equal(to_np(from_soa_h(h)),
                                  op / op[..., 2:3, 2:3])


def _bad_k5_call(case):
    src, tar = quads(43, 12)
    s, t = to_soa(T(src)), to_soa(T(tar))
    return {
        "bf16": (s.bfloat16(), t.bfloat16(), "aca"),
        "f16": (s.half(), t.half(), "sks"),
        "int": (s.int(), t.int(), "ge"),
        "mixed_dtype": (s, t.double(), "gpt"),
        "mixed_devices": (s, t.to("meta"), "ho"),
        "not_soa": (s.T.contiguous(), t.T.contiguous(), "ndlt"),
        "non_contiguous": (s[:, ::2], t[:, ::2], "aca"),
        "unknown_kind": (s, t, "rho_ge"),
    }[case]


@pytest.mark.parametrize("case", [
    "bf16", "f16", "int", "mixed_dtype", "mixed_devices", "not_soa",
    "non_contiguous", "unknown_kind",
])
def test_k5_wrapper_rejects_what_the_kernel_does_not_take(case):
    s, t, kind = _bad_k5_call(case)
    with pytest.raises((TypeError, ValueError)):
        fp64_solve_soa(s, t, kind)


def _comps(p):
    return [T(p).reshape(-1, 8)[:, i] for i in range(8)]


def _fro_core(core, src, tar, **kw):
    h = torch.stack(core(*_comps(src), *_comps(tar), **kw), -1)
    return fro(to_np(h).reshape(-1, 3, 3))


@pytest.mark.parametrize("solver", ["ndlt", "ho"])
def test_invit64_agrees_with_the_other_eigensolvers(solver):
    """The float64 branch (``invit64``) finds the same H as the existing
    float64 branches on well-conditioned quads, after fro normalisation:
    measured 1.0e-12 against NDLT's 'invit' (whose float32-grade shift,
    2^-22 of the trace, converges less far) and 6e-14 against its
    Jacobi, 7e-15 against both HO forms; held at 1e-11."""
    src, tar = quads(44, 64, np.float64)
    if solver == "ndlt":
        new = _fro_core(ndlt_core, src, tar, eig="invit64")
        old = [_fro_core(ndlt_core, src, tar, eig="invit"),
               _fro_core(ndlt_core, src, tar, eig="jacobi", sweeps=10)]
    else:
        new = _fro_core(ho_core, src, tar, eig_method="invit64")
        old = [_fro_core(ho_core, src, tar, eig_method="closed3"),
               _fro_core(ho_core, src, tar, eig_method="jacobi")]
    for h in old:
        assert np.abs(new - h).max() <= TOL


@pytest.mark.parametrize("device,dtype,fused", [
    ("cuda", torch.float32, True),
    ("cuda", torch.bfloat16, True),
    ("cuda", torch.float64, False),
    ("cuda", torch.float16, False),
    ("cpu", torch.float32, False),
    ("cpu", torch.float64, False),
])
def test_fused_routing_follows_device_and_dtype(device, dtype, fused):
    """Only float32 and bfloat16 CUDA fits take the float32 fused kernel by
    default; float64 keeps its precision on the general path."""
    assert fused_by_default(device, dtype) is fused
