"""Hopper CUDA kernel K5: the float64 batched solve of all six solvers,
beside its plain version.

K5 ``fp64_solve_soa`` (``csrc/fp64.cu``, in ``soa.cuh::solve_soa_kernel``)
  Replaces ``sks_tpu/kernels/df64_pallas.py::df64_solve_soa`` (body
  ``_make_kernel`` over ``_CORES``).  The TPU has no fp64, so the JAX kernel
  runs the cores on double-float pairs and writes ``(18, M, 128)`` hi and lo
  words; the H100 has fp64, so this kernel runs the same cores on doubles
  and writes ``(9, B)`` float64, each H divided by its h22 as there.  One
  thread per hypothesis on the ``(8, B)`` layout; float32 or float64
  storage in (136 or 200 B per hypothesis with the float64 output).
  Expected bound: bytes for ACA, SKS and GE; float64 arithmetic and
  registers for GPT, HO and NDLT (``csrc/fp64.cu`` has the design note; the
  build log reports registers and spills).

Kinds are the JAX package's (``aca``, ``sks``, ``ge``, ``gpt``, ``ho``,
``ndlt``); each kind's plain version is its float64 core in
``sks_tpu_torch.ops.fp64.FP64_CORES`` on the 8 component rows, divided by
h22.  ``sks_tpu_torch.kernels.FP64_SOLVE_KERNELS`` maps each solver name to
its kind's kernel.  The wrapper runs the plain version only for tensors on
the CPU; for a CUDA tensor it launches the kernel or raises, and counts the
launch in ``LAUNCHES["fp64_<kind>"]``.
"""

from __future__ import annotations

import torch
from torch import Tensor

from sks_tpu_torch.kernels._soa import (
    check_soa,
    device_kind,
    from_soa_h,
    launch_soa,
    to_soa,
)
from sks_tpu_torch.ops.fp64 import FP64_CORES

__all__ = ["fp64_solve_soa", "fp64_solve_soa_plain", "fp64_h_cuda"]

_STORAGE = (torch.float32, torch.float64)


def _core(kind: str):
    if kind not in FP64_CORES:
        raise ValueError(f"unknown kind {kind!r}; expected one of "
                         f"{tuple(FP64_CORES)}")
    return FP64_CORES[kind]


def fp64_solve_soa_plain(src: Tensor, tar: Tensor, kind: str = "aca") -> Tensor:
    """Plain version of K5: the float64 core of ``kind`` on the 8 component
    rows (widened with ``Tensor.double()``), divided by h22.  (9, B) float64."""
    core = _core(kind)
    s = [src[k].double() for k in range(8)]
    t = [tar[k].double() for k in range(8)]
    h = torch.stack(core(*s, *t))
    return h / h[8]


def fp64_solve_soa(src: Tensor, tar: Tensor, kind: str = "aca") -> Tensor:
    """Batched float64 solve (K5) on component-major minimal sets; the
    counterpart of ``sks_tpu.kernels.df64_pallas.df64_solve_soa``.

    Args:
      src, tar: (8, B) contiguous, float32 or float64.
      kind: 'aca', 'sks', 'ge', 'gpt', 'ho' or 'ndlt'.

    Returns:
      (9, B) float64 homographies normalized to h22 = 1 (where the core's
      h22 is 0 or non-finite, non-finite entries).
    """
    _core(kind)
    check_soa(src, tar, _STORAGE)
    if device_kind(src) == "cpu":
        return fp64_solve_soa_plain(src, tar, kind)
    out = torch.empty((9, src.shape[1]), dtype=torch.float64,
                      device=src.device)
    dtype = "f32" if src.dtype == torch.float32 else "f64"
    return launch_soa(f"sks_fp64_{kind}_{dtype}", f"fp64_{kind}", src, tar, out)


def fp64_h_cuda(kind: str, src: Tensor, tar: Tensor) -> Tensor:
    """(B, 4, 2) convenience wrapper of K5: AoS -> SoA -> solve -> AoS,
    (B, 3, 3) float64 with h22 = 1."""
    return from_soa_h(fp64_solve_soa(to_soa(src), to_soa(tar), kind))
