"""Hopper CUDA kernel for SKS: batched solve (K3), beside its plain version.

K3 ``sks_solve_soa`` (``csrc/sks.cu::SksCore`` in ``soa.cuh::solve_soa_kernel``)
  Replaces ``sks_tpu/kernels/sks_pallas.py::sks_solve_soa`` (body
  ``_solve_kernel``).  Bound by device-memory bytes: 16 values in and 9 out
  per hypothesis (100 B in float32, 50 B in bfloat16 storage) for 169 flops
  and 5 IEEE reciprocals/divisions.  Design: one thread per hypothesis on the
  component-major ``(8, B)`` layout, so each of the 25 accesses is coalesced;
  bfloat16 storage halves the bytes while the arithmetic stays float32.  The
  body follows :func:`sks_tpu_torch.ops.sks.sks_core` op for op, so kernel
  and plain version agree bit for bit on the card.

The wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises, and counts the launch in
``LAUNCHES["sks_solve"]``.
"""

from __future__ import annotations

from torch import Tensor

from sks_tpu_torch.kernels._soa import (
    from_soa_h,
    solve_soa,
    solve_soa_plain,
    to_soa,
)
from sks_tpu_torch.ops.sks import sks_core

__all__ = ["sks_solve_soa", "sks_solve_soa_plain", "sks_h_cuda"]


def sks_solve_soa_plain(src: Tensor, tar: Tensor) -> Tensor:
    """Plain version of K3: :func:`sks_core` on the 8 component rows, in f32."""
    return solve_soa_plain(sks_core, src, tar)


def sks_solve_soa(src: Tensor, tar: Tensor) -> Tensor:
    """Batched SKS on component-major minimal sets (K3).

    Args:
      src, tar: (8, B) contiguous, float32 or bfloat16.

    Returns:
      (9, B) up-to-scale homographies in the input dtype, computed in f32.
    """
    return solve_soa("sks_solve", sks_core, src, tar)


def sks_h_cuda(src: Tensor, tar: Tensor) -> Tensor:
    """(B, 4, 2) convenience wrapper of K3: AoS -> SoA -> solve -> AoS.

    The counterpart of ``sks_tpu.kernels.sks_pallas.sks_h_pallas``.
    """
    return from_soa_h(sks_solve_soa(to_soa(src), to_soa(tar)))
