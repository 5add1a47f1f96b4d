"""Hopper CUDA kernels for the baseline solvers: batched solve (K4), four
instances, each beside its plain version.

K4 replaces ``sks_tpu/kernels/baselines_pallas.py::_soa_solve`` (body
``_make_kernel``), which the JAX package builds four times.  Here one kernel
template (``csrc/soa.cuh::solve_soa_kernel``) runs four device cores
(``csrc/baselines.cu``), each following its PyTorch core op for op:

=================  ===========================================  ============
wrapper            core (the plain version's and the body's)    bound
=================  ===========================================  ============
``ge_solve_soa``   ``ops.ge.ge_core`` (304 ops)                 bytes
``gpt_solve_soa``  ``ops.gpt.gpt_core`` (572 ops)               bytes
``ho_solve_soa``   ``ops.ho.ho_core(eig_method='jacobi')``      operations
                   (2,859 ops)
``ndlt_solve_soa`` ``ops.ndlt.ndlt_core(eig='invit')``          operations
                   (20,466 ops)
=================  ===========================================  ============

Each is one thread per hypothesis on the ``(8, B)`` layout, 16 values in and
9 out (100 B in float32, 50 B in bfloat16 storage), arithmetic in float32;
the op counts are the arithmetic operations of the plain version
(``bench/roofline.py``; compares and selects apart), and "bound" is which of bytes at the card's memory
rate or operations at its float32 rate takes longer.  GE runs at the byte
bound like K1.  GPT keeps its tableau in registers (every static loop
unrolled).  HO's time is its 30 Jacobi rotations: the 10 sweeps are a loop,
and the rotation keeps every rounding of the plain version in fewer
instructions, with an exact sequence for the zero and subnormal numerators
that a converged Jacobi divides, which the compiler's IEEE division sends
down its slow path (``csrc/baselines.cuh::Rotation``, ``DivTiny``;
``bench/ho_ablation.py`` has the ablation and the check that holds those
forms against the IEEE ones).  NDLT's time is its 9x9 Jacobi seed, 108
rotations that each start with a dependent sqrt, division, sqrt, division:
what it needs is more resident warps to hide that chain, so the seed's
81-entry eigenvector matrix lives in shared memory (``[entry][thread]``,
20.7 KB a block of 64 threads) and the normal matrix is rebuilt after the
seed from inputs read a second time, which brings the kernel from 225 to
108 registers and from 8 to 18 warps an SM without touching the arithmetic
(``csrc/baselines.cu`` has the design note and ``bench/ndlt_ablation.py`` the
ablation that led there; the build log reports registers and spills).  One
thread's seed is about a tenth longer through shared memory, so batches too
small to fill the card (B <= 10,000) run that much slower than before.

Each wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises, and counts the launch in
``LAUNCHES`` (keys ``ge_solve``, ``gpt_solve``, ``ho_solve``,
``ndlt_solve``).
"""

from __future__ import annotations

import functools

from torch import Tensor

from sks_tpu_torch.kernels._soa import (
    from_soa_h,
    solve_soa,
    solve_soa_plain,
    to_soa,
)
from sks_tpu_torch.ops.ge import ge_core
from sks_tpu_torch.ops.gpt import gpt_core
from sks_tpu_torch.ops.ho import ho_core
from sks_tpu_torch.ops.ndlt import ndlt_core

__all__ = [
    "ge_solve_soa",
    "gpt_solve_soa",
    "ho_solve_soa",
    "ndlt_solve_soa",
    "ge_solve_soa_plain",
    "gpt_solve_soa_plain",
    "ho_solve_soa_plain",
    "ndlt_solve_soa_plain",
    "SOA_SOLVERS",
    "baseline_h_cuda",
]

_ho_jacobi = functools.partial(ho_core, eig_method="jacobi")
_ndlt_invit = functools.partial(ndlt_core, eig="invit")


def ge_solve_soa_plain(src: Tensor, tar: Tensor) -> Tensor:
    """Plain version of K4-GE: :func:`ge_core` on the component rows, f32."""
    return solve_soa_plain(ge_core, src, tar)


def gpt_solve_soa_plain(src: Tensor, tar: Tensor) -> Tensor:
    """Plain version of K4-GPT: :func:`gpt_core` on the component rows, f32."""
    return solve_soa_plain(gpt_core, src, tar)


def ho_solve_soa_plain(src: Tensor, tar: Tensor) -> Tensor:
    """Plain version of K4-HO: ``ho_core(eig_method='jacobi')``, f32."""
    return solve_soa_plain(_ho_jacobi, src, tar)


def ndlt_solve_soa_plain(src: Tensor, tar: Tensor) -> Tensor:
    """Plain version of K4-NDLT: ``ndlt_core(eig='invit')``, f32."""
    return solve_soa_plain(_ndlt_invit, src, tar)


def ge_solve_soa(src: Tensor, tar: Tensor) -> Tensor:
    """Batched RHO-GE (K4): (8, B) float32 or bfloat16 minimal sets ->
    (9, B) homographies (H[2,2] = 1) in the input dtype."""
    return solve_soa("ge_solve", ge_core, src, tar)


def gpt_solve_soa(src: Tensor, tar: Tensor) -> Tensor:
    """Batched GPT-LU (K4): (8, B) float32 or bfloat16 minimal sets ->
    (9, B) homographies (H[2,2] = 1) in the input dtype."""
    return solve_soa("gpt_solve", gpt_core, src, tar)


def ho_solve_soa(src: Tensor, tar: Tensor) -> Tensor:
    """Batched HO (K4): (8, B) float32 or bfloat16 minimal sets -> (9, B)
    up-to-scale homographies in the input dtype."""
    return solve_soa("ho_solve", _ho_jacobi, src, tar)


def ndlt_solve_soa(src: Tensor, tar: Tensor) -> Tensor:
    """Batched NDLT (K4): (8, B) float32 or bfloat16 minimal sets -> (9, B)
    up-to-scale homographies in the input dtype."""
    return solve_soa("ndlt_solve", _ndlt_invit, src, tar)


#: name -> SoA kernel wrapper, keyed as ``SOLVERS_H`` (and as the JAX
#: package's ``baselines_pallas.SOA_SOLVERS``).
SOA_SOLVERS = {
    "rho_ge": ge_solve_soa,
    "gpt_lu": gpt_solve_soa,
    "ho": ho_solve_soa,
    "ndlt": ndlt_solve_soa,
}


def baseline_h_cuda(name: str, src: Tensor, tar: Tensor) -> Tensor:
    """(B, 4, 2) convenience wrapper: AoS -> SoA -> solve -> AoS.

    The counterpart of ``sks_tpu.kernels.baselines_pallas.baseline_h_pallas``.
    """
    return from_soa_h(SOA_SOLVERS[name](to_soa(src), to_soa(tar)))
