"""Hand-written Hopper kernels for the hot path, each beside its plain version.

The reference's accelerator stack is ``sks_tpu/kernels`` (Pallas on the TPU);
here the same capability is CUDA C++ for ``sm_90a`` (``sks_tpu_torch/csrc``),
built with ``nvcc`` at first use and bound with ``ctypes``
(``sks_tpu_torch.kernels._build``).  Importing this package builds nothing.

K1, K2: ``aca_cuda``; K3: ``sks_cuda``; K4 (four instances):
``baselines_cuda``; K5 (six kinds, float64): ``fp64_cuda``; the IRLS refit
of RANSAC's top-K candidates and the annealed LM polish of the selected
model, which replace no TPU kernel: ``irls_cuda``, ``polish_cuda``.
``LAUNCHES`` counts the launches of every kernel.  ``SOLVE_KERNELS`` maps
each solver name to its float32 batched-solve kernel, ``FP64_SOLVE_KERNELS``
to its float64 one.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

from torch import Tensor

from sks_tpu_torch.kernels._soa import LAUNCHES, from_soa_h, to_soa  # noqa: F401
from sks_tpu_torch.kernels.aca_cuda import (  # noqa: F401
    aca_h_cuda,
    aca_solve_score_soa,
    aca_solve_soa,
    aca_solve_soa_plain,
)
from sks_tpu_torch.kernels.baselines_cuda import (  # noqa: F401
    SOA_SOLVERS,
    baseline_h_cuda,
    ge_solve_soa,
    ge_solve_soa_plain,
    gpt_solve_soa,
    gpt_solve_soa_plain,
    ho_solve_soa,
    ho_solve_soa_plain,
    ndlt_solve_soa,
    ndlt_solve_soa_plain,
)
from sks_tpu_torch.kernels.fp64_cuda import (  # noqa: F401
    fp64_h_cuda,
    fp64_solve_soa,
    fp64_solve_soa_plain,
)
from sks_tpu_torch.kernels.sks_cuda import (  # noqa: F401
    sks_h_cuda,
    sks_solve_soa,
    sks_solve_soa_plain,
)


class SolveKernel(NamedTuple):
    """One batched 4-point solve kernel: (8, B) minimal sets -> (9, B)."""

    key: str  # its LAUNCHES key; C entry points sks_<key>_<storage dtype>
    kernel: Callable[[Tensor, Tensor], Tensor]
    plain: Callable[[Tensor, Tensor], Tensor]
    source: str  # the CUDA source, from the repository root
    replaces: str  # the Pallas kernel it replaces, file:line


_BASELINES = "sks_tpu/kernels/baselines_pallas.py"

#: Solver name (as in ``ops.SOLVERS_H``) -> its batched solve kernel.
SOLVE_KERNELS = {
    "aca": SolveKernel("aca_solve", aca_solve_soa, aca_solve_soa_plain,
                       "sks_tpu_torch/csrc/aca.cu",
                       "sks_tpu/kernels/aca_pallas.py:69"),
    "sks": SolveKernel("sks_solve", sks_solve_soa, sks_solve_soa_plain,
                       "sks_tpu_torch/csrc/sks.cu",
                       "sks_tpu/kernels/sks_pallas.py:34"),
    "rho_ge": SolveKernel("ge_solve", ge_solve_soa, ge_solve_soa_plain,
                          "sks_tpu_torch/csrc/baselines.cu",
                          f"{_BASELINES}:101"),
    "gpt_lu": SolveKernel("gpt_solve", gpt_solve_soa, gpt_solve_soa_plain,
                          "sks_tpu_torch/csrc/baselines.cu",
                          f"{_BASELINES}:102"),
    "ho": SolveKernel("ho_solve", ho_solve_soa, ho_solve_soa_plain,
                      "sks_tpu_torch/csrc/baselines.cu", f"{_BASELINES}:105"),
    "ndlt": SolveKernel("ndlt_solve", ndlt_solve_soa, ndlt_solve_soa_plain,
                        "sks_tpu_torch/csrc/baselines.cu",
                        f"{_BASELINES}:108"),
}


def _fp64(kind: str) -> SolveKernel:
    """The K5 instance of the JAX package's ``kind``."""
    return SolveKernel(
        f"fp64_{kind}", functools.partial(fp64_solve_soa, kind=kind),
        functools.partial(fp64_solve_soa_plain, kind=kind),
        "sks_tpu_torch/csrc/fp64.cu", "sks_tpu/kernels/df64_pallas.py:141")


#: Solver name (as in ``ops.SOLVERS_H``) -> its float64 batched solve, the
#: K5 instance of its JAX kind: (8, B) float32 or float64 minimal sets ->
#: (9, B) float64, h22 = 1.
FP64_SOLVE_KERNELS = {
    "aca": _fp64("aca"),
    "sks": _fp64("sks"),
    "rho_ge": _fp64("ge"),
    "gpt_lu": _fp64("gpt"),
    "ho": _fp64("ho"),
    "ndlt": _fp64("ndlt"),
}
