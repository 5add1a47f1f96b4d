"""Hand-written Hopper kernels for the hot path, each beside its plain version.

The reference's accelerator stack is ``sks_tpu/kernels`` (Pallas on the TPU);
here the same capability is CUDA C++ for ``sm_90a`` (``sks_tpu_torch/csrc``),
built with ``nvcc`` at first use and bound with ``ctypes``
(``sks_tpu_torch.kernels._build``).  Importing this package builds nothing.
"""

from sks_tpu_torch.kernels.aca_cuda import (  # noqa: F401
    LAUNCHES,
    aca_h_cuda,
    aca_solve_score_soa,
    aca_solve_soa,
    from_soa_h,
    to_soa,
)
