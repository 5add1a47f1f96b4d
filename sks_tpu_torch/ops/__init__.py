"""Batched homography solver ops: one canonical formulation per algorithm.

Every solver maps ``(..., 4, 2) x (..., 4, 2) -> (..., 3, 3)`` (NDLT and HO
accept ``N >= 4`` points), broadcasts over leading batch dims, and preserves
dtype.  The registries hold the six solvers of the reference benchmark
matrix, as ``sks_tpu.ops`` does.  ``ops.fp64`` holds their float64 forms,
the counterparts of ``sks_tpu.ops.df64``.
"""

from sks_tpu_torch.ops.aca import aca, aca_h, aca_valid_mask  # noqa: F401
from sks_tpu_torch.ops.sks import sks, sks_h, sks_valid_mask  # noqa: F401
from sks_tpu_torch.ops.affine import (  # noqa: F401
    affine_3pt,
    affine_3pt_h,
    affine_valid_mask,
)
from sks_tpu_torch.ops.ndlt import ndlt, ndlt_h  # noqa: F401
from sks_tpu_torch.ops.ho import ho, ho_h  # noqa: F401
from sks_tpu_torch.ops.gpt import gpt_lu  # noqa: F401
from sks_tpu_torch.ops.ge import rho_ge  # noqa: F401
from sks_tpu_torch.ops.fp64 import (  # noqa: F401
    FP64_CORES,
    SOLVERS_FP64_H,
    aca_fp64,
    aca_fp64_h,
    ge_fp64_h,
    gpt_fp64_h,
    ho_fp64_h,
    ndlt_fp64_h,
    residual2_fp64,
    sks_fp64,
    sks_fp64_h,
)
from sks_tpu_torch.ops import linalg  # noqa: F401


class _Registry(dict):
    def __missing__(self, name):
        raise KeyError(f"unknown solver {name!r}")


#: 4-point solvers, name -> callable(src, tar) -> normalized H.
SOLVERS = _Registry(
    aca=aca, sks=sks, ndlt=ndlt, ho=ho, gpt_lu=gpt_lu, rho_ge=rho_ge,
)

#: Up-to-scale variants where the algorithm has a cheaper unnormalized form.
SOLVERS_H = _Registry(
    aca=aca_h, sks=sks_h, ndlt=ndlt_h, ho=ho_h, gpt_lu=gpt_lu, rho_ge=rho_ge,
)


def solve_h(name: str, src, tar):
    """Dispatch to an up-to-scale solver by name."""
    return SOLVERS_H[name](src, tar)
