"""Batched homography solver ops: one canonical formulation per algorithm.

Every solver maps ``(..., 4, 2) x (..., 4, 2) -> (..., 3, 3)`` (NDLT accepts
``N >= 4`` points), broadcasts over leading batch dims, and preserves dtype.
The registries hold what this port has so far; asking for a solver of the
JAX package that is not ported yet raises a ``KeyError`` that says where it
comes from (ROADMAP.md).
"""

from sks_tpu_torch.ops.aca import aca, aca_h, aca_valid_mask  # noqa: F401
from sks_tpu_torch.ops.affine import (  # noqa: F401
    affine_3pt,
    affine_3pt_h,
    affine_valid_mask,
)
from sks_tpu_torch.ops.ndlt import ndlt, ndlt_h  # noqa: F401
from sks_tpu_torch.ops import linalg  # noqa: F401

#: Solvers of ``sks_tpu.ops.SOLVERS`` that later slices of the port bring.
_NOT_YET = {
    "sks": "ops/sks.py comes with kernel K3 (ROADMAP.md Queue B)",
    "ho": "ops/ho.py comes with kernel K4 (ROADMAP.md Queue B)",
    "gpt_lu": "ops/gpt.py comes with kernel K4 (ROADMAP.md Queue B)",
    "rho_ge": "ops/ge.py comes with kernel K4 (ROADMAP.md Queue B)",
}


class _Registry(dict):
    def __missing__(self, name):
        if name in _NOT_YET:
            raise KeyError(f"solver {name!r} is not ported yet: {_NOT_YET[name]}")
        raise KeyError(f"unknown solver {name!r}")


#: 4-point solvers, name -> callable(src, tar) -> normalized H.
SOLVERS = _Registry(aca=aca, ndlt=ndlt)

#: Up-to-scale variants where the algorithm has a cheaper unnormalized form.
SOLVERS_H = _Registry(aca=aca_h, ndlt=ndlt_h)


def solve_h(name: str, src, tar):
    """Dispatch to an up-to-scale solver by name."""
    return SOLVERS_H[name](src, tar)
