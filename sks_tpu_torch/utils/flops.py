"""Operation-count registry of the solvers, and the bandwidth ceiling.

The counterpart of ``sks_tpu/utils/flops.py`` (data, copied).  The reference
keeps its per-stage counts as comments (``ACA_SKS.cpp:27-98``) and headline
counts in its README; here they are data, held against the port's own
operation counter (``utils.profiling.cost_analysis``, the counter of
``bench/roofline.py``) in ``tests/test_torch_utils.py``, and used for the
bandwidth bound of the headline (``bench/headline.py``).
"""

from __future__ import annotations

__all__ = ["FLOPS", "bytes_per_hypothesis", "roofline_hps"]

#: Per-solve operation counts.  'solve' is up to scale; 'normalized' adds the
#: 12 operations of the H[8] normalization.  Sources: the reference's
#: README.md:48-59 and the solver modules' docstrings.
FLOPS = {
    "aca": {"solve": 85, "normalized": 97, "divisions": 0},
    "sks": {"solve": 157, "normalized": 169, "divisions": 5},
    "aca_rect": {"solve": 47, "normalized": 59, "divisions": 0},
    "aca_square": {"solve": 44, "normalized": 56, "divisions": 0},
    "aca_qr": {"solve": 29, "normalized": 41, "divisions": 0},
    "rho_ge": {"solve": 221, "normalized": 221, "divisions": 10},
    "gpt_lu": {"solve": 1950, "normalized": 1950, "divisions": 8},
    # N-point solvers, counts at N = 4 (the reference's formulas: DLT
    # >= 214 N + 26,379, HO >= 118 N + 1,354).
    "ndlt": {"solve": 27235, "normalized": 27247, "divisions": 12},
    "ho": {"solve": 1826, "normalized": 1838, "divisions": 12},
}


def bytes_per_hypothesis(dtype_bytes: int = 4, write_h: bool = True) -> int:
    """Device-memory bytes a hypothesis of a batched solve moves: 16 values
    in, 9 out (100 B in float32, 50 B in bfloat16)."""
    return (16 + (9 if write_h else 0)) * dtype_bytes


def roofline_hps(hbm_gbps: float, dtype_bytes: int = 4,
                 write_h: bool = True) -> float:
    """Bandwidth-bound ceiling of a batched solve in homographies/s.

    The batched minimal solvers do at most 169 operations for 100 B of
    traffic, so on any card their ceiling is the memory rate over the bytes
    a hypothesis moves.
    """
    return hbm_gbps * 1e9 / bytes_per_hypothesis(dtype_bytes, write_h)
