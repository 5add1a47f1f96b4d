"""Numeric-health checks for solver batches: the debug layer.

The counterpart of ``sks_tpu/utils/checks.py``.  The failure that matters is
silent NaN / inf propagation from degenerate minimal sets; the production
paths mask degeneracies (RANSAC scores them -1) and read nothing back.  These
helpers are for debugging, and they do read the card: ``checked_solver``
brings one flag per check back to the host and ``assert_finite`` one flag,
where the JAX package's checkify and debug callback report from inside a
compiled program.  ``nonfinite_fraction`` stays on the device.
"""

from __future__ import annotations

import torch
from torch import Tensor

from sks_tpu_torch.ops import SOLVERS_H

__all__ = ["CheckError", "checked_solver", "nonfinite_fraction",
           "assert_finite"]


class CheckError:
    """A failed check: its message, raised by :meth:`throw`."""

    def __init__(self, msg: str):
        self.msg = msg

    def get(self) -> str:
        return self.msg

    def throw(self) -> None:
        raise ValueError(self.msg)


def checked_solver(name: str):
    """A checked solver: ``err, h = fn(src, tar)``.

    ``err`` is None when every homography of the batch is finite and
    nonzero, else a :class:`CheckError` holding the first failed check's
    message, in the JAX package's order: "non-finite homography in batch",
    then "zero (degenerate) homography in batch" (the division-free solvers
    signal a rank drop with an all-zero H).  ``err.throw()`` raises.
    """
    solver = SOLVERS_H[name]

    def fn(src: Tensor, tar: Tensor):
        h = solver(src, tar)
        if not bool(torch.isfinite(h).all()):
            return CheckError("non-finite homography in batch"), h
        scale = torch.amax(torch.abs(h), dim=(-2, -1))
        if not bool((scale > 0).all()):
            return CheckError("zero (degenerate) homography in batch"), h
        return None, h

    return fn


def nonfinite_fraction(h: Tensor) -> Tensor:
    """Fraction of the batch's (..., 3, 3) entries with a non-finite
    element, a 0-d float32 tensor on ``h``'s device."""
    bad = ~torch.isfinite(h).all(dim=-1).all(dim=-1)
    return bad.float().mean()


def assert_finite(x: Tensor, msg: str = "non-finite") -> Tensor:
    """``x``, after raising ``FloatingPointError(msg)`` if any element is
    not finite."""
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(msg)
    return x
