"""The least time the card could take for a kernel's work: its bound.

The bound of a call is the larger of two times: the bytes the function must
move (each input read once, each output written once) over the card's memory
rate, and the arithmetic it does over the card's peak rate for its type.
Arithmetic is counted from the kernel's plain PyTorch version, which runs
one elementwise op per line of the core: under a ``TorchDispatchMode`` every
add, subtract, multiply, divide or square root adds the number of elements
it produces, under the type of those elements (a sum adds the elements it
reads), so a core that works partly in float32 and partly in float64 (K5's
Jacobi seeds) is held to each type's own rate.  Comparisons, selects,
clamps, negations and absolute values are counted too, but apart
(``'other'``), and take no part in the bound: the peak rates are rates of
arithmetic.  Views, copies, casts and constructors are not counted.  The
count is taken on CPU tensors at a tiny size and scales with the shapes: per
hypothesis for a batched solve, per hypothesis and per (hypothesis, point)
pair for the fused solve+score kernel.

Peak rates are an NVIDIA H100 SXM's, from its data sheet, at its full 700 W
power limit: 3.35 TB/s of device memory, 67 TFLOP/s in float32 and 34
TFLOP/s in float64 outside the tensor cores.  Both count a fused
multiply-add as two operations; the kernels here are built without
contraction (``-fmad=false``), so no kernel can pass half of the operation
rate, and a bound set by operations is generous by that factor.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["H100_BYTES_PER_S", "H100_FLOPS", "bound_ms", "count_ops",
           "score_ops", "solve_ops"]

H100_BYTES_PER_S = 3.35e12
#: Peak arithmetic rate by the name of the element type.
H100_FLOPS = {"float32": 67e12, "float64": 34e12}

#: aten ops that are one arithmetic operation per element produced.
_ARITHMETIC = {"add", "sub", "rsub", "mul", "div", "sqrt", "rsqrt",
               "reciprocal", "pow", "square"}
#: aten ops that compare, select or flip a sign: one per element produced,
#: counted under 'other'.
_OTHER = {
    "neg", "abs", "where", "lt", "le", "gt", "ge", "eq", "ne", "maximum",
    "minimum", "clamp", "clamp_min", "clamp_max", "sign", "bitwise_and",
    "bitwise_or", "bitwise_not", "logical_and", "logical_or", "logical_not",
    "isnan", "isfinite",
}
#: Reductions: one arithmetic operation per element read.
_REDUCTIONS = {"sum"}


def _type_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in _REDUCTIONS:
            key, n = _type_name(args[0].dtype), args[0].numel()
        elif isinstance(out, torch.Tensor) and name in _ARITHMETIC:
            key, n = _type_name(out.dtype), out.numel()
        elif isinstance(out, torch.Tensor) and name in _OTHER:
            key, n = "other", out.numel()
        else:
            return out
        if key not in H100_FLOPS:  # integer or boolean arithmetic
            key = "other"
        self.ops[key] = self.ops.get(key, 0) + n
        return out


def count_ops(fn, *args) -> dict[str, int]:
    """Operations ``fn(*args)`` does (see the module docstring): arithmetic
    by the name of its element type ('float32', 'float64'), and 'other'."""
    with _OpCounter() as counter:
        fn(*args)
    return dict(counter.ops)


def solve_ops(plain, dtype=torch.float32) -> dict[str, int]:
    """Operations per hypothesis of a batched solve's plain version
    ``plain(src, tar)``, counted on one well-posed minimal set of ``dtype``."""
    src = torch.tensor([0.0, 0.0, 1.0, 0.1, 1.1, 1.0, -0.1, 0.9], dtype=dtype)
    tar = torch.tensor([0.2, 0.1, 1.3, 0.0, 1.0, 1.2, 0.1, 1.1], dtype=dtype)
    return count_ops(plain, src[:, None].contiguous(),
                     tar[:, None].contiguous())


def score_ops(plain, scoring: str) -> tuple[dict[str, int], dict[str, int]]:
    """Operations of the fused solve+score kernel's plain version
    ``plain(src, tar, pts, threshold, weights, scoring)``: (per hypothesis,
    per hypothesis-and-point pair), from counts at N = 1 and N = 2."""
    src = torch.tensor([0.0, 0.0, 1.0, 0.1, 1.1, 1.0, -0.1, 0.9])[:, None]
    tar = torch.tensor([0.2, 0.1, 1.3, 0.0, 1.0, 1.2, 0.1, 1.1])[:, None]
    one, two = (count_ops(plain, src.contiguous(), tar.contiguous(),
                          torch.full((4, n), 0.5), 1.0, torch.ones(n), scoring)
                for n in (1, 2))
    per_pair = {k: two[k] - one.get(k, 0) for k in two}
    return {k: one[k] - per_pair.get(k, 0) for k in one}, per_pair


def bound_ms(nbytes: float, ops: dict[str, float]) -> tuple[float, str]:
    """(bound in ms, 'bytes' or 'operations'): the larger of ``nbytes`` over
    the memory rate and the arithmetic of ``ops`` (a count by type name, as
    :func:`count_ops` gives; 'other' is left out), each type's count over
    its own peak rate."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = sum(ops.get(name, 0) / rate
                for name, rate in H100_FLOPS.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
