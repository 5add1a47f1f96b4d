"""The least time the card could take for a kernel's work, frozen here.

Peaks of one NVIDIA H100 SXM from its data sheet, at its full 700 W power
limit: 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of device
memory.  A kernel's bound is the larger of its operations over the first and
its bytes over the second; its roofline share is that bound over the device
time it took.

K2, the fused ACA solve and score (``aca_solve_score_kernel`` and its
``sum_chunks_kernel``), at P pairs of B hypotheses against N points: 128
float32 operations a hypothesis to solve it and 45 a hypothesis and point to
score it (counted from the kernel's plain version with inlier counting,
``sks_tpu_torch/bench/roofline.score_ops``, when this benchmark was written;
``benchmark/tests`` holds the count to it), and 17 float32 values a
hypothesis (its 8 + 8 coordinates in, its score out) and 5 a point (4
coordinates and a weight) moved once.  Comparisons and selects are not
operations.
"""

from __future__ import annotations

H100_FP32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12

K2_OPS_PER_HYPOTHESIS = 128
K2_OPS_PER_HYPOTHESIS_POINT = 45
K2_NAMES = ("aca_solve_score_kernel", "sum_chunks_kernel")


def k2_ops(pairs: int, hypotheses: int, points: int) -> int:
    return pairs * hypotheses * (K2_OPS_PER_HYPOTHESIS
                                 + K2_OPS_PER_HYPOTHESIS_POINT * points)


def k2_bytes(pairs: int, hypotheses: int, points: int) -> int:
    return 4 * pairs * (17 * hypotheses + 5 * points)


def k2_bound_s(pairs: int, hypotheses: int, points: int) -> float:
    return max(k2_ops(pairs, hypotheses, points) / H100_FP32_FLOPS,
               k2_bytes(pairs, hypotheses, points) / H100_BYTES_PER_S)


def k2_roofline_pct(trace, pairs: int, hypotheses: int, points: int):
    """K2's share of its bound in the traced window, in percent: the bound
    of each launch over the device time of K2's two kernels; None where the
    window launched none."""
    launches = trace.kernels_named(K2_NAMES[0])
    if not launches:
        return None
    spent = sum(e - s for name in K2_NAMES
                for s, e, _ in trace.kernels_named(name)) / 1e9
    bound = len(launches) * k2_bound_s(pairs, hypotheses, points)
    return 100.0 * bound / spent
