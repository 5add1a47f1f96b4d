"""The paper's Table 8 in float64 on the card: K5, the six solvers in fp64.

The counterpart of ``sks_tpu/bench/df64_table.py::run``.  The reference's
Table 8 is CUDA fp64 (``REFERENCE_TABLE8_US``); the TPU could only emulate
fp64 with double-float pairs, while the H100 has fp64 units, so each row
here is at the reference's own precision (not on its card).  For each
solver and batch size B, from float64 inputs, in device time on one CUDA
card (``bench.table8.median_device_ms``):

* ``kernel_ms``: the solver's K5 instance on the ``(8, B)`` layout
  (``kernels.FP64_SOLVE_KERNELS``), h22-normalized as the reference's kernels;
* ``plain_soa_ms``: its plain PyTorch version on the same layout (the
  counterpart of the JAX package's ``df64_soa_xla_us``);
* ``eager_aos_ms``: the eager float64 op ``ops.fp64.SOLVERS_FP64_H[name]``
  on ``(B, 4, 2)`` inputs (the counterpart of ``df64_aos_chained``);
* hypotheses/s, and the bytes the kernel must move (16 float64 values in, 9
  out: 200 B per hypothesis) per second against the 3.35 TB/s peak;

beside the reference's CUDA fp64 time at its nearest batch.  The TPU's
chained timing and its XLA-only rows are not ported.

Accuracy, beside the times: on one batch of exact float64 quads, the max
and median reprojection of every solver's float32 kernel (fed the float32
rounding of the quads) and of its K5 instance (fed the float64 quads), both
evaluated in float64 with ``ops.fp64.residual2_fp64`` (``accuracy_check``);
and K5's NDLT against the eager ``ndlt_fp64_h`` (``ndlt_fp64_accuracy``).

Run on a machine with a CUDA card, from the repository root:

    python -m sks_tpu_torch.bench.fp64_table [--out PATH]
"""

from __future__ import annotations

import json

import torch

from sks_tpu_torch.bench.table8 import (
    KERNEL_RUNS,
    PLAIN_RUNS,
    card_line,
    median_device_ms,
    nearest_ref_us,
)
from sks_tpu_torch.kernels import (
    FP64_SOLVE_KERNELS,
    SOLVE_KERNELS,
    from_soa_h,
    to_soa,
)
from sks_tpu_torch.ops.fp64 import SOLVERS_FP64_H, ndlt_fp64_h, residual2_fp64
from sks_tpu_torch.utils.synth import random_quad_pairs

__all__ = ["run_table", "accuracy_check", "ndlt_fp64_accuracy", "run", "main"]

DEFAULT_B = (1, 10_000, 1 << 20)
#: Bytes K5 moves per hypothesis from float64 inputs: 16 in, 9 out.
BYTES_PER_H = (16 + 9) * 8
PEAK_BYTES_PER_S = 3.35e12


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the fp64 table times the CUDA kernels and needs a "
                           "card")
    return torch.device("cuda", 0)


def run_table(batches=DEFAULT_B, seed: int = 0) -> list[dict]:
    """Time every solver's K5 instance, plain version and eager float64 op
    at every batch size on CUDA device 0, from float64 inputs; row dicts."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for b in batches:
        src, tar = random_quad_pairs(gen, b, torch.float64)
        s, t = to_soa(src), to_soa(tar)
        for name, solve in FP64_SOLVE_KERNELS.items():
            kernel, plain, eager = solve.kernel, solve.plain, SOLVERS_FP64_H[name]
            kernel_ms = median_device_ms(lambda: kernel(s, t), KERNEL_RUNS,
                                         reps=10)
            plain_ms = median_device_ms(lambda: plain(s, t), PLAIN_RUNS)
            eager_ms = median_device_ms(lambda: eager(src, tar), PLAIN_RUNS)
            ref_b, ref_us = nearest_ref_us(name, b)
            bytes_per_s = b * BYTES_PER_H / (kernel_ms * 1e-3)
            rows.append({
                "solver": name, "batch": b, "dtype": "float64",
                "kernel_ms": kernel_ms, "plain_soa_ms": plain_ms,
                "eager_aos_ms": eager_ms,
                "h_per_s": b / (kernel_ms * 1e-3),
                "bytes_per_s": bytes_per_s,
                "hbm_peak_share": bytes_per_s / PEAK_BYTES_PER_S,
                "ref_batch": ref_b, "ref_us_cuda_f64": ref_us,
            })
    return rows


def _reproj_px(h: torch.Tensor, src: torch.Tensor, tar: torch.Tensor):
    """(max, median) over the batch of the float64 symmetric-transfer
    reprojection of each hypothesis on its own 4 points, in px."""
    r = torch.sqrt(residual2_fp64(h, src, tar))
    return r.max().item(), r.median().item()


def accuracy_check(batch: int = 1024, seed: int = 3) -> dict:
    """Every solver's float32 kernel against its K5 instance on one batch of
    exact float64 quads, both scored in float64 (``residual2_fp64``)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(seed)
    src, tar = random_quad_pairs(gen, batch, torch.float64)
    s64, t64 = to_soa(src), to_soa(tar)
    s32, t32 = s64.float(), t64.float()
    out = {}
    for name, solve in FP64_SOLVE_KERNELS.items():
        h32 = from_soa_h(SOLVE_KERNELS[name].kernel(s32, t32))
        h64 = from_soa_h(solve.kernel(s64, t64))
        max32, med32 = _reproj_px(h32, src, tar)
        max64, med64 = _reproj_px(h64, src, tar)
        out[name] = {"max_reproj_px_f32": max32, "median_reproj_px_f32": med32,
                     "max_reproj_px_fp64": max64,
                     "median_reproj_px_fp64": med64}
    return out


def ndlt_fp64_accuracy(batch: int = 2048, seed: int = 5) -> dict:
    """K5's NDLT against the eager float64 ``ndlt_fp64_h`` (the same chain):
    max reprojection of each, in float64."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(seed)
    src, tar = random_quad_pairs(gen, batch, torch.float64)
    h_k = from_soa_h(FP64_SOLVE_KERNELS["ndlt"].kernel(to_soa(src),
                                                       to_soa(tar)))
    h_e = ndlt_fp64_h(src, tar)  # up to scale; the residual ignores scale
    return {"max_reproj_px_kernel": _reproj_px(h_k, src, tar)[0],
            "max_reproj_px_eager": _reproj_px(h_e, src, tar)[0]}


def run(batches=DEFAULT_B, seed: int = 0) -> dict:
    """The table, the accuracy checks and the card they ran on."""
    return {"card": card_line(), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "rows": run_table(batches, seed),
            "accuracy": accuracy_check(),
            "ndlt_fp64_accuracy": ndlt_fp64_accuracy()}


def to_markdown(rows) -> str:
    lines = [
        "| solver | B | K5 µs | plain SoA µs | eager AoS µs | H/s | HBM share "
        "| ref CUDA fp64 µs (B) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['solver']} | {r['batch']} | {r['kernel_ms'] * 1e3:.2f} "
            f"| {r['plain_soa_ms'] * 1e3:.1f} | {r['eager_aos_ms'] * 1e3:.1f} "
            f"| {r['h_per_s']:.3e} | {r['hbm_peak_share']:.2f} "
            f"| {r['ref_us_cuda_f64']} ({r['ref_batch']}) |"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    """Console entry point: print the table; ``--out`` writes its JSON."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)

    result = run()
    print(f"card: {result['card']}")
    print(to_markdown(result["rows"]))
    print(json.dumps({"accuracy": result["accuracy"],
                      "ndlt_fp64_accuracy": result["ndlt_fp64_accuracy"]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
