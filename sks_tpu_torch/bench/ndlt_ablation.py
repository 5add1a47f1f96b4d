"""What sets K4-NDLT's and K5-ndlt's time: ablation instances on the card.

``csrc/ablation/*.cu`` builds the NDLT solve in forms that differ from the
shipped kernels in one thing each (seed sweeps, solves, a register cap,
where the Jacobi seed keeps its eigenvector matrix, whether its sweeps are
unrolled, whether the normal matrix is rebuilt after the seed), as a library
of its own that is compiled when this module first launches one of them.
This module launches them on one batch (float32, and float64 for the ``f64_`` instances
of K5-ndlt) and times each beside the shipped kernels, in turns, in device
time.  The instances with 3 sweeps and 3 solves compute the shipped function
and are held bit-equal to its plain version; the others compute other
functions and are only timed.  No path of the package launches any of them,
and their launches are not counted in ``LAUNCHES``.

Run on a machine with a CUDA card, from the repository root:

    python -m sks_tpu_torch.bench.ndlt_ablation [--batch B]
"""

from __future__ import annotations

import json
import statistics

import torch
from torch import Tensor

from sks_tpu_torch.bench.table8 import card_line, device_ms
from sks_tpu_torch.kernels import FP64_SOLVE_KERNELS, SOLVE_KERNELS, to_soa
from sks_tpu_torch.kernels._build import NDLT_ABLATIONS, load_ablation_library
from sks_tpu_torch.kernels._soa import check_launch, check_soa
from sks_tpu_torch.utils.synth import random_quad_pairs

__all__ = ["ablation_solve", "computes_ndlt", "run_ablation", "main"]


def computes_ndlt(tag: str) -> bool:
    """Whether instance ``tag`` computes K4-NDLT's own function (3 sweeps, 3
    solves) and must equal its plain version."""
    return not tag.startswith("regs_s") or tag.startswith("regs_s3_l3")


def ablation_solve(tag: str, src: Tensor, tar: Tensor) -> Tensor:
    """Launch ablation instance ``tag`` on CUDA (8, B) minimal sets: float32
    in and out, float64 in and out (h22 = 1) for an ``f64_`` instance."""
    if tag not in NDLT_ABLATIONS:
        raise ValueError(f"unknown ablation {tag!r}; one of {NDLT_ABLATIONS}")
    dtype = torch.float64 if tag.startswith("f64_") else torch.float32
    check_soa(src, tar, (dtype,))
    if src.device.type != "cuda":
        raise ValueError("the ablation instances run on a CUDA device only")
    out = torch.empty((9, src.shape[1]), dtype=dtype, device=src.device)
    if src.shape[1] == 0:
        return out
    fn = getattr(load_ablation_library(), f"sks_ndlt_abl_{tag}")
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), tar.data_ptr(), out.data_ptr(), src.shape[1],
                 stream)
    check_launch(err, f"ndlt ablation {tag}")
    return out


def _equal_nan(a: Tensor, b: Tensor) -> bool:
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def run_ablation(batch: int = 1 << 20, runs: int = 7, reps: int = 5,
                 seed: int = 0) -> list[dict]:
    """Time every instance and the two shipped kernels on one batch.

    Each of ``runs`` rounds times every instance once (``reps`` launches
    between two events), the order reversed every other round; the median
    per instance is reported, with whether its output equals the plain
    version of the shipped kernel of its precision.  Raises without a card.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("run_ablation times CUDA kernels and needs a card")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    src, tar = random_quad_pairs(gen, batch, torch.float64)
    s64, t64 = to_soa(src), to_soa(tar)
    s32, t32 = s64.float(), t64.float()
    k4, k5 = SOLVE_KERNELS["ndlt"], FP64_SOLVE_KERNELS["ndlt"]
    plain = {torch.float32: k4.plain(s32, t32), torch.float64: k5.plain(s64, t64)}
    calls = {"shipped": lambda: k4.kernel(s32, t32),
             "f64_shipped": lambda: k5.kernel(s64, t64)}
    for tag in NDLT_ABLATIONS:
        s, t = (s64, t64) if tag.startswith("f64_") else (s32, t32)
        calls[tag] = lambda tag=tag, s=s, t=t: ablation_solve(tag, s, t)
    rows = {}
    for tag, call in calls.items():
        out = call()
        torch.cuda.synchronize()
        rows[tag] = {"tag": tag, "batch": batch, "dtype": str(out.dtype)[6:],
                     "computes_ndlt": "shipped" in tag or computes_ndlt(tag),
                     "equals_plain": _equal_nan(out, plain[out.dtype]),
                     "samples": []}
    for r in range(runs):
        order = list(calls) if r % 2 == 0 else list(calls)[::-1]
        for tag in order:
            rows[tag]["samples"].append(device_ms(calls[tag], reps))
    for row in rows.values():
        row["ms"] = statistics.median(row.pop("samples"))
    return list(rows.values())


def main(argv=None) -> None:
    """Console entry point: print one JSON line per instance."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1 << 20)
    args = ap.parse_args(argv)
    print(f"card: {card_line()}")
    for row in run_ablation(args.batch):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
