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

__all__ = ["ablation_solve", "computes_ndlt", "equal_nan", "launch_instance",
           "quad_batch", "run_ablation", "time_instances", "main"]


def computes_ndlt(tag: str) -> bool:
    """Whether instance ``tag`` computes K4-NDLT's own function (3 sweeps, 3
    solves) and must equal its plain version."""
    return not tag.startswith("regs_s") or tag.startswith("regs_s3_l3")


def launch_instance(symbol: str, src: Tensor, tar: Tensor,
                    dtype: torch.dtype) -> Tensor:
    """Launch the ablation library's solve ``symbol`` on CUDA (8, B) minimal
    sets of ``dtype``; (9, B) of the same type out.  Builds the library at
    its first call; counts nothing in ``LAUNCHES``."""
    check_soa(src, tar, (dtype,))
    if src.device.type != "cuda":
        raise ValueError("the ablation instances run on a CUDA device only")
    out = torch.empty((9, src.shape[1]), dtype=dtype, device=src.device)
    if src.shape[1] == 0:
        return out
    fn = getattr(load_ablation_library(), symbol)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), tar.data_ptr(), out.data_ptr(), src.shape[1],
                 stream)
    check_launch(err, symbol)
    return out


def ablation_solve(tag: str, src: Tensor, tar: Tensor) -> Tensor:
    """Launch ablation instance ``tag`` on CUDA (8, B) minimal sets: float32
    in and out, float64 in and out (h22 = 1) for an ``f64_`` instance."""
    if tag not in NDLT_ABLATIONS:
        raise ValueError(f"unknown ablation {tag!r}; one of {NDLT_ABLATIONS}")
    dtype = torch.float64 if tag.startswith("f64_") else torch.float32
    return launch_instance(f"sks_ndlt_abl_{tag}", src, tar, dtype)


def equal_nan(a: Tensor, b: Tensor) -> bool:
    """Equal value for value, a NaN where the other has one."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def time_instances(calls: dict, plain: dict, runs: int, reps: int) -> list[dict]:
    """Run every call of ``calls`` (tag -> function of no arguments giving a
    (9, B) tensor) once against the plain output of its element type
    (``plain``: dtype -> tensor), then time them in turns.

    Each of ``runs`` rounds times every call once (``reps`` launches between
    two events), the order reversed every other round.  One row a tag: its
    median ms, the quartiles and the least and largest sample (one sample in
    a run of several now and then reads a third longer: compare two
    instances by their quartiles), and whether its output equals the plain
    one.
    """
    rows = {}
    for tag, call in calls.items():
        out = call()
        torch.cuda.synchronize()
        rows[tag] = {"tag": tag, "batch": out.shape[1],
                     "dtype": str(out.dtype)[6:],
                     "equals_plain": equal_nan(out, plain[out.dtype]),
                     "samples": []}
    for r in range(runs):
        order = list(calls) if r % 2 == 0 else list(calls)[::-1]
        for tag in order:
            rows[tag]["samples"].append(device_ms(calls[tag], reps))
    for row in rows.values():
        samples = sorted(row.pop("samples"))
        q1, _, q3 = statistics.quantiles(samples, n=4, method="inclusive")
        row.update(ms=statistics.median(samples), ms_q1=q1, ms_q3=q3,
                   ms_min=samples[0], ms_max=samples[-1])
    return list(rows.values())


def quad_batch(batch: int, seed: int):
    """One batch of random quads as (8, B) pairs: float32 and float64 views
    of the same float64 draw."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    src, tar = random_quad_pairs(gen, batch, torch.float64)
    s64, t64 = to_soa(src), to_soa(tar)
    return (s64.float(), t64.float()), (s64, t64)


def run_ablation(batch: int = 1 << 20, runs: int = 7, reps: int = 5,
                 seed: int = 0) -> list[dict]:
    """Time every instance and the two shipped kernels on one batch
    (:func:`time_instances`); a row also says whether its instance computes
    the shipped function (``computes_ndlt``).  Raises without a card.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("run_ablation times CUDA kernels and needs a card")
    (s32, t32), (s64, t64) = quad_batch(batch, seed)
    k4, k5 = SOLVE_KERNELS["ndlt"], FP64_SOLVE_KERNELS["ndlt"]
    plain = {torch.float32: k4.plain(s32, t32), torch.float64: k5.plain(s64, t64)}
    calls = {"shipped": lambda: k4.kernel(s32, t32),
             "f64_shipped": lambda: k5.kernel(s64, t64)}
    for tag in NDLT_ABLATIONS:
        s, t = (s64, t64) if tag.startswith("f64_") else (s32, t32)
        calls[tag] = lambda tag=tag, s=s, t=t: ablation_solve(tag, s, t)
    rows = time_instances(calls, plain, runs, reps)
    for row in rows:
        row["computes_ndlt"] = ("shipped" in row["tag"]
                                or computes_ndlt(row["tag"]))
    return rows


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
