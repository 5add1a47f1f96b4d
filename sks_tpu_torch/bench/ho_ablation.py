"""What sets K4-HO's and K5-ho's time: ablation instances on the card.

``csrc/ablation/ho_*.cu`` builds the HO solve in forms that differ from the
shipped kernels in one thing each (how many Jacobi sweeps, unrolled or as a
loop, how the rotation's cosine and its division are computed, the block
size, a register cap, the float32 seed and the float64 solves of K5-ho
apart), in the library of
timing instruments that is compiled when one of them is first launched
(``csrc/ablation/ablation.cuh`` lists them).  This module launches them on
one batch, float32 and float64, and times each beside the shipped kernels,
in turns, in device time; the forms the kernels had before their redesign
(``before``, ``f64_before``) and the shipped ones are also timed at small batches.
The instances that compute HO are held value for value to the plain version
of the shipped kernel of their precision; the others compute other
functions and are only timed.  No path of the package launches any of them,
and their launches are not counted in ``LAUNCHES``.

:func:`angle_check` holds the rotation's hand-written square root and
reciprocal (``csrc/baselines.cuh``) against the IEEE ones on every float32
of their argument range, and its division of tiny numerators on 2^28 pairs.

Run on a machine with a CUDA card, from the repository root:

    python -m sks_tpu_torch.bench.ho_ablation [--batch B] [--sass]
"""

from __future__ import annotations

import json
import re

import numpy as np
import torch
from torch import Tensor

from sks_tpu_torch.bench import sass
from sks_tpu_torch.bench.ndlt_ablation import (
    launch_instance,
    quad_batch,
    time_instances,
)
from sks_tpu_torch.bench.table8 import card_line
from sks_tpu_torch.kernels import FP64_SOLVE_KERNELS, SOLVE_KERNELS, _build
from sks_tpu_torch.kernels._build import HO_ABLATIONS, load_ablation_library
from sks_tpu_torch.kernels._soa import check_launch

__all__ = ["ablation_solve", "angle_check", "angle_check_values",
           "computes_ho", "jacobi_sweeps", "run_ablation", "sass_report",
           "main"]

#: What marks a tag whose instance computes another function than HO.
_NOT_HO = ("noeig", "approx", "seed_only", "refine_only")


def computes_ho(tag: str) -> bool:
    """Whether instance ``tag`` computes the shipped kernel's own function
    (K4-HO: 10 correctly rounded sweeps; K5-ho: the 4-sweep seed and the two
    float64 solves) and must equal its plain version."""
    sweeps = re.search(r"_s(\d+)$", tag)
    if sweeps:
        return int(sweeps.group(1)) == 10
    return not any(word in tag for word in _NOT_HO)


def ablation_solve(tag: str, src: Tensor, tar: Tensor) -> Tensor:
    """Launch ablation instance ``tag`` on CUDA (8, B) minimal sets: float32
    in and out, float64 in and out (h22 = 1) for an ``f64_`` instance."""
    if tag not in HO_ABLATIONS:
        raise ValueError(f"unknown ablation {tag!r}; one of {HO_ABLATIONS}")
    dtype = torch.float64 if tag.startswith("f64_") else torch.float32
    return launch_instance(f"sks_ho_abl_{tag}", src, tar, dtype)


def run_ablation(batch: int = 1 << 20, runs: int = 7, reps: int = 5,
                 seed: int = 0, small_batches=(10_000, 1)) -> list[dict]:
    """Time every instance and the two shipped kernels on one batch
    (``ndlt_ablation.time_instances``: median, quartiles, least and largest
    sample, equal to the plain version or not); a row also says whether its instance
    computes HO (``computes_ho``).  Then, at each of ``small_batches``, the
    shipped kernels beside the forms they had before (``before``, ``f64_before``).
    Raises without a card.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("run_ablation times CUDA kernels and needs a card")
    k4, k5 = SOLVE_KERNELS["ho"], FP64_SOLVE_KERNELS["ho"]
    rows = []
    for b in (batch, *small_batches):
        (s32, t32), (s64, t64) = quad_batch(b, seed)
        plain = {torch.float32: k4.plain(s32, t32),
                 torch.float64: k5.plain(s64, t64)}
        calls = {"shipped": lambda s=s32, t=t32: k4.kernel(s, t),
                 "f64_shipped": lambda s=s64, t=t64: k5.kernel(s, t)}
        for tag in HO_ABLATIONS if b == batch else ("before", "f64_before"):
            s, t = (s64, t64) if tag.startswith("f64_") else (s32, t32)
            calls[tag] = lambda tag=tag, s=s, t=t: ablation_solve(tag, s, t)
        rows += time_instances(calls, plain, runs,
                               reps if b == batch else 10)
    for row in rows:
        row["computes_ho"] = "shipped" in row["tag"] or computes_ho(row["tag"])
    return rows


def jacobi_sweeps(kernel: str) -> int:
    """The Jacobi sweeps of the HO kernel with mangled name ``kernel``: the
    trips of its sweep loop where it has one (K4-HO 10, K5-ho's seed 4, an
    instrument what its name says)."""
    explicit = re.search(r"AblationJacobiF32ILi(\d+)E", kernel)
    if explicit:
        return int(explicit.group(1))
    return 4 if "Invit64" in kernel else 10


def sass_report() -> list[dict]:
    """SASS counts (``bench/sass.kernel_summary``) of every HO kernel of the
    kernel library and of the instruments: instructions on a thread's
    straight path with the sweep loop run as often as the kernel runs it,
    its ``MUFU`` instructions, branches and calls, and the instruction-rate limit of
    2^20 threads.  Builds either library if it is not built yet."""
    _build.load_library()
    load_ablation_library()
    rows = []
    for library in ("kernels", "ablation"):
        for row in sass.kernel_summary(_build.library_path(library),
                                       ("HoCore",), jacobi_sweeps):
            rows.append({"library": library, **row})
    return rows


def angle_check_values(seed: int = 0) -> np.ndarray:
    """The float32 values whose triples (app, aqq, apq) the rotation is
    checked on: zeros, the smallest and largest normals and a subnormal,
    values whose squares underflow or overflow, infinities, NaN, and 24
    seeded values spread over 1e-30 .. 1e30, each with both signs."""
    tiny, big = np.finfo(np.float32).tiny, np.finfo(np.float32).max
    rng = np.random.default_rng(seed)
    spread = 10.0 ** rng.uniform(-30.0, 30.0, 24)
    mags = np.concatenate([[0.0, 1e-45, tiny, 1e-30, 1e-20, 1e-19, 1.0, 1.5,
                            1e18, 1e19, 1e20, big, np.inf], spread])
    return np.concatenate([mags, -mags, [np.nan]]).astype(np.float32)


def angle_check(seed: int = 0) -> dict:
    """Hold the Jacobi rotation's short forms (``csrc/baselines.cuh``) against
    the IEEE ones, on the card: ``sqrt_1to2`` and ``rcp_1to2`` against
    ``sqrtf`` and ``1.0f / x`` on every float32 of [1, 2] and on NaN;
    ``DivTiny`` and the divisions through float64 against ``num / den`` on
    2^28 pairs (arbitrary bit patterns, tiny and subnormal numerators,
    powers of two below them);
    the shipped rotations against the rotation as the plain version writes
    it on every triple of :func:`angle_check_values`.  Returns the counts of
    arguments checked and of mismatches (each must be 0)."""
    if not torch.cuda.is_available():
        raise RuntimeError("angle_check runs CUDA kernels and needs a card")
    dev = torch.device("cuda", torch.cuda.current_device())
    values = torch.from_numpy(angle_check_values(seed)).to(dev)
    # int64 holds the kernel's unsigned 64-bit counts bit for bit.
    counts = torch.zeros(5, dtype=torch.int64, device=dev)
    lib = load_ablation_library()
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.sks_ho_abl_angle_check(values.data_ptr(), values.numel(),
                                     counts.data_ptr(), stream)
    check_launch(err, "sks_ho_abl_angle_check")
    sqrt_bad, rcp_bad, div_bad, angle_bad, subnormal = counts.tolist()
    return {"unit_range_arguments": (1 << 23) + 2,
            "sqrt_mismatches": sqrt_bad, "rcp_mismatches": rcp_bad,
            "division_pairs": 1 << 28, "division_mismatches": div_bad,
            "subnormal_quotients": subnormal,
            "angle_triples": values.numel() ** 3,
            "angle_mismatches": angle_bad}


def main(argv=None) -> None:
    """Console entry point: the check, then one JSON line per instance."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1 << 20)
    ap.add_argument("--sass", action="store_true",
                    help="also print the HO kernels' SASS counts")
    args = ap.parse_args(argv)
    print(f"card: {card_line()}")
    print(json.dumps({"angle_check": angle_check()}))
    for row in run_ablation(args.batch):
        print(json.dumps(row))
    if args.sass:
        for row in sass_report():
            print(json.dumps(row))


if __name__ == "__main__":
    main()
