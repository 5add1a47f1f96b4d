"""CPU latency table: the reference's Table 5 configuration.

Port of ``sks_tpu/bench/cpu_table.py``: the mean time of one 4-point solve
on one core, a cache-hot loop over one set (the shape of the reference's
``imgs/CPU-runtime.png``, ``BASELINE.md``), for all six solvers in float32
and float64 through the repository's native C++ loop
(``sks_tpu_torch.native``), and, as a cross-check, the per-solve cost of the
port's batched PyTorch solvers on CPU tensors for the linear-algebra
baselines (where the JAX package reports its JAX-on-CPU cost).

Run:  python -m sks_tpu_torch.bench.cpu_table [--iters N] [--batch B]
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["REFERENCE_US", "cpu_table"]

#: The reference's Table 5 at /O2, microseconds a solve (BASELINE.md).
REFERENCE_US = {
    ("aca", "f32"): 0.0145,
    ("aca", "f64"): 0.0171,
    ("sks", "f32"): 0.0252,
    ("sks", "f64"): 0.0256,
    ("rho_ge", "f32"): 0.0287,
    ("gpt_lu", "f64"): 0.732,
    ("ho", "f64"): 12.2,
    ("ndlt", "f64"): 12.5,
}

#: Native kernel name -> the roster's solver name.
NATIVE_NAMES = {"aca": "aca", "sks": "sks", "ge": "rho_ge", "gpt": "gpt_lu",
                "ho": "ho", "ndlt": "ndlt"}


def cpu_table(iters: int = 2_000_000, batch: int = 4096,
              repeats: int = 3) -> dict:
    """{(solver, dtype): {'us', 'ref_us', 'mode'}}.

    Native rows ('native-hot-loop'): the best of ``repeats`` runs of
    ``iters`` solves (a tenth for HO and GPT and a hundredth for NDLT, as
    the JAX package scales them, at least 10,000) on one 4-point set of the
    fixture's matches.  PyTorch rows ('torch-cpu-batched', dtype key
    'f32/torch'): one call of the port's float32 solver on ``batch`` random
    quads, the mean of 20 after a warm-up, over ``batch``.
    """
    from sks_tpu_torch import native
    from sks_tpu_torch.data.fixture import load_correspondences
    from sks_tpu_torch.ops import SOLVERS_H
    from sks_tpu_torch.utils.synth import random_quad_pairs

    src_all, tar_all = load_correspondences()
    idx = np.random.default_rng(3).choice(len(src_all), 4, replace=False)
    src4 = np.asarray(src_all, np.float64)[idx]
    tar4 = np.asarray(tar_all, np.float64)[idx]
    out = {}
    for alg, name in NATIVE_NAMES.items():
        scale = {"ho": 10, "ndlt": 100, "gpt": 10}.get(alg, 1)
        for dt, npdt in (("f32", np.float32), ("f64", np.float64)):
            ns = min(native.bench_hot_loop(alg, src4.astype(npdt),
                                           tar4.astype(npdt),
                                           max(iters // scale, 10_000))
                     for _ in range(repeats))
            out[(name, dt)] = {"us": ns / 1e3,
                               "ref_us": REFERENCE_US.get((name, dt)),
                               "mode": "native-hot-loop"}

    src, tar = random_quad_pairs(torch.Generator().manual_seed(0), batch)
    for name in ("rho_ge", "gpt_lu", "ho", "ndlt"):
        fn = SOLVERS_H[name]
        fn(src, tar)
        t0 = time.perf_counter()
        reps = 20
        for _ in range(reps):
            fn(src, tar)
        per = (time.perf_counter() - t0) / reps / batch
        out[(name, "f32/torch")] = {
            "us": per * 1e6,
            "ref_us": REFERENCE_US.get((name, "f32" if name == "rho_ge"
                                        else "f64")),
            "mode": "torch-cpu-batched"}
    return out


def main(argv=None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=2_000_000)
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args(argv)
    table = cpu_table(args.iters, args.batch)
    print(f"{'solver':10} {'dtype':9} {'us/solve':>10} {'ref us':>8}  mode")
    for (alg, dt), row in sorted(table.items()):
        ref = f"{row['ref_us']:.4f}" if row["ref_us"] else "-"
        print(f"{alg:10} {dt:9} {row['us']:10.4f} {ref:>8}  {row['mode']}")
    return table


if __name__ == "__main__":
    main()
