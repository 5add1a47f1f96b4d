"""Headline benchmark: batched ACA homographies/s on one CUDA card.

The counterpart of ``sks_tpu/bench/headline.py`` (the JAX package's
``bench.py``; the root ``bench.py`` stays the JAX package's).  Run from the
repository root on a machine with a CUDA card:

    python -m sks_tpu_torch.bench.headline [--out PATH]

It prints one JSON line: ``metric`` ``aca_homographies_per_sec_per_chip``,
``value`` (kernel K1, ``kernels.aca_cuda.aca_solve_soa``, at B = 2^20 in
float32, in device time through ``bench.harness.time_fn``), ``unit`` and
``vs_baseline`` against the reference's CUDA ACA at B = 1M, 245 µs a batch
on the paper's GPU (``BASELINE.md``, Table 8: ~4.08e9 H/s).  Beside it, at B
= 6 x 2^20 in float32 and with bfloat16 storage (the arithmetic stays
float32), the rate, the effective bandwidth and its fraction of the card's
memory rate: 100 B a hypothesis in float32, 50 B in bfloat16
(``utils.flops.bytes_per_hypothesis``: 16 values in, 9 out).

The memory rate is looked up by the card's name (``HBM_SPEC_GBPS``; an H100
SXM and an H100 PCIe differ by 1.7x); an unknown name gives null and no
fractions.  At B = 2^20 the working set is 100 MB, twice an H100's 50 MB of
L2, so each call streams from device memory: the JAX package's on-chip
(VMEM-resident) and inputs-only regimes of a TPU have no counterpart here and
are not carried over, nor is its chained-loop timing.
"""

from __future__ import annotations

import json

import torch

from sks_tpu_torch.bench.harness import time_fn
from sks_tpu_torch.kernels import aca_cuda as K
from sks_tpu_torch.utils.flops import bytes_per_hypothesis, roofline_hps
from sks_tpu_torch.utils.synth import random_quad_pairs

__all__ = ["BASELINE_H_PER_S", "HBM_SPEC_GBPS", "HEADLINE_B", "STREAM_B",
           "make_soa", "measure", "run", "main"]

#: The reference's CUDA ACA at B = 1M: 245 µs a batch (BASELINE.md).
BASELINE_H_PER_S = 1_000_000 / 245e-6

#: Device-memory rate by ``torch.cuda.get_device_name()``, GB/s, from
#: NVIDIA's data sheets.
HBM_SPEC_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,  # SXM5
    "NVIDIA H100 PCIe": 2000.0,
    "NVIDIA H100 NVL": 3900.0,
}

HEADLINE_B = 1 << 20
STREAM_B = 6 << 20


def make_soa(batch: int, dtype=torch.float32, device="cuda", seed: int = 0):
    """(src, tar) component-major ``(8, batch)`` minimal sets in ``dtype``,
    drawn on ``device`` in chunks of 2^20."""
    chunk = min(batch, HEADLINE_B)
    s, t = [], []
    for i in range(-(-batch // chunk)):
        g = torch.Generator(device=device).manual_seed(seed + i)
        src, tar = random_quad_pairs(g, min(chunk, batch - i * chunk))
        s.append(K.to_soa(src))
        t.append(K.to_soa(tar))
    return (torch.cat(s, dim=1).to(dtype).contiguous(),
            torch.cat(t, dim=1).to(dtype).contiguous())


def measure(batch: int, dtype=torch.float32, device="cuda",
            budget_s: float = 1.0) -> dict:
    """K1's homographies/s at ``batch`` in ``dtype`` storage."""
    s, t = make_soa(batch, dtype, device)
    res = time_fn(K.aca_solve_soa, s, t, budget_s=budget_s)
    return {"batch": batch, "dtype": str(dtype).removeprefix("torch."),
            "seconds_per_call": res.seconds_per_call,
            "iters": res.iters, "repeats": res.repeats,
            "compile_seconds": res.compile_seconds,
            "hps": res.throughput(batch)}


def run(device="cuda") -> dict:
    """The headline's fields (see the module docstring)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the headline times kernel K1 and needs a card")
    kind = torch.cuda.get_device_name(torch.device(device))
    spec = HBM_SPEC_GBPS.get(kind)
    head = measure(HEADLINE_B, torch.float32, device)
    f32 = measure(STREAM_B, torch.float32, device)
    bf16 = measure(STREAM_B, torch.bfloat16, device)
    hps = head["hps"]
    out = {
        "metric": "aca_homographies_per_sec_per_chip",
        "value": hps,
        "unit": "H/s",
        "vs_baseline": hps / BASELINE_H_PER_S,
        "device_kind": kind,
        "hbm_spec_gbps": spec,
        "batch": HEADLINE_B,
        "seconds_per_call": head["seconds_per_call"],
        "hps_b6m": f32["hps"],
        "hps_b6m_bf16": bf16["hps"],
        "timing": {"b1m": head, "b6m": f32, "b6m_bf16": bf16},
    }
    for suffix, row, width in (("", head, 4), ("_b6m", f32, 4),
                               ("_b6m_bf16", bf16, 2)):
        gbps = row["hps"] * bytes_per_hypothesis(width) / 1e9
        out[f"effective_gbps{suffix}"] = gbps
        if spec:
            out[f"roofline_fraction{suffix}"] = gbps / spec
    if spec:
        out["roofline_hps_hbm"] = roofline_hps(spec)
        out["roofline_hps_hbm_bf16"] = roofline_hps(spec, dtype_bytes=2)
    return out


def main(argv=None) -> dict:
    """Console entry point: print the headline's JSON line; ``--out``
    writes it to a file too."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON output path")
    args = ap.parse_args(argv)
    out = run()
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
