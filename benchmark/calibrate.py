"""The readings the limits of a cell are set from, on many seeds in one
process: the program's, and the control's.

    python3 benchmark/calibrate.py --workload NAME --seeds S0 S1 ... \
        [--sides program control] [--call '{"bf16_hypotheses": true}']

For each seed the cell is set up as a run sets it up (its requests drawn
from the seed; the warm-up only for the first seed), and the traffic's
``check_sample`` distinct requests are answered and compared with the plain
reference as a run compares them.  Side ``program`` answers with the
program; side ``control`` puts the reference, computed in bfloat16 (the
nearest precision below the configuration's float32), in the program's
place.  ``--call`` merges keyword arguments into the traffic's ``call`` (a
fit cell's program path of its own, such as ``bf16_hypotheses``).  Prints
one JSON line per seed and side: the largest of each number over the
requests, the time the answers and the check took.  Not run by the
benchmark's runs; it needs a CUDA card, or ``--device cpu`` for a rehearsal
at the configuration's size on the host.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, side: str) -> dict:
    """Serve the sample, compare, and return the worst of each number."""
    import torch

    n = int(cell.traffic["check_sample"])
    t0 = time.perf_counter()
    if side == "control":
        answers = [cell.control(i) for i in range(n)]
    else:
        answers = [cell.request(i) for i in range(n)]
    if cell.device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    out: dict = {}
    for i in cell.sample(n):
        for name, value in cell.compare(answers[i], cell.reference(i)).items():
            pick = min if name.endswith("_min") else max
            out[name] = pick(out.get(name, value), value)
    out = {k: (v if math.isfinite(v) else "inf") for k, v in out.items()}
    out.update(requests=n, answer_s=t1 - t0,
               check_s=time.perf_counter() - t1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sides", nargs="+", default=["program", "control"])
    ap.add_argument("--call", default="{}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark.core import spec as spec_mod

    cell_spec = spec_mod.resolve(spec_mod.load_spec(), args.workload)
    traffic = dict(cell_spec["traffic"])
    traffic["call"] = {**traffic.get("call", {}), **json.loads(args.call)}
    driver = spec_mod.load_module(cell_spec["driver"], "benchmark_driver")
    for k, seed in enumerate(args.seeds):
        cell = driver.Cell(cell_spec["config"],
                           {**traffic, "warmup": traffic["warmup"] if k == 0
                            else 0},
                           seed, torch.device(args.device))
        cell.setup()
        for side in args.sides:
            line = {"workload": args.workload, "seed": seed, "side": side,
                    "call": json.loads(args.call)}
            line.update(readings(cell, side))
            print(json.dumps(line), flush=True)
        cell.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
