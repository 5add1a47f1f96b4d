"""The benchmark of ``sks_tpu_torch`` on an NVIDIA H100: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout, with nothing installed: the checkout's root
goes on ``sys.path``, so ``sks_tpu_torch`` and ``benchmark`` are imported
from it.  The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; both are found by name (``core/spec.py``).

A run: set-up (the configuration's driver draws the requests from the seed
on the card, imports the program, warms it up on requests of its own), then
the window, then the check.  With ``--trace 0`` the window serves requests
in a closed loop, one after the other, from its start until ``--seconds``
have passed, and ends when the request running then ends; each request is
timed on the host clock, and the cell's end-to-end metrics are read from
those times (``e2e/<metric>.py``).  With ``--trace 1`` the window serves the
traffic's ``trace_requests`` requests under ``torch.profiler``, and the
cell's per-layer metrics are read from the trace (``metrics/<metric>.py``).
Either way the answers of a sample of the requests, drawn from the seed,
are then compared with the plain reference's, each number against its limit
(the traffic's ``limits``), and ``correct`` says whether every one held.

The last line of standard output is the result as one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
A run prints no result, and exits with another code than 0, where there is
no CUDA card or fewer than the cell asks for, where the program cannot be
imported, or where the process holds a module of JAX or of the JAX package
(``sks_tpu``) once the window has closed.
"""

from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Top-level module names that must not be loaded, compared whole: the port
#: (``sks_tpu_torch``) is not the JAX package (``sks_tpu``).
FORBIDDEN = ("jax", "jaxlib", "flax", "sks_tpu")

#: Build and kernel caches, at fixed paths inside the checkout.
CACHES = {"TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions",
          "TRITON_CACHE_DIR": ".bench_cache/triton"}
#: One host thread for the CPU's own operators: the timed path is the
#: Python thread that launches the card's work, and idle pool threads only
#: contend with it on a shared host.
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _finite(x: float) -> float:
    """A number JSON can carry: a reading that is not finite becomes 1e300
    (it fails every limit)."""
    return x if math.isfinite(x) else 1e300


def _serve(cell, i: int, answers: list, errors: list) -> None:
    """Serve request ``i``; a request that raises is counted as failed, its
    answer None."""
    try:
        answers.append(cell.request(i))
    except Exception as exc:
        answers.append(None)
        errors.append(f"request {i}: {exc!r}")


def timed_window(cell, seconds: float) -> dict:
    """Serve requests one after the other until ``seconds`` have passed."""
    latencies, answers, errors = [], [], []
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        _serve(cell, i, answers, errors)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        i += 1
        if t1 - start >= seconds:
            break
    return {"latencies_s": latencies, "answers": answers, "errors": errors,
            "window_s": t1 - start,
            "units": sum(cell.units(a) for a in answers if a is not None)}


def traced_window(cell, count: int, device) -> tuple[dict, object]:
    """Serve ``count`` requests under ``torch.profiler``; returns the window
    and the trace's raw events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.core.trace import WINDOW

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    answers, errors = [], []
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            start = time.perf_counter()
            for i in range(count):
                _serve(cell, i, answers, errors)
            if device.type == "cuda":
                torch.cuda.synchronize()
            window_s = time.perf_counter() - start
    window = {"answers": answers, "errors": errors, "window_s": window_s,
              "units": sum(cell.units(a) for a in answers if a is not None)}
    return window, prof.profiler.kineto_results.events()


def check(cell, answers: list, limits: dict, sample_size: int):
    """Compare a sample of the answers with the reference: (checks, info,
    correct).  ``checks`` maps each number compared to its value and limit;
    ``info`` holds the readings that are not compared."""
    idx = [i for i in cell.sample(len(answers)) if answers[i] is not None]
    worst, info = {}, {}
    for i in idx:
        for name, value in cell.compare(answers[i], cell.reference(i)).items():
            if name in limits:
                worst[name] = max(worst.get(name, -math.inf), value)
            elif name.endswith("_min"):
                info[name] = min(info.get(name, math.inf), value)
            else:
                info[name] = max(info.get(name, -math.inf), value)
    need = max(1, min(sample_size, len(answers)))
    checks = {"requests_checked": {"value": len(idx), "limit": need}}
    correct = len(idx) >= need and all(a is not None for a in answers)
    for name, limit in limits.items():
        value = worst.get(name, math.inf)
        checks[name] = {"value": _finite(value), "limit": limit}
        correct = correct and value <= limit
    return checks, info, correct


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", overrides: dict | None = None, log=None) -> dict:
    """One run of a cell; returns the result object.  ``overrides`` maps
    'config' and 'traffic' to entries that replace the files' (the CPU
    tests run a cell at a small size so)."""
    import torch

    from benchmark.core import spec as spec_mod

    log = log or (lambda line: print(line, file=sys.stderr))
    device = torch.device(device)
    cell_spec = spec_mod.resolve(spec_mod.load_spec(), workload)
    config = {**cell_spec["config"], **(overrides or {}).get("config", {})}
    traffic = {**cell_spec["traffic"], **(overrides or {}).get("traffic", {})}
    driver = spec_mod.load_module(cell_spec["driver"], "benchmark_driver")
    cell = driver.Cell(config, traffic, seed, device)
    cell.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - _STARTED

    events = None
    if trace:
        window, events = traced_window(cell, int(traffic["trace_requests"]),
                                       device)
    else:
        window = timed_window(cell, seconds)
    window["setup_s"] = setup_s
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    metrics, breakdown, dev = {}, None, {}
    if trace:
        from benchmark.core.trace import TraceView

        view = TraceView(events)
        run = {"requests": len(window["answers"]), "units": window["units"],
               "config": config, "traffic": traffic}
        for m in cell_spec["per_layer"]:
            value = spec_mod.reader("metrics", m["name"])(view, run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"busy_s": view.busy_s, "window_s": view.window_s}
        breakdown = {"device_ops": view.device_ops(),
                     "idle_gaps": view.idle_gaps()}
        del view, events
    else:
        for m in cell_spec["end_to_end"]:
            value = spec_mod.reader("e2e", m["name"])(window)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    cell.release()
    checks, info, correct = check(cell, window["answers"], traffic["limits"],
                                  int(traffic["check_sample"]))
    for line in window["errors"]:
        log(f"failed {line}")
    for name, value in info.items():
        log(f"info {name}: {value!r}")

    result = {
        "correct": bool(correct),
        "attempted": len(window["answers"]),
        "failed": len(window["errors"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else device.type),
            "count": int(cell_spec["workload"]["chips"]),
            "memory_peak_bytes": int(peak),
            **dev,
        },
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for name, rel in CACHES.items():
        os.environ[name] = str(ROOT / rel)
    os.environ.update(THREADS)

    import torch

    torch.set_num_threads(1)

    from benchmark.core import spec as spec_mod

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    chips = int(spec_mod.resolve(spec_mod.load_spec(),
                                 args.workload)["workload"]["chips"])
    if torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} cards and there are "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the process holds {bad}: the benchmark must not load JAX or "
              "the JAX package", file=sys.stderr)
        return 3
    checks = result["checks"]
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
