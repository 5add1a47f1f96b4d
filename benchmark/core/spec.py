"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
its metrics are the entries of ``end_to_end`` and ``per_layer`` that apply to
it.  An end-to-end metric applies where its ``workloads`` list names the
cell, or everywhere without one.  A per-layer metric applies where its
``workloads`` list names the cell, or, without one, wherever the end-to-end
metric it ``moves`` applies.  Each file is found by the name alone:

* ``configs/<config>.json``: the configuration's sizes (the ``file`` entry);
* ``configs/<config>.py``: its driver, with a ``Cell`` class;
* ``traffic/<traffic>.json``: the traffic mix;
* ``e2e/<metric>.py`` and ``metrics/<metric>.py``: a ``read`` function each.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def load_spec(path: Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module called ``name``.

    Metric and configuration names hold dots and dashes, so their files are
    loaded by path, not by ``import``.
    """
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(spec: dict, workload: str) -> dict:
    """Everything one cell needs, by name: its entry, its configuration
    (entry and file), its traffic, and the metrics it reports."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    end_to_end = [m for m in spec["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return {
        "workload": cell,
        "config_entry": config,
        "config": load_json(ROOT / config["file"]),
        "driver": BENCH / "configs" / f"{config['name']}.py",
        "traffic": load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
        "end_to_end": end_to_end,
        "per_layer": per_layer,
    }


def reader(kind: str, name: str):
    """The ``read`` function of metric ``name``; ``kind`` is 'e2e' or
    'metrics'."""
    module = load_module(BENCH / kind / f"{name}.py",
                         f"benchmark_{kind}_{name.replace('.', '_')}")
    return module.read
