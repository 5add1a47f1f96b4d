"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names present."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH = ROOT / "benchmark"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_paths_and_command():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
        assert not p.endswith("_torch")
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    files = [w for w in cmd if "/" in w or w.endswith(".py")]
    for w in files:
        assert not w.startswith("/") and ".." not in w
        assert any(w == p or w.startswith(p + "/") for p in SPEC["paths"])
        assert (ROOT / w).is_file()


def test_run_seconds_fits_twenty_four_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        assert (BENCH / "configs" / f"{c['name']}.py").is_file()


def test_workloads():
    assert 1 <= len(SPEC["workloads"]) <= 24
    pairs = set()
    configs = {c["name"] for c in SPEC["configs"]}
    four = 0
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert traffic["config"] == w["config"]
        assert traffic["limits"]
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_end_to_end_metrics():
    e2e = SPEC["end_to_end"]
    assert 1 <= len(e2e) <= 16
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (BENCH / "e2e" / f"{m['name']}.py").is_file()


def _reports(cell: str) -> set:
    return {m["name"] for m in SPEC["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}


def test_per_layer_metrics():
    per = SPEC["per_layer"]
    assert 1 <= len(per) <= 128
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and _line(m["layer"])
        for cell in m.get("workloads", cells):
            assert cell in cells and m["moves"] in _reports(cell)
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        e2e = _reports(w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in SPEC["per_layer"])


def test_layer_names_match_the_modules_they_name():
    """One layer, one name: metrics that share a layer give it letter for
    letter, so no two names differ only by a typo."""
    layers = {m["layer"] for m in SPEC["per_layer"]}
    folded = {re.sub(r"\W", "", name.lower()) for name in layers}
    assert len(folded) == len(layers)
