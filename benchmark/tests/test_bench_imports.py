"""What the benchmark imports, and the frozen count of its yardstick."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "sks_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (absolute imports;
    relative ones stay inside the benchmark)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(*parts):
    return sorted(p for p in BENCH.joinpath(*parts).rglob("*.py")
                  if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    """Compared by whole top-level name: ``sks_tpu_torch`` is the port,
    ``sks_tpu`` the JAX package."""
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", _sources("core"), ids=lambda p: p.name)
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "sks_tpu_torch" not in _imports(path)


def test_a_run_loads_no_jax():
    """A whole run of a cell, on the CPU at a small size, leaves no module of
    JAX or of the JAX package in the process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import run\n"
        "run.run_cell('fit-n2000.o50', 3, 0.0, False, device='cpu',\n"
        "    overrides={'config': {'n_points': 100, 'max_iters': 128},\n"
        "               'traffic': {'pool': 2, 'warmup': 0,\n"
        "                           'check_sample': 1,\n"
        "                           'ref_hypotheses': 512}},\n"
        "    log=lambda line: None)\n"
        "print(run.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("n", [384, 2000])
def test_frozen_k2_count_is_the_plain_versions(n):
    """The count frozen in ``core/roofline.py`` is today's count of K2's
    plain version, by ``sks_tpu_torch/bench/roofline.score_ops``."""
    from benchmark.core import roofline
    from sks_tpu_torch.bench.roofline import score_ops
    from sks_tpu_torch.kernels.aca_cuda import aca_solve_score_soa_plain

    per_hyp, per_pair = score_ops(aca_solve_score_soa_plain, "inliers")
    counted = per_hyp.get("float32", 0) + n * per_pair["float32"]
    assert roofline.k2_ops(1, 1, n) == counted
    assert roofline.k2_ops(15, 1024, n) == 15 * 1024 * counted
