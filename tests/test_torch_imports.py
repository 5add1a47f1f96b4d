"""The port imports neither JAX nor the JAX package.

Every module of ``sks_tpu_torch/``, ``chip_smoke.py`` and the gloo ranks'
program ``tests/torch_ranks.py`` is parsed with
``ast``; any ``import`` or ``from ... import`` of ``jax``, ``flax``,
``optax``, ``orbax`` or ``sks_tpu`` (a module of that name or under it) fails
the test, wherever it stands in the file (a function body included).
``sks_tpu_torch`` itself is allowed.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "orbax", "sks_tpu")
FILES = sorted(str(p.relative_to(ROOT))
               for p in (ROOT / "sks_tpu_torch").rglob("*.py")) + [
                   "chip_smoke.py", "tests/torch_ranks.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def imported_modules(source: str) -> list[str]:
    """Every module an ``import`` or ``from`` statement of ``source`` names
    (relative imports name the package they stand in, so are left out)."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
    return out


@pytest.mark.parametrize("path", FILES)
def test_the_port_imports_no_jax(path):
    bad = [m for m in imported_modules((ROOT / path).read_text())
           if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_the_rule_catches_what_it_must():
    src = ("import jax.numpy as jnp\nfrom sks_tpu.ops import aca\n"
           "def f():\n    import flax.linen\n    from optax import adam\n"
           "import orbax\nimport sks_tpu_torch.ops\nfrom sks_tpu_torch import x\n"
           "import jaxlib_like_name\n")
    bad = [m for m in imported_modules(src) if _forbidden(m)]
    assert sorted(bad) == ["flax.linen", "jax.numpy", "optax", "orbax",
                           "sks_tpu.ops"]
    assert len(FILES) > 50 and "sks_tpu_torch/bench/real_pipeline.py" in FILES
