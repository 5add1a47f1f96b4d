"""The port's native CPU layer: ``sks_tpu_torch.native`` (its own ctypes
wrapper of ``native/src/sks_native.cpp``, built with g++ into
``sks_tpu_torch/_build/``) and ``bench/cpu_table.py``.

Each native float32 solver against the port's eager solver on the same
quads (the JAX package's ``tests/test_native.py`` holds them to JAX's), the
reader on a written file, the hot loop, and the Table-5 rows.  Skipped where
there is no C++ compiler.  Nothing here builds or writes under ``native/``.
"""

import numpy as np
import pytest
import torch

from torch_parity import fro, quads

from sks_tpu.bench.cpu_table import REFERENCE_US as JAX_REFERENCE_US

from sks_tpu_torch import native
from sks_tpu_torch.bench import cpu_table
from sks_tpu_torch.ops import SOLVERS_H

T = torch.from_numpy
ROSTER = {"aca": "aca", "sks": "sks", "ge": "rho_ge", "gpt": "gpt_lu",
          "ho": "ho", "ndlt": "ndlt"}


@pytest.fixture(autouse=True)
def _compiler():
    if not native.available():
        pytest.skip("no C++ compiler to build the native library")


@pytest.mark.parametrize("alg", list(ROSTER))
def test_native_float32_solvers_match_the_port(alg):
    src, tar = quads(7, 64)
    h = native.solve_batch(alg, src, tar)
    assert h.dtype == np.float32 and h.shape == (64, 3, 3)
    want = SOLVERS_H[ROSTER[alg]](T(src), T(tar)).numpy()
    np.testing.assert_allclose(fro(h), fro(want), atol=2e-3)


def test_aca_and_sks_batches_are_the_named_solves():
    src, tar = quads(8, 16, np.float64)
    np.testing.assert_array_equal(native.aca_batch(src, tar),
                                  native.solve_batch("aca", src, tar))
    np.testing.assert_array_equal(native.sks_batch(src, tar, False),
                                  native.solve_batch("sks", src, tar, False))
    with pytest.raises(ValueError, match="alg must be one of"):
        native.solve_batch("dlt", src, tar)
    with pytest.raises(TypeError, match="float32 or float64"):
        native.solve_batch("aca", src.astype(np.float16),
                           tar.astype(np.float16))


def test_read_points_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 640, (50, 2))
    tar = rng.uniform(0, 480, (50, 2))
    path = tmp_path / "pts.txt"
    path.write_text(f"{len(src)}\n" + "".join(
        f"{a:.6f} {b:.6f} {c:.6f} {d:.6f}\n"
        for (a, b), (c, d) in zip(src, tar)))
    s2, t2 = native.read_points(path)
    np.testing.assert_allclose(s2, src, atol=1e-5)
    np.testing.assert_allclose(t2, tar, atol=1e-5)
    with pytest.raises(OSError):
        native.read_points(tmp_path / "absent.txt")


def test_cpu_table_rows():
    table = cpu_table.cpu_table(iters=20_000, batch=64, repeats=1)
    want = {(name, dt) for name in ROSTER.values() for dt in ("f32", "f64")}
    want |= {(name, "f32/torch") for name in ("rho_ge", "gpt_lu", "ho",
                                                "ndlt")}
    assert set(table) == want
    for key, row in table.items():
        assert 0.0 < row["us"] < 1e4, (key, row)
        assert row["mode"] == ("torch-cpu-batched" if key[1] == "f32/torch"
                               else "native-hot-loop")
    assert cpu_table.REFERENCE_US == JAX_REFERENCE_US
    assert table[("ndlt", "f64")]["ref_us"] == 12.5
