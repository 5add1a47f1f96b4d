"""ctypes bindings for the repository's native CPU solvers
(``native/src/sks_native.cpp``), built by the port.

The port's copy of ``sks_tpu/native``: the same entry points (the six
4-point solvers in float32 and float64, the reference-format correspondence
reader, and the hot-loop CPU benchmark of the reference's Table 5).  The
library is compiled with ``g++`` straight from the C++ source into
``sks_tpu_torch/_build/`` (ignored by git), named by a hash of the source
and the flags, at first use; nothing is built or written under ``native/``.
The float64 solvers are the C++ oracle the tests hold the port's float64
kernel (K5) against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

__all__ = [
    "CXX_FLAGS",
    "available",
    "aca_batch",
    "sks_batch",
    "solve_batch",
    "read_points",
    "bench_hot_loop",
]

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG.parent / "native" / "src" / "sks_native.cpp"
_BUILD_DIR = _PKG / "_build"
#: The flags of ``native/Makefile``.  No -ffast-math: it would link
#: crtfastmath, which sets FTZ/DAZ for the whole Python process.
CXX_FLAGS = ("-O3", "-march=native", "-fno-math-errno", "-shared", "-fPIC")
KINDS = ("aca", "sks", "ge", "gpt", "ho", "ndlt")
_lib = None


def _compiler() -> str | None:
    return shutil.which(os.environ.get("CXX", "g++"))


def available() -> bool:
    """Whether the library is built or a C++ compiler can build it."""
    return _lib is not None or _compiler() is not None


def _library_path() -> Path:
    digest = hashlib.sha256(_SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return _BUILD_DIR / f"libsks_native_{digest.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = _library_path()
    if not path.is_file():
        cxx = _compiler()
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++, or $CXX) to build "
                               f"{_SOURCE.name}")
        _BUILD_DIR.mkdir(exist_ok=True)
        # Build under a private name, then rename: concurrent builds (test
        # workers) each finish a whole library before it appears.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(_SOURCE)],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(path))
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    for suffix, fp in (("f32", f32p), ("f64", f64p)):
        for kind in KINDS:
            fn = getattr(lib, f"sks_{kind}_{suffix}")
            fn.argtypes = [fp, fp, fp, i64, ctypes.c_int]
            fn.restype = None
            bench = getattr(lib, f"sks_bench_{kind}_{suffix}")
            bench.argtypes = [fp, fp, i64]
            bench.restype = ctypes.c_double
    lib.sks_read_points.argtypes = [ctypes.c_char_p, f64p, f64p, i64]
    lib.sks_read_points.restype = i64
    _lib = lib
    return lib


def _pointer_type(dtype):
    return ctypes.POINTER(ctypes.c_float if dtype == np.float32
                          else ctypes.c_double)


def _suffix(dtype) -> str:
    if dtype not in (np.float32, np.float64):
        raise TypeError(f"float32 or float64 points; got {dtype}")
    return "f32" if dtype == np.float32 else "f64"


def solve_batch(alg: str, src, tar, normalize: bool = True) -> np.ndarray:
    """Native batched minimal solve: (..., 4, 2) x2 -> (..., 3, 3).

    ``alg``: 'aca' | 'sks' | 'ge' | 'gpt' | 'ho' | 'ndlt' (the reference's
    Table-5 roster); float32 or float64 points, the result in their dtype,
    H[2, 2] = 1 with ``normalize``.
    """
    if alg not in KINDS:
        raise ValueError(f"alg must be one of {KINDS}; got {alg!r}")
    lib = _load()
    src = np.ascontiguousarray(src)
    tar = np.ascontiguousarray(tar)
    if src.shape != tar.shape or src.shape[-2:] != (4, 2):
        raise ValueError(f"src and tar must be (..., 4, 2); got {src.shape}, "
                         f"{tar.shape}")
    if tar.dtype != src.dtype:
        raise TypeError(f"src is {src.dtype}, tar {tar.dtype}")
    suffix = _suffix(src.dtype)
    out = np.empty((*src.shape[:-2], 3, 3), src.dtype)
    cp = _pointer_type(src.dtype)
    getattr(lib, f"sks_{alg}_{suffix}")(
        src.ctypes.data_as(cp), tar.ctypes.data_as(cp), out.ctypes.data_as(cp),
        int(np.prod(src.shape[:-2], dtype=np.int64)), int(normalize))
    return out


def aca_batch(src, tar, normalize: bool = True) -> np.ndarray:
    """Native batched ACA: (..., 4, 2) x2 -> (..., 3, 3)."""
    return solve_batch("aca", src, tar, normalize)


def sks_batch(src, tar, normalize: bool = True) -> np.ndarray:
    """Native batched SKS: (..., 4, 2) x2 -> (..., 3, 3)."""
    return solve_batch("sks", src, tar, normalize)


def read_points(path: str | Path, cap: int = 1 << 20):
    """Read the reference correspondence format -> (src (N, 2), tar (N, 2))
    float64: the count, then one ``x1 y1 x2 y2`` line a correspondence."""
    lib = _load()
    src = np.empty((cap, 2), np.float64)
    tar = np.empty((cap, 2), np.float64)
    f64p = ctypes.POINTER(ctypes.c_double)
    n = lib.sks_read_points(str(path).encode(), src.ctypes.data_as(f64p),
                            tar.ctypes.data_as(f64p), cap)
    if n < 0:
        raise OSError(f"failed to read {path}")
    return src[:n].copy(), tar[:n].copy()


def bench_hot_loop(alg: str, src4, tar4, iters: int = 10_000_000) -> float:
    """Nanoseconds a solve: one cache-hot 4-point set in a loop (the shape
    of the reference's Table 5)."""
    lib = _load()
    src4 = np.ascontiguousarray(src4).reshape(8)
    tar4 = np.ascontiguousarray(tar4, dtype=src4.dtype).reshape(8)
    cp = _pointer_type(src4.dtype)
    fn = getattr(lib, f"sks_bench_{alg}_{_suffix(src4.dtype)}")
    return float(fn(src4.ctypes.data_as(cp), tar4.ctypes.data_as(cp), iters))
