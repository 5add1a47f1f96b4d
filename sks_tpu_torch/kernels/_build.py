"""Build and load the package's CUDA kernels (``csrc/*.cu``) at first use.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``.  The library lands
in ``sks_tpu_torch/_build/`` (ignored by git), named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import: the CPU tests import every module on machines
without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["NVCC_FLAGS", "find_nvcc", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"

#: -fmad=false: no fused multiply-add contraction, so each kernel rounds every
#: product and sum on its own, exactly like its plain PyTorch version.  No
#: --use_fast_math: the scoring needs IEEE division and NaN comparisons.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB: ctypes.CDLL | None = None
#: ``nvcc``'s output of the last build in this process (``-Xptxas -v`` lists
#: each kernel's registers, shared memory and spills); empty when the library
#: was already built.
BUILD_LOG = ""


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then PyTorch's guess."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on PATH "
        "to build the sks_tpu_torch CUDA kernels"
    )


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    for name in ("sks_aca_solve_f32", "sks_aca_solve_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, ll, vp]
        fn.restype = ctypes.c_int
    for name in ("sks_aca_solve_score_f32", "sks_aca_solve_score_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_float, ctypes.c_int, vp, ll,
                       ll, vp]
        fn.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library; cached."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    sources = _sources()
    out = _BUILD_DIR / f"libsks_tpu_torch_{_digest(sources)}.so"
    if not out.is_file():
        nvcc = find_nvcc()
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build into a temporary name and rename: concurrent processes never
        # load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        BUILD_LOG = proc.stdout + proc.stderr
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    _LIB = lib
    return lib
