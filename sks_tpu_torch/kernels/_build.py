"""Build and load the package's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) to an object,
all of them at once in parallel processes, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``sks_tpu_torch/_build/`` (ignored by git), named by a hash
of every file under ``csrc/`` (headers included) and of the flags, so an
edited source or header rebuilds and an unchanged tree loads at once.
Nothing here runs at import: the CPU tests import every module on machines
without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_LOG", "FP64_KINDS", "NVCC_FLAGS", "SOLVE_KERNELS",
           "find_nvcc", "library_path", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"

#: Compile flags of every source.  -fmad=false: no fused multiply-add
#: contraction, so each kernel rounds every product and sum on its own,
#: exactly like its plain PyTorch version.  No --use_fast_math: the solvers
#: need IEEE division and sqrt, the scoring NaN comparisons.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: ``nvcc``'s output of the library's build in this process (``-Xptxas -v``
#: lists each kernel's registers, shared memory and spills); empty if the
#: library was already built.
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


#: The batched 4-point solves, one C entry point per storage dtype:
#: ``sks_<name>_{f32,bf16}(src, tar, out, B, stream)``.
SOLVE_KERNELS = ("aca_solve", "sks_solve", "ge_solve", "gpt_solve",
                 "ho_solve", "ndlt_solve")

#: The kinds of K5, the float64 batched solve (``csrc/fp64.cu``), one C entry
#: point per input storage dtype: ``sks_fp64_<kind>_{f32,f64}(src, tar, out,
#: B, stream)``, always float64 out.  The JAX package's kinds.
FP64_KINDS = ("aca", "sks", "ge", "gpt", "ho", "ndlt")


def _sources() -> list[Path]:
    """The translation units: every ``*.cu`` of ``csrc/``."""
    return sorted(_CSRC.glob("*.cu"))


def _digest(root: Path = _CSRC) -> str:
    """Hash of the flags and of every file under ``root`` (headers too)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in root.rglob("*") if p.is_file()):
        h.update(path.relative_to(root).as_posix().encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    solves = [f"sks_{kernel}_{dtype}" for kernel in SOLVE_KERNELS
              for dtype in ("f32", "bf16")]
    solves += [f"sks_fp64_{kind}_{dtype}" for kind in FP64_KINDS
               for dtype in ("f32", "f64")]
    for name in solves:
        # src, tar, out, B, stream
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, ll, vp]
        fn.restype = ctypes.c_int
    for name in ("sks_aca_solve_score_f32", "sks_aca_solve_score_bf16"):
        fn = getattr(lib, name)
        # src, tar, pts, weights, t2, scoring, out, scratch, pairs, B, N,
        # chunks, chunk_points, stream
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_float, ctypes.c_int, vp, vp,
                       ll, ll, ll, ll, ll, vp]
        fn.restype = ctypes.c_int
    # h0, src, tar, mask, out, K, N, iters, threshold, magsac, sigma_max,
    # magsac_k, stream
    fn = lib.sks_irls_refine_f32
    fn.argtypes = [vp, vp, vp, vp, vp, ll, ll, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float, vp]
    fn.restype = ctypes.c_int
    # h0, src, tar, mask, wbuf, out, N, threshold, levels, n_levels, iters,
    # stream
    fn = lib.sks_anneal_polish_f32
    fn.argtypes = [vp, vp, vp, vp, vp, vp, ll, ctypes.c_float,
                   ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                   vp]
    fn.restype = ctypes.c_int
    # h, src, tar, weights, out, scratch, B, N, chunks, chunk_points,
    # scoring, t2, ks, gate, stream
    fn = lib.sks_score_h_f32
    fn.argtypes = [vp, vp, vp, vp, vp, vp, ll, ll, ll, ll, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_float, vp]
    fn.restype = ctypes.c_int
    # values, n, counts, stream
    fn = lib.sks_angle_check
    fn.argtypes = [vp, ctypes.c_int, vp, vp]
    fn.restype = ctypes.c_int


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; return their outputs, raise if one fails.

    Every process is waited for, failed or not, so none outlives the call.
    """
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    return logs


def _build(nvcc: str, sources: list[Path], tmp: Path, out: Path) -> str:
    """Compile every source to an object at once, link, move to ``out``."""
    objs = [tmp / f"{src.stem}.o" for src in sources]
    logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                     for src, obj in zip(sources, objs)])
    lib = tmp / out.name
    _run_all([[nvcc, "-shared", "-o", str(lib), *map(str, objs)]])
    os.replace(lib, out)
    return "".join(f"== {src.name}\n{log}" for src, log in zip(sources, logs))


def library_path() -> Path:
    """Where the library is built to."""
    return _BUILD_DIR / f"libsks_tpu_torch_kernels_{_digest()}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library; cached."""
    global BUILD_LOG
    out = library_path()
    if not out.is_file():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build in a temporary directory and rename the library into place:
        # concurrent processes never load a half-written one.
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
            BUILD_LOG = _build(find_nvcc(), _sources(), Path(tmp), out)
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    return lib
