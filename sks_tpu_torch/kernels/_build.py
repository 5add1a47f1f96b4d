"""Build and load the package's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) to an object,
all of them at once in parallel processes, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``sks_tpu_torch/_build/`` (ignored by git), named by a hash
of every file under ``csrc/`` (headers included) and of the flags, so an
edited source or header rebuilds and an unchanged tree loads at once.
Nothing here runs at import: the CPU tests import every module on machines
without ``nvcc`` or a card.

The NDLT and HO timing instruments (``csrc/ablation/*.cu``) are a second
library, built the same way and only when ``bench/ndlt_ablation.py`` or
``bench/ho_ablation.py`` asks for it (:func:`load_ablation_library`): no
kernel of a path waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_LOGS", "FP64_KINDS", "HO_ABLATIONS", "NDLT_ABLATIONS",
           "NVCC_FLAGS",
           "SOLVE_KERNELS", "find_nvcc", "library_path",
           "load_ablation_library", "load_library"]

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

#: The libraries: name -> (directory of its ``*.cu`` under ``csrc/``).
_LIBRARY_DIRS = {"kernels": _CSRC, "ablation": _CSRC / "ablation"}
_LIBS: dict[str, ctypes.CDLL] = {}
#: ``nvcc``'s output of each library's build in this process (``-Xptxas -v``
#: lists each kernel's registers, shared memory and spills), by library name;
#: no entry for a library that was already built.
BUILD_LOGS: dict[str, str] = {}


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


#: Timing instruments for K4-NDLT (``csrc/ablation/*.cu``, the library
#: 'ablation', driven by ``bench/ndlt_ablation.py``): ``sks_ndlt_abl_<tag>(src,
#: tar, out, B, stream)`` on float32 storage, the ``f64_`` ones on float64
#: (instances of K5-ndlt).  No path launches them.
NDLT_ABLATIONS = (
    "regs_s0_l0", "regs_s0_l3", "regs_s1_l3", "regs_s2_l3", "regs_s3_l3",
    "regs_s3_l0", "regs_s3_l3_mb6", "regs_s3_l3_mb8",
    "regs_roll", "regs_roll_reload_mb6", "f64_regs", "f64_smem_reload",
    "ieee", "f64_ieee",
)

#: Timing instruments for K4-HO and K5-ho (``csrc/ablation/ho_*.cu``, the
#: same library, driven by ``bench/ho_ablation.py``): ``sks_ho_abl_<tag>(src,
#: tar, out, B, stream)`` on float32 storage, the ``f64_`` ones on float64
#: (instances of K5-ho).  ``csrc/ablation/ablation.cuh`` says what each is.
#: ``sks_ho_abl_angle_check`` (``angle_check.cu``) is no solve: it holds the
#: rotation's hand-written square root, reciprocal and division against the
#: IEEE ones.
HO_ABLATIONS = (
    "before", "unroll_s0", "unroll_s2", "unroll_s5", "noeig",
    "roll_s2", "roll_s5", "roll_s10", "roll_abs", "roll_unit", "roll_div64",
    "roll_tiny64", "tiny_t64", "tiny_t256", "roll_approx",
    "f64_before", "f64_seed_only", "f64_refine_only", "f64_roll", "f64_unit",
    "f64_unit_mb4", "f64_unit_mb5", "f64_tiny64_mb4", "f64_tiny",
    "f64_tiny_mb3", "f64_tiny_mb4", "f64_tiny_mb5", "f64_tiny_t64_mb7",
    "f64_tiny_t64_mb8", "f64_tiny_t64_mb9",
)


def _sources(library: str = "kernels") -> list[Path]:
    """The translation units of ``library``: every ``*.cu`` of its directory
    (not of the directories below it)."""
    return sorted(_LIBRARY_DIRS[library].glob("*.cu"))


def _digest(root: Path = _CSRC) -> str:
    """Hash of the flags and of every file under ``root`` (headers too)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in root.rglob("*") if p.is_file()):
        h.update(path.relative_to(root).as_posix().encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _declare_solves(lib: ctypes.CDLL, names) -> None:
    """``name(src, tar, out, B, stream) -> cudaError_t`` for every name."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int


def _declare_ablation(lib: ctypes.CDLL) -> None:
    _declare_solves(lib, [f"sks_ndlt_abl_{tag}" for tag in NDLT_ABLATIONS]
                    + [f"sks_ho_abl_{tag}" for tag in HO_ABLATIONS])
    # values, n, counts, stream
    lib.sks_ho_abl_angle_check.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.sks_ho_abl_angle_check.restype = ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    solves = [f"sks_{kernel}_{dtype}" for kernel in SOLVE_KERNELS
              for dtype in ("f32", "bf16")]
    solves += [f"sks_fp64_{kind}_{dtype}" for kind in FP64_KINDS
               for dtype in ("f32", "f64")]
    _declare_solves(lib, solves)
    for name in ("sks_aca_solve_score_f32", "sks_aca_solve_score_bf16"):
        fn = getattr(lib, name)
        # src, tar, pts, weights, t2, scoring, out, scratch, pairs, B, N,
        # chunks, chunk_points, stream
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_float, ctypes.c_int, vp, vp,
                       ll, ll, ll, ll, ll, vp]
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


def library_path(library: str = "kernels") -> Path:
    """Where ``library`` ('kernels' or 'ablation') is built to."""
    return _BUILD_DIR / f"libsks_tpu_torch_{library}_{_digest()}.so"


def _load(library: str, declare) -> ctypes.CDLL:
    if library in _LIBS:
        return _LIBS[library]
    out = library_path(library)
    if not out.is_file():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build in a temporary directory and rename the library into place:
        # concurrent processes never load a half-written one.
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
            BUILD_LOGS[library] = _build(find_nvcc(), _sources(library),
                                         Path(tmp), out)
    lib = ctypes.CDLL(str(out))
    declare(lib)
    _LIBS[library] = lib
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library; cached."""
    return _load("kernels", _declare)


def load_ablation_library() -> ctypes.CDLL:
    """Build (if needed) and load the NDLT and HO timing instruments; cached."""
    return _load("ablation", _declare_ablation)
