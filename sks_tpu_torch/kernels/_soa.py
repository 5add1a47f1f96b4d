"""What every kernel wrapper shares: layout, checks, launch counts, launch.

Layout: the TPU's ``(8, M, 128)`` lane-tiled SoA becomes plain ``(8, B)``
(component k of hypothesis i at ``[k, i]``), with no padding of B.

A wrapper runs its kernel's plain PyTorch version only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises.  ``LAUNCHES``
counts kernel launches per kernel (plain runs are not counted), so a run can
show that its path went through the kernels.
"""

from __future__ import annotations

import torch
from torch import Tensor

from sks_tpu_torch.kernels._build import (
    FP64_KINDS,
    SOLVE_KERNELS,
    load_library,
)

#: Kernel launches per kernel since the last reset (plain runs not counted).
LAUNCHES = dict.fromkeys(
    ("aca_solve_score", *SOLVE_KERNELS, *(f"fp64_{k}" for k in FP64_KINDS),
     "irls_refine", "anneal_polish"), 0)

_STORAGE = (torch.float32, torch.bfloat16)


def to_soa(pts: Tensor) -> Tensor:
    """(B, 4, 2) -> (8, B) component-major, contiguous."""
    b = pts.shape[0]
    return pts.reshape(b, 8).T.contiguous()


def from_soa_h(h: Tensor) -> Tensor:
    """(9, B) -> (B, 3, 3)."""
    return h.T.reshape(h.shape[1], 3, 3)


def check_soa(src: Tensor, tar: Tensor, storage=_STORAGE) -> None:
    """Raise unless src and tar are (8, B), contiguous, one dtype of
    ``storage``, on one device."""
    if src.dim() != 2 or src.shape[0] != 8 or src.shape != tar.shape:
        raise ValueError(
            f"src and tar must both be (8, B); got {tuple(src.shape)} and "
            f"{tuple(tar.shape)}"
        )
    check_storage(src, tar, storage)


def check_storage(src: Tensor, tar: Tensor, storage=_STORAGE) -> None:
    """Raise unless src and tar are contiguous, of one dtype of ``storage``,
    on one device."""
    if src.dtype not in storage or tar.dtype != src.dtype:
        raise TypeError(
            f"src and tar must share one dtype of {storage}; got "
            f"{src.dtype} and {tar.dtype}"
        )
    if src.device != tar.device:
        raise ValueError(f"src on {src.device} but tar on {tar.device}")
    if not (src.is_contiguous() and tar.is_contiguous()):
        raise ValueError("src and tar must be contiguous")


def device_kind(tensor: Tensor) -> str:
    """'cpu' or 'cuda'; raise on any other device."""
    kind = tensor.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {kind!r}")
    return kind


def check_launch(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def solve_soa_plain(core, src: Tensor, tar: Tensor) -> Tensor:
    """A solve kernel's plain version: ``core`` on the 8 component rows in
    float32, cast to the storage dtype."""
    s = [src[k].float() for k in range(8)]
    t = [tar[k].float() for k in range(8)]
    return torch.stack(core(*s, *t)).to(src.dtype)


def launch_soa(symbol: str, key: str, src: Tensor, tar: Tensor,
               out: Tensor) -> Tensor:
    """Launch the C entry point ``symbol`` (see ``_build``) on checked CUDA
    (8, B) minimal sets into ``out`` (9, B); count it in ``LAUNCHES[key]``."""
    b = src.shape[1]
    if b == 0:
        return out
    fn = getattr(load_library(), symbol)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), tar.data_ptr(), out.data_ptr(), b, stream)
    check_launch(err, key)
    LAUNCHES[key] += 1
    return out


def solve_soa(name: str, core, src: Tensor, tar: Tensor) -> Tensor:
    """Run the batched 4-point solve kernel ``name`` (C entry points
    ``sks_<name>_{f32,bf16}``, see ``_build.SOLVE_KERNELS``) on (8, B)
    minimal sets; on CPU tensors run its plain version with ``core``.

    Returns (9, B) up-to-scale homographies in the input dtype.
    """
    check_soa(src, tar)
    if device_kind(src) == "cpu":
        return solve_soa_plain(core, src, tar)
    out = torch.empty((9, src.shape[1]), dtype=src.dtype, device=src.device)
    dtype = "f32" if src.dtype == torch.float32 else "bf16"
    return launch_soa(f"sks_{name}_{dtype}", name, src, tar, out)
