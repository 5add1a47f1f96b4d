"""Replays of captured CUDA graphs for fixed-shape stretches of the path.

A stretch of the main path that reads nothing back to the host and keeps
its shapes (the pose graph's Gauss-Newton, the per-pair tail of a fused
batch) is hundreds or thousands of small launches, each ~10-60 µs of host
for ~1-3 µs of device.  :func:`replay` captures such a stretch as a CUDA
graph at the first call of its key and shapes and replays it after: one
launch, the same kernels in the same order on the same inputs.

:func:`may_leave_eager` is the one rule for leaving eager PyTorch, by a
replay or by a kernel launched through ``ctypes``: neither autograd nor a
``torch.func`` transform sees such a stretch.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor

__all__ = ["graphable", "may_leave_eager", "replay"]

#: Captured graphs: key -> (graph, static inputs, static outputs).  The
#: oldest goes past ``MAX_GRAPHS``.
_GRAPHS: dict = {}
MAX_GRAPHS = 16


def may_leave_eager(*tensors: Tensor) -> bool:
    """Whether a stretch on ``tensors`` may leave eager PyTorch: the first
    tensor on the card, no autograd graph to record (grad enabled and a
    tensor requiring grad), and no torch.func transform active."""
    return (tensors[0].is_cuda
            and not torch._C._are_functorch_transforms_active()
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in tensors)))


def graphable(*tensors: Tensor) -> bool:
    """Whether a stretch on ``tensors`` may be replayed: it may leave eager
    PyTorch (:func:`may_leave_eager`) and is not itself inside a capture."""
    return (may_leave_eager(*tensors)
            and not torch.cuda.is_current_stream_capturing())


def replay(key, fn: Callable[..., tuple], *tensors: Tensor) -> tuple:
    """``fn(*tensors)``, a tuple of tensors, through a CUDA graph.

    ``key`` names everything but the tensors that fixes the work (``fn``'s
    settings); the tensors' device, dtypes and shapes are added to it.  At
    the first call of a key ``fn`` runs once on a side stream (its lazy
    initialisations and builds) and is captured; the capture's own
    synchronisations are set-up, so a sync-debug mode is lifted while it
    runs.  Every call copies ``tensors`` into the graph's inputs, replays
    it and returns copies of its outputs.
    """
    dev = tensors[0].device
    key = (key, dev, *((t.dtype, tuple(t.shape)) for t in tensors))
    with torch.cuda.device(dev):
        entry = _GRAPHS.get(key)
        if entry is None:
            static = tuple(t.clone() for t in tensors)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    fn(*static)
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    out = tuple(fn(*static))
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            if len(_GRAPHS) >= MAX_GRAPHS:
                _GRAPHS.pop(next(iter(_GRAPHS)))
            entry = _GRAPHS[key] = (graph, static, out)
        graph, static, out = entry
        for dst, src in zip(static, tensors):
            dst.copy_(src)
        graph.replay()
        return tuple(t.clone() for t in out)
