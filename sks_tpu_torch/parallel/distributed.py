"""Multi-process execution: joining a group, host-aware meshes, replication.

Port of ``sks_tpu/parallel/distributed.py``.  ``jax.distributed.initialize``
becomes ``torch.distributed.init_process_group`` (NCCL for CUDA ranks, gloo
for CPU ranks), one process per device.  :func:`global_mesh` lays a ``host``
axis outermost, one slot per node, so that a reduction along the inner axes
stays within a node and only the small consensus crosses nodes.  Inputs are
replicated by a broadcast from rank 0 (:func:`replicate_to_mesh`), so the
replicas are equal by construction.

Tested on the CPU with gloo ranks spawned as processes
(``tests/test_torch_parallel.py``); on a card, world size 1 under NCCL
(``chip_smoke.py``).
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from sks_tpu_torch.parallel.mesh import Mesh, _resolve, local_device, make_mesh

__all__ = [
    "initialize_multihost",
    "global_mesh",
    "replicate_to_mesh",
    "is_multiprocess",
]


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device_type: str = "cuda",
    *,
    init_method: str | None = None,
    backend: str | None = None,
    timeout: float | None = None,
) -> None:
    """Join (or start) a process group; a no-op if one is initialized.

    With no arguments the rendezvous comes from the environment
    (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    as ``torchrun`` sets them).  The JAX package's ``local_device_count``
    (an XLA flag for virtual CPU devices) has no counterpart: here a rank is
    one process with one device.

    Args:
      coordinator_address: ``host:port`` of rank 0 (``tcp://``).
      num_processes: world size.
      process_id: this process's rank.
      device_type: 'cuda' (the default; raises without a card; binds the
        rank to :func:`parallel.mesh.local_device`) or 'cpu'.
      init_method: a rendezvous URL in place of ``coordinator_address``
        (e.g. ``file:///path/store`` for ranks on one machine).
      backend: default 'nccl' for 'cuda', 'gloo' for 'cpu'.
      timeout: seconds a collective may wait.
    """
    if dist.is_initialized():
        return
    dev = local_device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if init_method is None:
        init_method = (f"tcp://{coordinator_address}" if coordinator_address
                       else "env://")
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = timedelta(seconds=timeout)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, **kwargs)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(ici_axes: dict[str, int] | None = None,
                host_axis: str = "host", device_type: str = "cuda") -> Mesh:
    """A mesh over all ranks, the node axis outermost.

    The ``host`` axis has one slot per node (world size over
    ``LOCAL_WORLD_SIZE``, which ``torchrun`` sets; unset, one node);
    ``ici_axes`` lay out each node's ranks (default: all on 'hyp', a ``-1``
    entry takes the rest).  Example: ``global_mesh({'hyp': 4})`` on 2 nodes
    of 4 ranks gives a ``('host', 'hyp')`` mesh of shape (2, 4).
    """
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_multihost "
                           "first")
    world = dist.get_world_size()
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_node:
        raise ValueError(f"{world} ranks are not whole nodes of {per_node}")
    inner = _resolve({"hyp": per_node} if ici_axes is None else ici_axes,
                     per_node)
    return make_mesh({host_axis: world // per_node, **inner}, device_type)


def replicate_to_mesh(x, mesh: Mesh) -> torch.Tensor:
    """A tensor (or array) -> the same on every rank, on the rank's device.

    Rank 0's values are broadcast to every rank, so the replicas are equal
    even where the ranks computed them apart.  Every rank passes a value of
    the same shape and dtype.
    """
    t = torch.as_tensor(x).to(mesh.device).contiguous().clone()
    dist.broadcast(t, src=0)
    return t
