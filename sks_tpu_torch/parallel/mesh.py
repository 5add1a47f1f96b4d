"""Meshes over the ranks of a ``torch.distributed`` group, and their
collectives.

Port of ``sks_tpu/parallel/mesh.py``.  JAX runs many devices in one process
under ``shard_map``; here each rank is one process with one device.  A
:class:`Mesh` lays the ranks of the initialized default group out on named
axes, row-major (rank r sits at ``numpy.unravel_index(r, sizes)``, as
``jax.sharding.Mesh`` reshapes its device list), and holds one process group
for every set of axes a sharded function may reduce over.

The sharded functions keep the JAX call shapes: every rank passes the same
global, replicated inputs; a function slices the rank's own block by its
coordinate on the mesh axis (:meth:`Mesh.index`, linearized row-major over
the named axes as ``jax.lax.axis_index`` is in the JAX package) and returns
replicated results.  ``jax.lax.psum`` becomes :func:`psum` (one
``all_reduce`` of every operand packed into one buffer) and
``jax.lax.all_gather(tiled=True)`` becomes :func:`all_gather`
(``dist.all_gather`` into a list, concatenated in the order of the linear
index: the same on gloo and NCCL).
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

__all__ = ["Mesh", "all_gather", "local_device", "make_mesh", "psum"]


def local_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` (the global
    rank when ``LOCAL_RANK`` is unset), or the CPU.  Raises for 'cuda'
    without a card."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cuda' or 'cpu'; got "
                         f"{device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device_type='cuda' and there is no CUDA device; "
                           "pass device_type='cpu' to run on the CPU")
    rank = int(os.environ.get(
        "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", rank % torch.cuda.device_count())


def _resolve(axis_sizes: dict[str, int], n: int) -> dict[str, int]:
    """Replace one -1 entry by what is left of ``n``; check the product."""
    sizes = dict(axis_sizes)
    unknown = [a for a, s in sizes.items() if s == -1]
    known = int(np.prod([s for s in sizes.values() if s != -1]))
    if len(unknown) > 1 or (unknown and n % known):
        raise ValueError(f"cannot lay {n} ranks out as {axis_sizes}")
    if unknown:
        sizes[unknown[0]] = n // known
    if int(np.prod(list(sizes.values()))) != n:
        raise ValueError(f"mesh {sizes} does not hold the {n} ranks")
    return sizes


class Mesh:
    """The ranks of the default process group on named axes.

    Built collectively (every rank constructs it, with the same axes): the
    constructor makes one process group for each set of axes that is neither
    empty nor the whole world, every rank calling ``dist.new_group`` in the
    same order.
    """

    def __init__(self, axis_sizes: dict[str, int], device: torch.device):
        self.axis_names = tuple(axis_sizes)
        self.sizes = tuple(int(s) for s in axis_sizes.values())
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                             self.sizes))
        self._groups = {}
        world = int(np.prod(self.sizes))
        for r in range(1, len(self.sizes) + 1):
            for axes in itertools.combinations(self.axis_names, r):
                if self.size(axes) == world:
                    self._groups[axes] = None  # the default group
                    continue
                for ranks in self._partition(axes):
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = group

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def _axes(self, axis) -> tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} not distinct names of the mesh "
                             f"{self.shape}")
        return axes

    def _partition(self, axes):
        """The rank lists of the groups over ``axes`` (sorted, in order of
        the other axes' coordinates)."""
        pos = [self.axis_names.index(a) for a in axes]
        groups = {}
        for rank in range(int(np.prod(self.sizes))):
            c = np.unravel_index(rank, self.sizes)
            rest = tuple(int(c[i]) for i in range(len(c)) if i not in pos)
            groups.setdefault(rest, []).append(rank)
        return [groups[k] for k in sorted(groups)]

    def size(self, axis) -> int:
        """Number of ranks along ``axis`` (a name or a tuple of names)."""
        shape = self.shape
        return int(np.prod([shape[a] for a in self._axes(axis)]))

    def index(self, axis, rank: int | None = None) -> int:
        """Coordinate of ``rank`` (default: this one) along ``axis``, a
        tuple linearized row-major in the order given."""
        coords = (self.coords if rank is None
                  else np.unravel_index(rank, self.sizes))
        shape = self.shape
        out = 0
        for a in self._axes(axis):
            out = out * shape[a] + int(coords[self.axis_names.index(a)])
        return out

    def group(self, axis):
        """This rank's process group along ``axis`` (None: the default
        group)."""
        return self._groups[tuple(a for a in self.axis_names
                                  if a in self._axes(axis))]

    def block(self, n: int, axis) -> slice:
        """This rank's contiguous block of ``n`` items split along ``axis``
        (``n`` a multiple of the axis size)."""
        size = self.size(axis)
        if n % size:
            raise ValueError(f"{n} items do not split over {size} ranks")
        per = n // size
        i = self.index(axis)
        return slice(i * per, (i + 1) * per)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device}, rank={self.rank})"


def make_mesh(axis_sizes: dict[str, int] | None = None,
              device_type: str = "cuda") -> Mesh:
    """A :class:`Mesh` over the initialized default group (default: every
    rank on 'hyp').

    A ``-1`` entry takes the rest of the world size; the sizes' product
    must equal it.  Each rank's device is :func:`local_device`.  Call on
    every rank, after ``parallel.distributed.initialize_multihost``.
    """
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.distributed.initialize_multihost first")
    n = dist.get_world_size()
    sizes = _resolve({"hyp": n} if axis_sizes is None else axis_sizes, n)
    return Mesh(sizes, local_device(device_type))


def psum(mesh: Mesh, axis, *xs: Tensor):
    """The sums of ``xs`` over the ranks along ``axis``: one ``all_reduce``
    of every operand packed into one buffer (the operands' common dtype).

    Returns one tensor for one operand, else a tuple.
    """
    flat = torch.cat([x.reshape(-1) for x in xs]).contiguous()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    out, at = [], 0
    for x in xs:
        out.append(flat[at:at + x.numel()].reshape(x.shape))
        at += x.numel()
    return out[0] if len(out) == 1 else tuple(out)


def all_gather(mesh: Mesh, axis, x: Tensor, dim: int = 0) -> Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on ``dim`` in the
    order of :meth:`Mesh.index` (``jax.lax.all_gather(tiled=True)``).

    Every rank's ``x`` has the same shape and dtype.
    """
    group = mesh.group(axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, x, group=group)
    # Group ranks follow the sorted global ranks; put each part at its
    # member's linear index along ``axis``.
    members = (list(range(dist.get_world_size())) if group is None
               else dist.get_process_group_ranks(group))
    order = [mesh.index(axis, rank=m) for m in sorted(members)]
    placed = [None] * len(parts)
    for pos, part in zip(order, parts):
        placed[pos] = part
    return torch.cat(placed, dim=dim)
