"""Loader for the reference's REAL wall correspondences, read at run time.

The counterpart of ``sks_tpu/data/wall.py``, the port's own copy (numpy
only).  The one reference asset without a synthetic equivalent: 2,540 real
SIFT matches of a 3-D wall scene (``orig_pts_wall.txt`` in the reference's
``C++ Codes/Runtime Test/CPU_Runtime Test/``), the data both reference
harnesses sample (``main.cpp:21-30`` draws 4-point subsets;
``GPU_Runtime Test.cu:52-78`` resamples it into batches).  The repository
does not hold the file yet: it is read from the path in
``SKS_WALL_POINTS``, else from :data:`DEFAULT_WALL` inside the package (where
the file goes once it is committed), and every consumer skips cleanly when
it is absent.  Format: a count, then ``x1 y1 x2 y2`` a line,
as :func:`sks_tpu_torch.data.fixture.load_correspondences` parses it.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from sks_tpu_torch.data.fixture import load_correspondences

__all__ = ["DEFAULT_WALL", "wall_path", "load_wall", "resample_quads"]

#: Default location of the wall file, beside the synthetic fixture; nothing
#: outside the package is looked at.  SKS_WALL_POINTS overrides it.
DEFAULT_WALL = Path(__file__).resolve().parent / "orig_pts_wall.txt"


def wall_path() -> Path | None:
    """Path to the real wall data, or None when it is not there.

    ``SKS_WALL_POINTS``, when set, is the only place looked at (a path that
    does not exist gives None); otherwise :data:`DEFAULT_WALL`."""
    p = Path(os.environ.get("SKS_WALL_POINTS") or DEFAULT_WALL)
    return p if p.exists() else None


def load_wall():
    """(src (N, 2), tar (N, 2)) float64 real matches, or None if absent."""
    p = wall_path()
    if p is None:
        return None
    return load_correspondences(p)


def resample_quads(src: np.ndarray, tar: np.ndarray, batch: int,
                   seed: int = 11):
    """``batch`` random 4-point subsets, as the reference's GPU harness
    builds its batches (``GPU_Runtime Test.cu:52-78``: uniform random
    indices modulo the data size, 4 a hypothesis; a subset may repeat a
    point).  Host-side numpy, the JAX package's draws for the same seed.

    Returns (src_quads (batch, 4, 2), tar_quads (batch, 4, 2)) float64.
    """
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, src.shape[0], size=(batch, 4))
    return src[idx], tar[idx]
