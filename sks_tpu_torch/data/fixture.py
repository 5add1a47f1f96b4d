"""Synthetic wall-style correspondence fixture.

The counterpart of ``sks_tpu/data/fixture.py``, the port's own copy (numpy
only).  The reference benchmarks sample 4-point sets from a file of 2,540
real SIFT matches of a wall scene (``CPU_Runtime Test/orig_pts_wall.txt``:
a count, then ``x1 y1 x2 y2`` a line).  This fixture has the same format,
made synthetically: a known ground-truth homography ``GT_H``, 0.6 px of
Gaussian noise and 15% uniform outliers, so a fit can be scored against the
truth.  ``make_fixture`` with its defaults (seed 7) writes the file the
package ships, ``wall_synth.txt``, byte for byte.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["make_fixture", "load_correspondences", "DEFAULT_FIXTURE", "GT_H"]

DEFAULT_FIXTURE = Path(__file__).resolve().parent / "wall_synth.txt"

#: Ground-truth homography of the fixture (a mild perspective warp).
GT_H = np.array(
    [
        [0.95, -0.08, 40.0],
        [0.06, 1.02, -25.0],
        [1.5e-4, -9e-5, 1.0],
    ]
)


def make_fixture(
    path: Path | str = DEFAULT_FIXTURE,
    n: int = 2000,
    noise: float = 0.6,
    outlier_frac: float = 0.15,
    seed: int = 7,
) -> Path:
    """Write a reference-format correspondence file; returns the path.

    ``n`` source points uniform over a 640 x 480 image, their images under
    ``GT_H`` plus ``noise`` px of Gaussian noise, and ``outlier_frac`` of
    the targets replaced by uniform points.
    """
    rng = np.random.default_rng(seed)
    src = rng.uniform([8.0, 8.0], [632.0, 472.0], (n, 2))
    ones = np.ones((n, 1))
    proj = np.concatenate([src, ones], axis=1) @ GT_H.T
    tar = proj[:, :2] / proj[:, 2:3]
    tar += rng.normal(0.0, noise, tar.shape)
    n_out = int(n * outlier_frac)
    idx = rng.choice(n, n_out, replace=False)
    tar[idx] = rng.uniform([0.0, 0.0], [640.0, 480.0], (n_out, 2))
    path = Path(path)
    with open(path, "w") as f:
        f.write(f"{n}\n")
        for (x1, y1), (x2, y2) in zip(src, tar):
            f.write(f"{x1:.4f} {y1:.4f} {x2:.4f} {y2:.4f}\n")
    return path


def load_correspondences(path: Path | str = DEFAULT_FIXTURE):
    """Load a reference-format file -> (src (N, 2), tar (N, 2)) float64
    numpy arrays; writes the default fixture first if it is missing."""
    path = Path(path)
    if path == DEFAULT_FIXTURE and not path.exists():
        make_fixture(path)
    with open(path) as f:
        n = int(f.readline())
        data = np.loadtxt(f, max_rows=n)
    return data[:, :2].copy(), data[:, 2:4].copy()
