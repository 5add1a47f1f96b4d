"""Robust estimation: fixed-shape vectorized RANSAC / MAGSAC over batched solvers."""

from sks_tpu_torch.robust.api import (  # noqa: F401
    find_homography,
    get_affine_transform,
    get_perspective_transform,
)
from sks_tpu_torch.robust.ransac import (  # noqa: F401
    RansacConfig,
    RansacResult,
    ransac_homography,
    ransac_homography_adaptive,
    ransac_homography_fused,
    ransac_homography_fused_batch,
    sample_minimal_sets,
    sample_minimal_sets_prosac,
    score_hypotheses,
)
