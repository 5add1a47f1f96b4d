"""Planar SLAM layers: pose graph, odometry and the frames -> poses pipeline.

Port of ``sks_tpu/slam`` without ESM tracking (``tracking.py``), bundle
adjustment and the sharded forms, which follow in later slices
(ROADMAP.md Queue A items 6 and 7).
"""

from sks_tpu_torch.slam.posegraph import (  # noqa: F401
    PoseGraph,
    ate_rmse,
    optimize_posegraph,
    optimize_posegraph_dense,
    posegraph_residuals,
)
from sks_tpu_torch.slam.odometry import vo_trajectory  # noqa: F401
from sks_tpu_torch.slam.pipeline import frames_to_poses, planar_slam  # noqa: F401
