"""Planar SLAM layers: ESM tracking, bundle adjustment, pose graph, odometry,
the frames -> poses pipeline and checkpoints.

Port of ``sks_tpu/slam``; the sharded VO forms
(``sharded_frames_to_poses``, ``sharded_planar_slam``) split the pair fits
over the ranks of a ``parallel.Mesh``.
"""

from sks_tpu_torch.slam.ba import (  # noqa: F401
    BAProblem,
    ba_residuals,
    gauss_newton_step,
    run_ba,
)
from sks_tpu_torch.slam.posegraph import (  # noqa: F401
    PoseGraph,
    ate_rmse,
    optimize_posegraph,
    optimize_posegraph_dense,
    posegraph_residuals,
)
from sks_tpu_torch.slam.odometry import vo_trajectory  # noqa: F401
from sks_tpu_torch.slam.pipeline import (  # noqa: F401
    frames_to_poses,
    planar_slam,
    sharded_frames_to_poses,
    sharded_planar_slam,
)
from sks_tpu_torch.slam.tracking import (  # noqa: F401
    esm_track,
    esm_track_pyramid,
)
