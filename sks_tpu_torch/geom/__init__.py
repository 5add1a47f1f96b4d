"""Geometry layer: homography action, errors, pose recovery, Lie groups."""

from sks_tpu_torch.geom.homography import (  # noqa: F401
    apply_homography,
    homography_from_pose,
    inv_h,
    normalize_h,
    reprojection_error,
    symmetric_transfer_error,
)
from sks_tpu_torch.geom.pose import (  # noqa: F401
    decompose_homography,
    recover_pose,
    select_pose,
)
