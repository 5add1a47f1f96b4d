"""Geometry layer: homography action, errors and synthesis from poses."""

from sks_tpu_torch.geom.homography import (  # noqa: F401
    apply_homography,
    homography_from_pose,
    inv_h,
    normalize_h,
    reprojection_error,
    symmetric_transfer_error,
)
