"""Feature pipeline: detect -> describe -> match, batched over frames.

Port of ``sks_tpu/features``: Harris corners from separable shifted-sum
filters, normalized (oriented) patch descriptors from bilinear gathers, and
mutual-nearest matching on a float32 similarity product.
"""

from sks_tpu_torch.features.harris import (  # noqa: F401
    detect_corners,
    detect_corners_pyramid,
    harris_response,
)
from sks_tpu_torch.features.descriptors import (  # noqa: F401
    oriented_patch_descriptors,
    patch_descriptors,
)
from sks_tpu_torch.features.matching import (  # noqa: F401
    describe_frames,
    match_descriptors,
    match_features,
    match_frames,
    match_frames_oriented,
)
