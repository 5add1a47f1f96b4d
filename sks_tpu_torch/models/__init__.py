"""Model layer: deep homography estimation with the ACA-rect head.

Port of ``sks_tpu.models``: the deep-homography pipelines that the
reference's PyTorch stack serves (4-point-offset parameterization solved by
TensorDLT / TensorGE / TensorACA, ``PyTorch Codes/Modules_Runtime_Test.py``)
as trainable ``torch.nn`` modules, a CNN regressing corner offsets and the
iterative IHN, converted to a homography differentiably by the ACA-rect head.
"""

from sks_tpu_torch.models.deep_homography import (  # noqa: F401
    HomographyNet,
    corner_loss,
    create_train_state,
    train_step,
)
from sks_tpu_torch.models.heads import HEAD_METHODS, offsets_to_h  # noqa: F401
from sks_tpu_torch.models.iterative import (  # noqa: F401
    IterativeHomographyNet,
    create_ihn_state,
    ihn_train_step,
    sequence_loss,
    warp_by_homography,
)
