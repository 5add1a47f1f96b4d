"""IHN-style iterative deep homography estimation with an ACA-rect core.

Port of ``sks_tpu/models/iterative.py``.  The reference carries
``TensorDLT_2`` because the Iterative Homography Network uses it as the inner
solver of a recurrent estimate-warp-correct loop
(``PyTorch Codes/Modules_Runtime_Test.py:81-101``).  This is that model
family:

  encode both images once -> loop (static trip count, shared weights):
    H_k = aca_rect(corners + offsets_k)          # ~50-flop closed-form head
    warp features of image 2 by H_k              # bilinear gather
    delta_k = CNN(f1, f2_warped, f2_warped - f1) # correction
    offsets_{k+1} = offsets_k + delta_k

The warp samples f2 *at* H(grid), the forward map, so no 3x3 inverse is
formed.  It is the gather form only: the JAX package's one-hot matmul
sampler is a TPU workaround that the port leaves out (``sampler='matmul'``
raises, as in ``features.descriptors``).  Training uses the RAFT/IHN
exponentially weighted sequence loss over the per-iteration estimates.
Layers and initialization follow ``deep_homography`` (flax 'SAME' padding,
``lecun_normal``), so a flax parameter tree carries across
(``sks_tpu_torch.utils.convert.ihn_state_from``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from sks_tpu_torch.features.descriptors import _sample
from sks_tpu_torch.geom.homography import apply_homography
from sks_tpu_torch.models.deep_homography import (
    SameConv2d,
    TrainState,
    batch_block,
    corner_loss,
    init_like_flax,
    optimizer_step,
)
from sks_tpu_torch.ops.aca_rect import aca_rect, rect_corners

__all__ = [
    "IterativeHomographyNet",
    "warp_by_homography",
    "sequence_loss",
    "create_ihn_state",
    "ihn_train_step",
]


def _warp_nchw(img: Tensor, h: Tensor, sampler: str = "auto") -> Tensor:
    """(B, C, S, S) sampled at H(grid), bilinear, edge-clamped."""
    b, c, s, _ = img.shape
    xs = torch.arange(s, dtype=img.dtype, device=img.device)
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1).reshape(-1, 2)  # (S*S, 2) as (x, y)
    pts = apply_homography(h, grid)  # (B, S*S, 2)
    vals = _sample(img, pts[:, None].expand(b, c, s * s, 2), sampler)
    return vals.reshape(b, c, s, s)


def warp_by_homography(img: Tensor, h: Tensor, sampler: str = "auto") -> Tensor:
    """Sample ``img`` at H(grid): out(x) = img(H x), bilinear, edge-clamped.

    Args:
      img: (B, S, S, C) feature/image stack.
      h: (B, 3, 3) homography in the pixel coordinates of ``img``.
      sampler: 'gather' or 'auto' (the same); 'matmul' raises.

    Returns:
      (B, S, S, C) warped stack (differentiable in both arguments).
    """
    out = _warp_nchw(img.permute(0, 3, 1, 2), h, sampler)
    return out.permute(0, 2, 3, 1)


class _Encoder(nn.Module):
    """Shared 1/4-resolution feature encoder (applied to each image)."""

    def __init__(self, dim: int = 64):
        super().__init__()
        self.conv0 = SameConv2d(1, dim // 2)
        self.conv1 = SameConv2d(dim // 2, dim)

    def forward(self, x: Tensor) -> Tensor:
        return F.relu(self.conv1(F.relu(self.conv0(x))))


class _Update(nn.Module):
    """Correction block: stacked (f1, f2w, f2w - f1) -> delta offsets."""

    def __init__(self, dim: int = 64, step_scale: float = 8.0):
        super().__init__()
        self.step_scale = step_scale
        self.conv0 = SameConv2d(3 * dim, dim)
        self.conv1 = SameConv2d(dim, dim)
        self.dense0 = nn.Linear(dim, 128)
        self.dense1 = nn.Linear(128, 8)

    def forward(self, x: Tensor) -> Tensor:
        x = F.relu(self.conv1(F.relu(self.conv0(x))))
        x = torch.mean(x, dim=(2, 3))  # global context
        x = self.dense1(F.relu(self.dense0(x)))
        return self.step_scale * torch.tanh(x).reshape(-1, 4, 2)


class IterativeHomographyNet(nn.Module):
    """Recurrent estimate-warp-correct homography regressor (IHN family).

    ``forward`` takes a (B, S, S, 2) pair and returns the (iters, B, 4, 2)
    sequence of offset estimates in *image* pixels (the last entry is the
    prediction); weights are shared across iterations.
    """

    def __init__(self, dim: int = 64, iters: int = 6,
                 step_scale: float = 8.0):
        super().__init__()
        self.iters = iters
        self.encoder = _Encoder(dim)
        self.update = _Update(dim, step_scale)

    def forward(self, pair: Tensor) -> Tensor:
        b, s = pair.shape[0], pair.shape[1]
        x = pair.permute(0, 3, 1, 2)
        # Both images through the one encoder in one batch.
        f1, f2 = self.encoder(torch.cat([x[:, :1], x[:, 1:]])).split(b)
        s4 = f1.shape[-1]
        dt, dev = pair.dtype, pair.device
        scale = torch.tensor(s4 / s, dtype=dt)
        origin = torch.zeros((b, 2), dtype=dt, device=dev)
        size = torch.full((b, 2), float(s4 - 1), dtype=dt, device=dev)
        corners = rect_corners(origin, size)

        offsets = torch.zeros((b, 4, 2), dtype=dt, device=dev)  # feature scale
        seq = []
        for _ in range(self.iters):
            h = aca_rect(corners + offsets, origin, size)
            f2w = _warp_nchw(f2, h)
            offsets = offsets + self.update(torch.cat([f1, f2w, f2w - f1], 1))
            seq.append(offsets / scale)  # report at image scale
        return torch.stack(seq, dim=0)

    def homography(self, pair: Tensor) -> Tensor:
        """(B, 3, 3) H (image pixels) from the final iteration's offsets."""
        offsets = self(pair)[-1]
        b, s = pair.shape[0], pair.shape[1]
        origin = torch.zeros((b, 2), dtype=pair.dtype, device=pair.device)
        size = torch.full((b, 2), float(s - 1), dtype=pair.dtype,
                          device=pair.device)
        return aca_rect(rect_corners(origin, size) + offsets, origin, size)


def sequence_loss(seq: Tensor, offsets_true: Tensor,
                  gamma: float = 0.85) -> Tensor:
    """RAFT/IHN exponentially weighted corner loss over the iterate sequence."""
    n = seq.shape[0]
    w = gamma ** torch.arange(n - 1, -1, -1, dtype=seq.dtype,
                              device=seq.device)
    per = torch.stack([corner_loss(seq[i], offsets_true) for i in range(n)])
    return torch.sum(w * per) / torch.sum(w)


def create_ihn_state(generator: torch.Generator, image_size: int = 64,
                     iters: int = 6, dtype=torch.float32, device="cuda"):
    """``(IterativeHomographyNet, TrainState)`` initialized from
    ``generator`` as flax initializes, on ``device`` (the card unless the
    caller asks for the CPU).  ``image_size`` is the JAX signature's; the
    module's weights do not depend on it."""
    del image_size
    model = IterativeHomographyNet(iters=iters)
    init_like_flax(model, generator)
    model = model.to(device=device, dtype=dtype)
    return model, TrainState.create(model)


def ihn_train_step(model: IterativeHomographyNet, state: TrainState,
                   pair: Tensor, offsets_true: Tensor, group=None):
    """One supervised step (sequence loss): ``(state, loss)``, the loss a
    0-d tensor.  ``group``: a process group for a data-parallel step, as in
    ``deep_homography.train_step``."""
    pair, offsets_true = batch_block(group, pair, offsets_true)
    loss = sequence_loss(model(pair), offsets_true)
    return state, optimizer_step(state, loss, group)
