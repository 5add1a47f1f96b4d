"""Deep homography regression with a differentiable ACA-rect solver head.

Port of ``sks_tpu/models/deep_homography.py``: stacked image pair -> small
CNN -> 4 corner offsets -> :func:`sks_tpu_torch.ops.aca_rect` -> H.  The
head is closed-form and division-free up to scale, so gradients flow through
~50 flops instead of a linear-system solve.

The JAX package's layers are flax ``nn.Conv`` / ``nn.Dense``; the port's
match them layer for layer, so a flax parameter tree carries across
(``sks_tpu_torch.utils.convert.homography_net_state_from``):

* ``'SAME'`` padding at stride 2 is asymmetric where the input is even (0
  before, 1 after, as XLA computes it) and :class:`SameConv2d` pads per
  dimension from the input's size; ``Conv2d(padding=1)`` would pad (1, 1).
* Inputs keep the JAX call shape, (B, H, W, C); the convolutions run NCHW,
  and the feature map is flattened in H, W, C order before the first dense
  layer, as flax flattens its NHWC map.
* Kernels start from flax's ``lecun_normal`` (a normal truncated at two
  standard deviations, variance 1 / fan-in) and biases from zero
  (:func:`init_like_flax`); torch's own defaults differ.
* The optimizer is Adam at 1e-4 with its defaults, the update of
  ``optax.adam(1e-4)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from sks_tpu_torch.features.descriptors import bilinear_sample
from sks_tpu_torch.geom.homography import apply_homography
from sks_tpu_torch.ops.aca_rect import aca_rect, rect_corners

__all__ = [
    "HomographyNet",
    "SameConv2d",
    "TrainState",
    "corner_loss",
    "create_train_state",
    "init_like_flax",
    "synth_training_batch",
    "train_step",
]

#: ``optax.adam``'s and ``torch.optim.Adam``'s learning rate in both packages.
LEARNING_RATE = 1e-4

# The standard deviation of a unit normal truncated at +-2, by which flax's
# ``variance_scaling`` divides to keep the variance it asks for.
_TRUNC_STD = 0.87962566103423978


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """(before, after) padding of XLA's 'SAME' for one spatial dimension."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """A 3 x 3, stride-2 ``nn.Conv2d`` with flax's 'SAME' padding (NCHW)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, stride=2)

    def forward(self, x: Tensor) -> Tensor:
        k, s = self.kernel_size, self.stride
        top, bottom = _same_pad(x.shape[-2], k[0], s[0])
        left, right = _same_pad(x.shape[-1], k[1], s[1])
        return super().forward(F.pad(x, (left, right, top, bottom)))


def _same_size(n: int, layers: int) -> int:
    """Spatial size after ``layers`` 'SAME' convolutions at stride 2."""
    for _ in range(layers):
        n = -(-n // 2)
    return n


@torch.no_grad()
def init_like_flax(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every conv and linear weight as flax's ``lecun_normal`` does and
    zero every bias, from ``generator`` on its own device."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight
            std = math.sqrt(1.0 / (w[0].numel())) / _TRUNC_STD
            draw = torch.empty(w.shape, dtype=torch.float32,
                               device=generator.device)
            nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            w.copy_(draw)
            m.bias.zero_()


class HomographyNet(nn.Module):
    """Small conv regressor: (B, H, W, 2) stacked pair -> (B, 4, 2) offsets."""

    def __init__(self, features: tuple = (32, 64, 128),
                 max_offset: float = 32.0, image_size: int = 64):
        super().__init__()
        self.features = tuple(features)
        self.max_offset = max_offset
        chans = (2,) + self.features
        self.convs = nn.ModuleList(
            SameConv2d(chans[i], chans[i + 1]) for i in range(len(features)))
        side = _same_size(image_size, len(features))
        self.dense0 = nn.Linear(side * side * self.features[-1], 256)
        self.dense1 = nn.Linear(256, 8)

    def forward(self, pair: Tensor) -> Tensor:
        x = pair.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # H, W, C order
        x = F.relu(self.dense0(x))
        x = self.dense1(x)
        return self.max_offset * torch.tanh(x).reshape(-1, 4, 2)

    def homography(self, pair: Tensor, origin: Tensor, size: Tensor) -> Tensor:
        """Predict H mapping the source rect to the target quad."""
        offsets = self(pair)
        corners = rect_corners(origin, size)
        return aca_rect(corners + offsets, origin, size)


def corner_loss(offsets_pred: Tensor, offsets_true: Tensor) -> Tensor:
    """Mean corner error (the standard deep-homography supervision)."""
    d = offsets_pred - offsets_true
    return torch.mean(torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12))


@dataclass
class TrainState:
    """What a step carries besides the module's own parameters: its Adam."""

    optimizer: torch.optim.Optimizer

    @classmethod
    def create(cls, model: nn.Module) -> TrainState:
        """A fresh ``Adam(lr=1e-4)`` over ``model``'s parameters."""
        return cls(torch.optim.Adam(model.parameters(), lr=LEARNING_RATE))


def create_train_state(generator: torch.Generator, image_size: int = 64,
                       dtype=torch.float32, device="cuda"):
    """``(HomographyNet, TrainState)`` initialized from ``generator`` as flax
    initializes, on ``device`` (the card unless the caller asks for the
    CPU)."""
    model = HomographyNet(image_size=image_size)
    init_like_flax(model, generator)
    model = model.to(device=device, dtype=dtype)
    return model, TrainState.create(model)


def optimizer_step(state: TrainState, loss: Tensor) -> Tensor:
    """Backpropagate ``loss`` and take one Adam step; returns the loss
    detached, on its device (nothing is read back)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    return loss.detach()


def train_step(model: HomographyNet, state: TrainState, pair: Tensor,
               offsets_true: Tensor):
    """One supervised step: ``(state, loss)``, the loss a 0-d tensor."""
    loss = corner_loss(model(pair), offsets_true)
    return state, optimizer_step(state, loss)


def synth_training_batch(generator: torch.Generator | None, batch: int,
                         image_size: int = 64, max_offset: float = 16.0,
                         dtype=torch.float32, device=None, *, draws=None):
    """Self-supervised data: warp random images by known corner offsets.

    Returns (pair (B, S, S, 2), offsets (B, 4, 2)).  The second channel is
    the first image warped by the homography induced by the offsets, exactly
    the signal the net must invert.  The image is multi-scale value noise (8
    x 8 coarse and 24 x 24 fine uniform draws, upsampled bilinearly), not
    per-pixel white noise, whose warps alias away all correspondence.

    ``draws=(coarse (B, 8, 8), fine (B, 24, 24), offsets (B, 4, 2))`` takes
    the three draws instead of drawing them from ``generator`` (the JAX
    package's draws, for parity).  ``device`` defaults to the generator's
    (the draws' when they are given).  Nothing is read back from the device.
    """
    if draws is None:
        dev = generator.device if device is None else torch.device(device)
        coarse, fine, u = (
            torch.rand(shape, generator=generator, device=generator.device,
                       dtype=dtype).to(dev)
            for shape in ((batch, 8, 8), (batch, 24, 24), (batch, 4, 2)))
        offsets = u * (2.0 * max_offset) - max_offset
    else:
        dev = draws[0].device if device is None else torch.device(device)
        coarse, fine, offsets = (torch.as_tensor(d, dtype=dtype, device=dev)
                                 for d in draws)

    def up(x):
        return F.interpolate(x[:, None], size=(image_size, image_size),
                             mode="bilinear", align_corners=False)[:, 0]

    img = (2.0 * up(coarse) + up(fine)) / 3.0
    origin = torch.zeros((batch, 2), dtype=dtype, device=dev)
    size = torch.full((batch, 2), float(image_size - 1), dtype=dtype,
                      device=dev)
    h = aca_rect(rect_corners(origin, size) + offsets, origin, size)

    xs = torch.arange(image_size, dtype=dtype, device=dev)
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1).reshape(-1, 2)  # (S*S, 2)
    src_pts = apply_homography(torch.linalg.inv_ex(h).inverse, grid)
    warped = bilinear_sample(img, src_pts).reshape(batch, image_size,
                                                   image_size)
    return torch.stack([img, warped], dim=-1), offsets
