"""IMPALA's deep residual trunk (Espeholt et al. 2018, arXiv:1802.01561,
Fig. 3 right: "large architecture, 15 convolutional layers"), in NCHW.

Three sections, each a 3x3 conv (stride 1, pad 1), a 3x3 max-pool of
stride 2 padded by one -inf cell a side (TensorFlow's "SAME" sizes:
104 x 80 -> 52 x 40 -> 26 x 20 -> 13 x 10), then ``blocks`` residual
blocks ``x + conv(relu(conv(relu(x))))`` of 3x3 convs at pad 1; then
ReLU, a dense layer of ``feature_size`` and ReLU.  The input is cast to
the compute dtype and scaled by 1/``obs_divisor``, as the Nature trunk
(``conv.py:Conv2dModel``) does it.  The JAX package has no such trunk;
nothing here maps onto a flax tree.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rlpyt_tpu_torch.models.mlp import lecun_normal_

# IMPALA's published widths: channels of the three sections, residual
# blocks a section, the dense layer after them.
IMPALA_CHANNELS = (16, 32, 32)
IMPALA_BLOCKS = 2
IMPALA_FEATURES = 256


def _conv3x3(c_in: int, c_out: int) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, 3, padding=1)
    lecun_normal_(conv.weight, c_in * 9)
    nn.init.zeros_(conv.bias)
    return conv


def pooled_size(h: int) -> int:
    """A side after the 3x3, stride-2 max-pool at pad 1: ceil(h / 2)."""
    return (h + 2 - 3) // 2 + 1


class ResidualBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv0 = _conv3x3(channels, channels)
        self.conv1 = _conv3x3(channels, channels)

    def forward(self, x, dt):
        y = _conv(self.conv0, F.relu(x), dt)
        return x + _conv(self.conv1, F.relu(y), dt)


class ResNetSection(nn.Module):
    def __init__(self, c_in: int, c_out: int, blocks: int):
        super().__init__()
        self.conv = _conv3x3(c_in, c_out)
        self.blocks = nn.ModuleList(ResidualBlock(c_out)
                                    for _ in range(blocks))

    def forward(self, x, dt):
        x = F.max_pool2d(_conv(self.conv, x, dt), 3, stride=2, padding=1)
        for block in self.blocks:
            x = block(x, dt)
        return x


def _conv(conv: nn.Conv2d, x, dt):
    return F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1)


class ImpalaResNet(nn.Module):
    """[N, C, H, W] frames (any dtype, e.g. uint8) -> [N, feature_size]
    features in the compute dtype.  Parameters: ``sections.i.conv``,
    ``sections.i.blocks.j.conv{0,1}`` and ``fc``."""

    def __init__(self, image_shape: Tuple[int, int, int],
                 channels: Sequence[int] = IMPALA_CHANNELS,
                 blocks: int = IMPALA_BLOCKS,
                 feature_size: int = IMPALA_FEATURES,
                 obs_divisor: float = 255.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        c, h, w = image_shape
        self.sections = nn.ModuleList()
        for c_out in channels:
            self.sections.append(ResNetSection(c, c_out, blocks))
            c, h, w = c_out, pooled_size(h), pooled_size(w)
        self.fc = nn.Linear(c * h * w, feature_size)
        lecun_normal_(self.fc.weight, c * h * w)
        nn.init.zeros_(self.fc.bias)
        self.output_size = feature_size
        self.compute_dtype = compute_dtype
        # As Conv2dModel: the scale rounded to the compute dtype.
        self.input_scale = float(torch.tensor(1.0 / obs_divisor,
                                              dtype=compute_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt) * self.input_scale
        for section in self.sections:
            x = section(x, dt)
        x = F.relu(x).flatten(1)
        return F.relu(F.linear(x, self.fc.weight.to(dt),
                               self.fc.bias.to(dt)))
