"""DQN model (port of rlpyt_tpu/models/dqn.py:AtariDqnModel, non-dueling).

Accepts observations with [], [B] or [T,B] leading dims and uint8
images in [C, H, W] layout, scaled by 1/``obs_divisor`` inside the model.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from rlpyt_tpu_torch.models.conv import Conv2dModel
from rlpyt_tpu_torch.models.mlp import MlpModel
from rlpyt_tpu_torch.struct import infer_leading_dims, restore_leading_dims

# Nature-CNN geometry as rlpyt adapts it to 104x80 frames.
ATARI_CHANNELS = (32, 64, 64)
ATARI_KERNELS = (8, 4, 3)
ATARI_STRIDES = (4, 2, 1)
ATARI_PADDINGS = (0, 1, 1)


class AtariDqnModel(nn.Module):
    """Conv trunk -> MLP Q head.  Submodule names (``conv.convs.i``,
    ``head.layers.i``) are what the weight bridge (params.py) maps the
    flax tree onto."""

    def __init__(self, image_shape: Tuple[int, int, int], n_actions: int,
                 fc_sizes: Sequence[int] = (512,),
                 channels: Sequence[int] = ATARI_CHANNELS,
                 kernel_sizes: Sequence[int] = ATARI_KERNELS,
                 strides: Sequence[int] = ATARI_STRIDES,
                 paddings: Sequence[int] = ATARI_PADDINGS,
                 obs_divisor: float = 255.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        c, h, w = image_shape
        self.conv = Conv2dModel(c, channels, kernel_sizes, strides, paddings,
                                compute_dtype=compute_dtype,
                                input_scale=1.0 / obs_divisor)
        n_feat = Conv2dModel.conv_out_size(channels, kernel_sizes, strides,
                                           paddings, h, w)
        self.head = MlpModel(n_feat, fc_sizes, n_actions,
                             compute_dtype=compute_dtype)

    def forward(self, observation, prev_action=None, prev_reward=None):
        lead_dim, T, B, img_shape = infer_leading_dims(observation, 3)
        x = self.conv(observation.reshape((T * B,) + img_shape))
        q = self.head(x.reshape(T * B, -1))
        return restore_leading_dims(q, lead_dim, T, B)
