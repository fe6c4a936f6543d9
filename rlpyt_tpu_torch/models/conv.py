"""Conv trunk and conv-plus-MLP model (port of
rlpyt_tpu/models/conv.py:Conv2dModel, Conv2dHeadModel), in NCHW.

The JAX package folds the first stride-s layer into a space-to-depth 3D
conv and runs the trunk batch-minor, both to suit XLA:TPU's conv
emitters.  Neither form is carried over: here the first layer is the
ordinary strided ``F.conv2d`` that those forms compute exactly, and the
output keeps PyTorch's NCHW layout, whose flatten order (C, H', W') is
the one the JAX trunk emits.  The JAX package has no Pallas kernel for
convolutions, so none is written here either.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rlpyt_tpu_torch.models.mlp import MlpModel, lecun_normal_
from rlpyt_tpu_torch.parallel.mesh import layer_apply


class Conv2dModel(nn.Module):
    def __init__(self, in_channels: int, channels: Sequence[int],
                 kernel_sizes: Sequence[int], strides: Sequence[int],
                 paddings: Optional[Sequence[int]] = None,
                 nonlinearity: Callable = F.relu,
                 compute_dtype: torch.dtype = torch.float32,
                 input_scale: float = 1.0):
        super().__init__()
        paddings = list(paddings or [0] * len(channels))
        self.convs = nn.ModuleList()
        for c_in, c_out, k, s, p in zip([in_channels] + list(channels[:-1]),
                                        channels, kernel_sizes, strides,
                                        paddings):
            conv = nn.Conv2d(c_in, c_out, k, stride=s, padding=p)
            lecun_normal_(conv.weight, c_in * k * k)
            nn.init.zeros_(conv.bias)
            self.convs.append(conv)
        self.nonlinearity = nonlinearity
        self.compute_dtype = compute_dtype
        # The scale rounded to the compute dtype, as a Python float so the
        # multiply launches no host-to-device copy.
        self.input_scale = float(torch.tensor(input_scale,
                                              dtype=compute_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, C, H, W] (any dtype, e.g. uint8) -> [N, C', H', W'] in the
        compute dtype.  The input is cast first and then scaled in the
        compute dtype, as the JAX trunk does."""
        dt = self.compute_dtype
        x = x.to(dt)
        if self.input_scale != 1.0:
            x = x * self.input_scale
        for conv in self.convs:
            x = layer_apply(conv, lambda x, w, b: F.conv2d(
                x, w.to(dt), b.to(dt), stride=conv.stride,
                padding=conv.padding), x)
            x = self.nonlinearity(x)
        return x

    @staticmethod
    def conv_out_size(channels, kernel_sizes, strides, paddings,
                      h: int, w: int) -> int:
        paddings = paddings or [0] * len(channels)
        for k, s, p in zip(kernel_sizes, strides, paddings):
            h = (h + 2 * p - k) // s + 1
            w = (w + 2 * p - k) // s + 1
        return channels[-1] * h * w


class Conv2dHeadModel(nn.Module):
    """Conv trunk, flattened in NCHW order, then an MLP of
    ``hidden_sizes`` (and a linear ``output_size`` layer when given),
    with ``nonlinearity`` after every conv and hidden layer.  flax sizes
    the head from the first input; here ``in_channels`` and
    ``image_shape`` (h, w) size it.  The JAX module's trunk is the plain
    one (no space-to-depth), so its tree maps onto this state_dict
    without re-blocking (params.py)."""

    space_to_depth = False

    def __init__(self, in_channels: int, image_shape: Tuple[int, int],
                 channels: Sequence[int], kernel_sizes: Sequence[int],
                 strides: Sequence[int], hidden_sizes: Sequence[int],
                 paddings: Optional[Sequence[int]] = None,
                 output_size: Optional[int] = None,
                 nonlinearity: Callable = F.relu,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2dModel(in_channels, channels, kernel_sizes, strides,
                                paddings, nonlinearity, compute_dtype)
        n_feat = Conv2dModel.conv_out_size(channels, kernel_sizes, strides,
                                           paddings, *image_shape)
        self.head = MlpModel(n_feat, hidden_sizes, output_size, nonlinearity,
                             compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, C, H, W] -> [N, output_size or hidden_sizes[-1]], float32."""
        x = self.conv(x)
        return self.head(x.reshape(x.shape[0], -1))
