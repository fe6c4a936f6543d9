"""MLP trunk (port of rlpyt_tpu/models/mlp.py:MlpModel).

Parameters stay float32; every layer computes in ``compute_dtype`` with
an explicit cast of input, weight and bias, and the output is cast back
to float32 so losses and targets accumulate at full precision.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rlpyt_tpu_torch.parallel.mesh import layer_apply


def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled so the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std)


class MlpModel(nn.Module):
    def __init__(self, input_size: int, hidden_sizes: Sequence[int],
                 output_size: Optional[int] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        sizes = list(hidden_sizes)
        if output_size is not None:
            sizes.append(output_size)
        self.layers = nn.ModuleList()
        for n_in, n_out in zip([input_size] + sizes[:-1], sizes):
            layer = nn.Linear(n_in, n_out)
            lecun_normal_(layer.weight, n_in)
            nn.init.zeros_(layer.bias)
            self.layers.append(layer)
        self.n_hidden = len(hidden_sizes)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        for i, layer in enumerate(self.layers):
            x = layer_apply(layer, lambda x, w, b: F.linear(
                x, w.to(dt), b.to(dt)), x)
            if i < self.n_hidden:
                x = F.relu(x)
        return x.to(torch.float32)
