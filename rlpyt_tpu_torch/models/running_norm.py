"""Running observation normalization (port of
rlpyt_tpu/models/running_norm.py: RunningMeanStd).

The statistics are the flax ``norm_stats`` collection: mean 0, var 1
and count 1e-4 at the start.  ``forward(x, update=True)`` first folds the
batch's moments in by Chan's parallel update; then x is normalized and
clipped at +-``clip``.

The JAX package's models call it with ``update=False`` only, so no
moment ever reaches the statistics.  Its policy-gradient algorithms,
though, differentiate the model's whole variable dict, ``norm_stats``
included, and step it with the optimizer: mean and var move by gradient
descent like weights, and count (absent from the forward pass, so its
gradient is 0) stays.  The port copies that: mean and var are
parameters, count is a buffer.
"""
from __future__ import annotations

import torch
from torch import nn


class RunningMeanStd(nn.Module):
    def __init__(self, size: int, clip: float = 10.0):
        super().__init__()
        self.clip = clip
        self.mean = nn.Parameter(torch.zeros(size))
        self.var = nn.Parameter(torch.ones(size))
        self.register_buffer("count", torch.full((), 1e-4))

    @torch.no_grad()
    def update(self, x: torch.Tensor):
        flat = x.reshape(-1, self.mean.shape[0]).to(torch.float32)
        b_mean = flat.mean(0)
        b_var = flat.var(0, unbiased=False)
        b_count = float(flat.shape[0])
        delta = b_mean - self.mean
        tot = self.count + b_count
        m2 = (self.var * self.count + b_var * b_count
              + delta ** 2 * self.count * b_count / tot)
        self.mean.add_(delta * b_count / tot)
        self.var.copy_(m2 / tot)
        self.count.copy_(tot)

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        if update:
            self.update(x)
        normed = (x - self.mean) * torch.rsqrt(self.var + 1e-8)
        return torch.clamp(normed, -self.clip, self.clip)
