"""Action/observation spaces (port of rlpyt_tpu/spaces.py: IntBox)."""
from __future__ import annotations

from typing import Tuple

import torch


class IntBox:
    """Discrete range [low, high)."""

    def __init__(self, low: int, high: int, shape: Tuple[int, ...] = (),
                 dtype=torch.int64):
        if high <= low:
            raise ValueError(f"IntBox needs high > low, got [{low}, {high})")
        self.low = low
        self.high = high
        self.shape = tuple(shape)
        self.dtype = dtype

    @property
    def n(self) -> int:
        return self.high - self.low

    def sample(self, generator: torch.Generator,
               batch_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """Uniform draws of shape ``batch_shape + shape`` on the
        generator's device."""
        return torch.randint(self.low, self.high,
                             tuple(batch_shape) + self.shape,
                             generator=generator, device=generator.device,
                             dtype=self.dtype)

    def null_value(self, device="cuda") -> torch.Tensor:
        """The zero element used to prefill buffers (prev_action at reset)."""
        return torch.zeros(self.shape, dtype=self.dtype, device=device)

    def __repr__(self):
        return f"IntBox({self.low}, {self.high}, shape={self.shape})"
