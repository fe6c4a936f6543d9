"""Action/observation spaces (port of rlpyt_tpu/spaces.py: Space,
IntBox, FloatBox, Composite)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

import torch


class Space:
    """Interface: ``sample`` draws from a ``torch.Generator`` on its
    device, ``null_value`` is the zero element used to prefill buffers
    (prev_action at reset)."""

    shape: Optional[Tuple[int, ...]]
    dtype: Any

    def sample(self, generator: torch.Generator,
               batch_shape: Tuple[int, ...] = ()):
        raise NotImplementedError

    def null_value(self, device="cuda"):
        raise NotImplementedError


class IntBox(Space):
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


class FloatBox(Space):
    """Continuous box [low, high] of float32 (bounds broadcast to
    ``shape``)."""

    def __init__(self, low, high, shape: Optional[Tuple[int, ...]] = None,
                 dtype=torch.float32):
        low = np.asarray(low, dtype=np.float32)
        high = np.asarray(high, dtype=np.float32)
        if shape is None:
            shape = np.broadcast_shapes(low.shape, high.shape)
        self.low = np.broadcast_to(low, shape).astype(np.float32)
        self.high = np.broadcast_to(high, shape).astype(np.float32)
        self.shape = tuple(shape)
        self.dtype = dtype

    def sample(self, generator: torch.Generator,
               batch_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """Uniform draws of shape ``batch_shape + shape`` on the
        generator's device."""
        dev = generator.device
        u = torch.rand(tuple(batch_shape) + self.shape, generator=generator,
                       device=dev, dtype=self.dtype)
        low = torch.as_tensor(self.low, dtype=self.dtype, device=dev)
        high = torch.as_tensor(self.high, dtype=self.dtype, device=dev)
        return low + u * (high - low)

    def null_value(self, device="cuda") -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=device)

    def __repr__(self):
        return f"FloatBox(shape={self.shape})"


class Composite(Space):
    """A dict of spaces, mapped onto a dict observation.  ``sample``
    draws each subspace in the dict's order from the one generator."""

    def __init__(self, spaces: Dict[str, object]):
        self.spaces = dict(spaces)
        self.shape = None
        self.dtype = None

    def sample(self, generator: torch.Generator,
               batch_shape: Tuple[int, ...] = ()) -> dict:
        return {name: space.sample(generator, batch_shape)
                for name, space in self.spaces.items()}

    def null_value(self, device="cuda") -> dict:
        return {name: space.null_value(device)
                for name, space in self.spaces.items()}

    def __repr__(self):
        return f"Composite({self.spaces})"
