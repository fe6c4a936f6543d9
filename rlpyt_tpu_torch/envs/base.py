"""Environment interface (port of rlpyt_tpu/envs/base.py).

The JAX package writes a single-env pure function and vmaps it; here an
env is written directly on batched tensors: ``reset_batch`` and
``step_batch`` act on a [B] state held on the env's device.  Randomness
comes from an explicit ``torch.Generator``, passed to both.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch


class EnvStep(NamedTuple):
    observation: Any
    reward: torch.Tensor
    done: torch.Tensor
    info: Dict[str, torch.Tensor]


class EnvSpaces(NamedTuple):
    observation: Any
    action: Any


class Env:
    """Batched tensor environment; all mutable state is the ``state``
    tree the caller threads through."""

    device: torch.device

    @property
    def observation_space(self):
        raise NotImplementedError

    @property
    def action_space(self):
        raise NotImplementedError

    @property
    def spaces(self) -> EnvSpaces:
        return EnvSpaces(self.observation_space, self.action_space)

    @property
    def horizon(self):
        """The episode cap the env enforces itself; None for none."""
        return None

    def reset_batch(self, n: int, generator: torch.Generator
                    ) -> Tuple[Any, Any]:
        """Fresh state and observation for ``n`` lanes."""
        raise NotImplementedError

    def step_batch(self, state, action: torch.Tensor,
                   generator: torch.Generator) -> Tuple[Any, EnvStep]:
        """One step of every lane; a stochastic env draws from
        ``generator``."""
        raise NotImplementedError
