"""Algorithm base and optimizer helpers (port of rlpyt_tpu/algos/base.py:
global_norm and the clip-by-global-norm half of make_optimizer)."""
from __future__ import annotations

from typing import Iterable, List

import torch


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, as a device scalar."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """Clip in place with optax.clip_by_global_norm's formula: grads are
    left as they are when their norm is below ``max_norm`` and become
    ``g / norm * max_norm`` otherwise (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).  Returns the norm before
    clipping.  No host sync."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class RlAlgorithm:
    """Contract: ``initialize(agent, batch_spec, example_obs, generator)``
    then ``optimize(samples, cum_steps) -> OptInfo`` once per iteration."""

    def initialize(self, agent, batch_spec, example_obs,
                   generator: torch.Generator):
        raise NotImplementedError

    def optimize(self, samples, cum_steps: int):
        raise NotImplementedError
