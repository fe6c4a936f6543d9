"""Epsilon-greedy action selection (port of
rlpyt_tpu/distributions/epsilon_greedy.py: EpsilonGreedy,
CategoricalEpsilonGreedy)."""
from __future__ import annotations

import torch


class EpsilonGreedy:
    def sample(self, q: torch.Tensor, epsilon, generator: torch.Generator
               ) -> torch.Tensor:
        """q: [..., A]; epsilon: a float or a tensor on q's device
        broadcastable to q.shape[:-1] (e.g. R2D1's per-lane [B]
        epsilons).  Returns int64 actions."""
        greedy = torch.argmax(q, dim=-1)
        shape, dev = greedy.shape, generator.device
        rand = torch.randint(0, q.shape[-1], shape, generator=generator,
                             device=dev).to(q.device)
        explore = torch.rand(shape, generator=generator,
                             device=dev).to(q.device) < epsilon
        return torch.where(explore, rand, greedy)


class CategoricalEpsilonGreedy(EpsilonGreedy):
    """Greedy over the expected value of the atom distribution (C51)."""

    def __init__(self, z: torch.Tensor):
        self.z = z   # atom support [n_atoms], on the agent's device

    def sample(self, p: torch.Tensor, epsilon, generator: torch.Generator
               ) -> torch.Tensor:
        """p: [..., A, n_atoms] probabilities over atoms."""
        return super().sample((p * self.z).sum(-1), epsilon, generator)
