"""Categorical distribution over the last axis (port of
rlpyt_tpu/distributions/categorical.py: DistInfo, Categorical).

Probabilities are clamped at ``EPS`` before every log, as in the JAX
package.  ``jax.random.categorical`` is the argmax of the logits plus
Gumbel noise; ``sample`` does the same, with noise drawn from an explicit
``torch.Generator`` or passed in (``gumbel=``), so that a test can give
it JAX's noise and get JAX's actions.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rlpyt_tpu_torch.struct import valid_mean

EPS = 1e-8


class DistInfo(NamedTuple):
    prob: torch.Tensor   # [..., n]


def _at(prob: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.gather(prob, -1, x.long().unsqueeze(-1)).squeeze(-1)


class Categorical:
    def __init__(self, dim: int):
        self.dim = dim

    def sample(self, dist_info: DistInfo,
               generator: Optional[torch.Generator] = None,
               gumbel_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """argmax(log p + Gumbel noise) over the last axis, int64.  The
        noise is ``gumbel_noise`` if given, else -log(-log(u)) with u
        uniform in [tiny, 1) from ``generator``, as ``jax.random.gumbel``
        draws it."""
        logits = torch.log(dist_info.prob.clamp_min(EPS))
        if gumbel_noise is None:
            u = torch.rand(logits.shape, generator=generator,
                           device=generator.device)
            gumbel_noise = -torch.log(-torch.log(
                u.clamp_min(torch.finfo(u.dtype).tiny)))
        return torch.argmax(logits + gumbel_noise.to(logits.device), dim=-1)

    def log_likelihood(self, x, dist_info: DistInfo) -> torch.Tensor:
        return torch.log(_at(dist_info.prob, x).clamp_min(EPS))

    def likelihood_ratio(self, x, old_dist_info: DistInfo,
                         new_dist_info: DistInfo) -> torch.Tensor:
        return ((_at(new_dist_info.prob, x) + EPS)
                / (_at(old_dist_info.prob, x) + EPS))

    def kl(self, old: DistInfo, new: DistInfo) -> torch.Tensor:
        p, q = old.prob, new.prob
        return torch.sum(p * (torch.log(p.clamp_min(EPS))
                              - torch.log(q.clamp_min(EPS))), dim=-1)

    def entropy(self, dist_info: DistInfo) -> torch.Tensor:
        p = dist_info.prob
        return -torch.sum(p * torch.log(p.clamp_min(EPS)), dim=-1)

    def perplexity(self, dist_info: DistInfo) -> torch.Tensor:
        return torch.exp(self.entropy(dist_info))

    def mean_kl(self, old, new, valid=None) -> torch.Tensor:
        return valid_mean(self.kl(old, new), valid)

    def mean_entropy(self, dist_info, valid=None) -> torch.Tensor:
        return valid_mean(self.entropy(dist_info), valid)
