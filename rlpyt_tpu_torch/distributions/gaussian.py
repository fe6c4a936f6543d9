"""Diagonal Gaussian with optional tanh squashing (port of
rlpyt_tpu/distributions/gaussian.py: DistInfoStd, Gaussian).

The options are the JAX package's: a fixed ``std`` (DDPG's and TD3's
exploration), a ``clip`` of the sample, a ``noise_clip`` of the noise
(TD3's target smoothing), ``min_std`` / ``max_std`` clamps of log_std,
and a tanh ``squash`` to a scale (SAC).  Standard normals come from an
explicit ``torch.Generator`` or are passed in (``noise=``), so that a test
can give the port JAX's draws.

The squashed log-likelihood subtracts the reference's tanh correction
log(1 - tanh(z)^2) = 2 (log 2 - z - softplus(-2 z)) and no log(squash)
term: that is the JAX package's convention, kept here.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from rlpyt_tpu_torch.struct import valid_mean

EPS = 1e-6
LOG2 = math.log(2.0)


class DistInfoStd(NamedTuple):
    mean: torch.Tensor
    log_std: torch.Tensor


def _tanh_correction(z: torch.Tensor) -> torch.Tensor:
    """log(1 - tanh(z)^2), summed over the last axis."""
    return torch.sum(2.0 * (LOG2 - z - F.softplus(-2.0 * z)), dim=-1)


class Gaussian:
    def __init__(self, dim: int, std: Optional[float] = None,
                 clip: Optional[float] = None,
                 noise_clip: Optional[float] = None,
                 min_std: Optional[float] = None,
                 max_std: Optional[float] = None,
                 squash: Optional[float] = None):
        self.dim = dim
        self.std = std
        self.clip = clip
        self.noise_clip = noise_clip
        self.min_std = min_std
        self.max_std = max_std
        self.squash = squash

    def _effective_std(self, dist_info: DistInfoStd) -> torch.Tensor:
        if self.std is not None:
            return torch.full_like(dist_info.mean, self.std)
        log_std = dist_info.log_std
        if self.min_std is not None or self.max_std is not None:
            lo = math.log(self.min_std) if self.min_std else -math.inf
            hi = math.log(self.max_std) if self.max_std else math.inf
            log_std = torch.clamp(log_std, lo, hi)
        return torch.exp(log_std)

    @staticmethod
    def _normal(mean: torch.Tensor, generator: Optional[torch.Generator],
                noise: Optional[torch.Tensor]) -> torch.Tensor:
        """Standard normals shaped like ``mean``: ``noise`` if given, else
        drawn from ``generator``."""
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=generator.device)
        return noise.to(mean.device, mean.dtype)

    def sample(self, dist_info: DistInfoStd,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        std = self._effective_std(dist_info)
        eps = std * self._normal(dist_info.mean, generator, noise)
        if self.noise_clip is not None:
            eps = torch.clamp(eps, -self.noise_clip, self.noise_clip)
        sample = dist_info.mean + eps
        if self.clip is not None:
            sample = torch.clamp(sample, -self.clip, self.clip)
        if self.squash is not None:
            sample = self.squash * torch.tanh(sample)
        return sample

    def sample_with_log_prob(self, dist_info: DistInfoStd,
                             generator: Optional[torch.Generator] = None,
                             noise: Optional[torch.Tensor] = None):
        """Reparameterized sample and its log-likelihood (the SAC
        path)."""
        std = self._effective_std(dist_info)
        z = dist_info.mean + std * self._normal(dist_info.mean, generator,
                                                noise)
        logp = self._normal_log_prob(z, dist_info.mean, std)
        if self.squash is None:
            return z, logp
        return self.squash * torch.tanh(z), logp - _tanh_correction(z)

    @staticmethod
    def _normal_log_prob(x, mean, std) -> torch.Tensor:
        var = std ** 2
        return torch.sum(-((x - mean) ** 2) / (2 * var) - torch.log(std)
                         - 0.5 * math.log(2 * math.pi), dim=-1)

    def log_likelihood(self, x: torch.Tensor,
                       dist_info: DistInfoStd) -> torch.Tensor:
        std = self._effective_std(dist_info)
        if self.squash is None:
            return self._normal_log_prob(x, dist_info.mean, std)
        # Invert the squash: z = atanh(x / squash).
        z = torch.atanh(torch.clamp(x / self.squash, -1 + EPS, 1 - EPS))
        return (self._normal_log_prob(z, dist_info.mean, std)
                - _tanh_correction(z))

    def likelihood_ratio(self, x, old_dist_info: DistInfoStd,
                         new_dist_info: DistInfoStd) -> torch.Tensor:
        return torch.exp(self.log_likelihood(x, new_dist_info)
                         - self.log_likelihood(x, old_dist_info))

    def kl(self, old: DistInfoStd, new: DistInfoStd) -> torch.Tensor:
        old_std = self._effective_std(old)
        new_std = self._effective_std(new)
        return torch.sum(
            torch.log(new_std / (old_std + EPS) + EPS)
            + (old_std ** 2 + (old.mean - new.mean) ** 2)
            / (2 * new_std ** 2 + EPS) - 0.5, dim=-1)

    def entropy(self, dist_info: DistInfoStd) -> torch.Tensor:
        std = self._effective_std(dist_info)
        return torch.sum(torch.log(std + EPS)
                         + 0.5 * (1.0 + math.log(2 * math.pi)), dim=-1)

    def perplexity(self, dist_info: DistInfoStd) -> torch.Tensor:
        return torch.exp(self.entropy(dist_info))

    def mean_kl(self, old, new, valid=None) -> torch.Tensor:
        return valid_mean(self.kl(old, new), valid)

    def mean_entropy(self, dist_info, valid=None) -> torch.Tensor:
        return valid_mean(self.entropy(dist_info), valid)
