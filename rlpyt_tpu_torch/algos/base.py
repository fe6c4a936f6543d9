"""Algorithm base and optimizer helpers (port of rlpyt_tpu/algos/base.py:
global_norm, make_optimizer, RlAlgorithm).

``make_optimizer`` gives what the JAX package's optax chain computes:
clip-by-global-norm (optional), then Adam or RMSprop, at a constant
learning rate or one annealed linearly to 0.  RMSprop is written here
because ``torch.optim.RMSprop`` computes another formula (``alpha`` 0.99
and ``g / (sqrt(v) + eps)`` against optax's decay 0.9 and
``g / sqrt(v + eps)``).  The schedule's step count is a host integer, so
a step costs no device sync.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
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


class RMSprop(torch.optim.Optimizer):
    """optax.rmsprop (0.2.6): ``nu = decay nu + (1 - decay) g^2`` from 0,
    then ``p -= lr g / sqrt(nu + eps)``; ``centered`` also keeps
    ``mu = decay mu + (1 - decay) g`` and divides by
    ``sqrt(nu - mu^2 + eps)``."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8, centered: bool = False):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      centered=centered))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            decay, eps = group["decay"], group["eps"]
            params = [p for p in group["params"] if p.grad is not None]
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p]["nu"] = torch.zeros_like(p)
                    if group["centered"]:
                        self.state[p]["mu"] = torch.zeros_like(p)
            nu = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(nu, decay)
            torch._foreach_add_(nu, torch._foreach_mul(grads, grads),
                                alpha=1.0 - decay)
            denom = nu
            if group["centered"]:
                mu = [self.state[p]["mu"] for p in params]
                torch._foreach_mul_(mu, decay)
                torch._foreach_add_(mu, grads, alpha=1.0 - decay)
                denom = torch._foreach_sub(nu, torch._foreach_mul(mu, mu))
            scale = torch._foreach_add(denom, eps)
            torch._foreach_rsqrt_(scale)
            torch._foreach_mul_(scale, grads)
            torch._foreach_add_(params, scale, alpha=-group["lr"])


class Optimizer:
    """The optax chain of the JAX package's ``make_optimizer`` over a
    model's parameters.  ``step()`` reads the parameters' ``.grad``,
    clips them (if ``clip_grad_norm``), sets the learning rate of this
    update and steps; it returns the gradients' global norm before
    clipping, as a device scalar."""

    def __init__(self, params, learning_rate: float,
                 clip_grad_norm: Optional[float] = None, optim: str = "adam",
                 schedule_steps: Optional[int] = None, **optim_kwargs):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.clip_grad_norm = clip_grad_norm
        self.schedule_steps = schedule_steps
        self.count = 0
        if optim == "adam":
            self.inner = torch.optim.Adam(
                self.params, lr=learning_rate,
                **{"eps": 1e-8, **optim_kwargs})
        elif optim == "rmsprop":
            self.inner = RMSprop(self.params, lr=learning_rate,
                                 **optim_kwargs)
        else:
            raise ValueError(f"unknown optimizer {optim!r}")

    def lr(self, count: int) -> float:
        """optax.linear_schedule(lr, 0, schedule_steps) at update
        ``count``, in float32 as optax computes it; the constant rate
        without a schedule."""
        if self.schedule_steps is None:
            return self.learning_rate
        frac = np.float32(1.0) - (np.float32(min(count, self.schedule_steps))
                                  / np.float32(self.schedule_steps))
        return float(np.float32(self.learning_rate) * frac)

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=False)

    def step(self) -> torch.Tensor:
        grads = [p.grad for p in self.params]
        if self.clip_grad_norm is not None:
            norm = clip_by_global_norm_(grads, self.clip_grad_norm)
        else:
            norm = global_norm(grads)
        for group in self.inner.param_groups:
            group["lr"] = self.lr(self.count)
        self.inner.step()
        self.count += 1
        return norm


def make_optimizer(params, learning_rate: float,
                   clip_grad_norm: Optional[float] = None,
                   optim: str = "adam", schedule_steps: Optional[int] = None,
                   **optim_kwargs) -> Optimizer:
    """Adam or RMSprop after optional clip-by-global-norm; with
    ``schedule_steps``, the rate falls linearly from ``learning_rate`` at
    update 0 to 0 at update ``schedule_steps`` and stays there."""
    return Optimizer(params, learning_rate, clip_grad_norm, optim,
                     schedule_steps, **optim_kwargs)


class RlAlgorithm:
    """Contract: ``initialize(agent, batch_spec, example_obs, generator,
    n_itr)`` once (``n_itr``: the run's iterations, which a learning-rate
    schedule spans), then ``optimize(samples, rollout_state) -> OptInfo``
    once per iteration, with the collector's state after the batch
    (``cum_steps`` for schedules; the last observation and carry for a
    bootstrap value)."""

    def initialize(self, agent, batch_spec, example_obs,
                   generator: torch.Generator, n_itr: int = 1):
        raise NotImplementedError

    def optimize(self, samples, rollout_state):
        raise NotImplementedError
