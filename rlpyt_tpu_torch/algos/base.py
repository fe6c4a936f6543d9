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

from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from rlpyt_tpu_torch.parallel.mesh import is_sharded, shard_like, \
    vector_norm
from rlpyt_tpu_torch.struct import load_state, state_of, valid_mean

# The inner optimizer's choices of kernel, which its state_dict saves
# with each group.
_KERNEL_SETTINGS = ("fused", "capturable", "foreach")


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (each whole, when split
    over 'mp'), as a device scalar."""
    return torch.linalg.vector_norm(
        torch.stack([vector_norm(t) for t in tensors]))


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
        g = g.to_local() if is_sharded(g) else g
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
    sums them over the data-parallel ranks (with ``shard``, a
    ``parallel.mesh.DpShard``), clips them (if ``clip_grad_norm``), sets
    the learning rate of this update and steps; it returns the gradients'
    global norm before clipping, as a device scalar."""

    def __init__(self, params, learning_rate: float,
                 clip_grad_norm: Optional[float] = None, optim: str = "adam",
                 schedule_steps: Optional[int] = None, shard=None,
                 **optim_kwargs):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.clip_grad_norm = clip_grad_norm
        self.schedule_steps = schedule_steps
        self.shard = shard
        self.count = 0
        # Parameters split over 'mp' (DTensors) step in a group of their
        # own: the multi-tensor kernels take no mix of the two kinds.
        groups = [{"params": g} for g in (
            [p for p in self.params if not is_sharded(p)],
            [p for p in self.params if is_sharded(p)]) if g]
        if optim == "adam":
            self.inner = torch.optim.Adam(
                groups, lr=learning_rate, **{"eps": 1e-8, **optim_kwargs})
        elif optim == "rmsprop":
            self.inner = RMSprop(groups, lr=learning_rate, **optim_kwargs)
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

    def reduce_grads(self, grads: List[torch.Tensor]) -> None:
        """Sum ``grads`` over the data-parallel ranks, in place (before
        the clip, so that it sees the global norm)."""
        if self.shard is not None:
            self.shard.all_reduce_grads_(grads)

    def step(self, apply: Optional[Callable[[], torch.Tensor]] = None
             ) -> torch.Tensor:
        """Set this update's rate, then ``apply()`` (or ``apply``, a
        replay of its CUDA graph in R2D1's update), then count the
        update."""
        for group in self.inner.param_groups:
            group["lr"] = self.lr(self.count)
        norm = (apply or self.apply)()
        self.count += 1
        return norm

    def apply(self) -> torch.Tensor:
        """The step's device work at the rate set: the gradients summed
        over the ranks and clipped, then the inner optimizer's step.
        It changes no host state, so a CUDA graph can hold it."""
        grads = [p.grad for p in self.params]
        self.reduce_grads(grads)
        if self.clip_grad_norm is not None:
            norm = clip_by_global_norm_(grads, self.clip_grad_norm)
        else:
            norm = global_norm(grads)
        self.inner.step()
        return norm

    def state_dict(self) -> dict:
        """The update count (the schedule's position) and the inner
        optimizer's moments."""
        return {"count": self.count, "inner": self.inner.state_dict()}

    def load_state_dict(self, state: dict):
        """Load ``state_dict()``; the moments of a parameter split over
        'mp', saved whole, are cut to this rank's shard.  The kernel
        settings (``fused``, ``capturable``, ``foreach``) stay this
        optimizer's, whatever the saving one used: they follow the device
        (R2D1's on a card), and the step counts are placed by them."""
        self.count = int(state["count"])
        inner = dict(state["inner"])
        inner["param_groups"] = [
            {**saved, **{k: group[k] for k in _KERNEL_SETTINGS if k in group}}
            for saved, group in zip(inner["param_groups"],
                                    self.inner.param_groups)]
        self.inner.load_state_dict(inner)
        for p in self.params:
            if is_sharded(p):
                moments = self.inner.state[p]
                for k, v in moments.items():
                    if not is_sharded(v) and tuple(v.shape) == tuple(p.shape):
                        moments[k] = shard_like(v, p)


def make_optimizer(params, learning_rate: float,
                   clip_grad_norm: Optional[float] = None,
                   optim: str = "adam", schedule_steps: Optional[int] = None,
                   shard=None, **optim_kwargs) -> Optimizer:
    """Adam or RMSprop after optional clip-by-global-norm; with
    ``schedule_steps``, the rate falls linearly from ``learning_rate`` at
    update 0 to 0 at update ``schedule_steps`` and stays there; with
    ``shard``, the gradients are summed over the data-parallel ranks
    first."""
    return Optimizer(params, learning_rate, clip_grad_norm, optim,
                     schedule_steps, shard, **optim_kwargs)


class RlAlgorithm:
    """Contract: ``initialize(agent, batch_spec, example_obs, generator,
    n_itr)`` once (``n_itr``: the run's iterations, which a learning-rate
    schedule spans), then ``optimize(samples, rollout_state) -> OptInfo``
    once per iteration, with the collector's state after the batch
    (``cum_steps`` for schedules; the last observation and carry for a
    bootstrap value).  ``state_dict()`` / ``load_state_dict()`` after
    ``initialize`` hold everything an update reads besides the agent's
    model and the generator (which the runner keeps).

    ``shard`` (a ``parallel.mesh.DpShard``, set by ``SyncRl`` before
    ``initialize`` when the data-parallel axis has more than one rank):
    the batch spec is the global one, the collected batches hold this
    rank's lanes, replay draws are made over all lanes and each rank
    takes the loss over its own rows, with every mean over all ranks'
    rows (``_mean``); the diagnostics an update returns are whole
    (``_whole``)."""

    shard = None

    # What state_dict() holds (struct.py:state_of): each algorithm names
    # its target networks, optimizers, update counter and replay.
    state_attrs: tuple = ("optimizer", "update_counter")

    def initialize(self, agent, batch_spec, example_obs,
                   generator: torch.Generator, n_itr: int = 1):
        raise NotImplementedError

    def _mean(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None,
              n: Optional[int] = None) -> torch.Tensor:
        """``valid_mean(x, valid)``; under a data-parallel shard, this
        rank's share of the mean over every rank's entries (``n`` of them
        in all when ``valid`` is None)."""
        if self.shard is None:
            return valid_mean(x, valid)
        return self.shard.mean(x, valid, n)

    def _global_mean(self, x: torch.Tensor,
                     valid: Optional[torch.Tensor] = None,
                     n: Optional[int] = None) -> torch.Tensor:
        """``valid_mean(x, valid)``; under a shard, the mean over every
        rank's entries on every rank (no gradient flows through it)."""
        if self.shard is None:
            return valid_mean(x, valid)
        return self.shard.all_reduce_(self.shard.mean(x, valid, n).detach())

    def _whole(self, *shares: torch.Tensor) -> tuple:
        """The means of which ``shares`` (detached 0-dim tensors from
        ``_mean``) are this rank's shares, summed over the data-parallel
        ranks in one all-reduce, so that the diagnostics an update
        reports are whole on every rank; without a shard, ``shares`` as
        they are."""
        if self.shard is None:
            return shares
        return tuple(self.shard.all_reduce_(torch.stack(shares)).unbind())

    def optimize(self, samples, rollout_state):
        raise NotImplementedError

    def state_dict(self) -> dict:
        return state_of(self, self.state_attrs)

    def load_state_dict(self, state: dict):
        load_state(self, state, self.state_attrs)
