"""Prioritized replay (port of rlpyt_tpu/replay/prioritized.py).

Priorities live as a dense [size_T, B] float32 tensor of p^alpha on the
buffer's device (0 = unsampleable); under a data-parallel shard every
rank keeps the whole table (it is small) and only the ring is split.
Sampling is stratified inverse-CDF over their prefix sum (``cumsum`` +
right-sided ``searchsorted``), one uniform per stratum; importance
weights are (1 / (N P))^beta normalised by their max.  New rows take the
largest priority seen so far; updates clip at 1e-6.

``stratified_idxs`` and ``importance_weights`` are shared with the
sequence buffers (replay/sequence.py).  As there, sampling is split into
``sample_idxs`` (draws the uniforms) and ``idxs_from_uniforms``, so tests
can inject the draws.
"""
from __future__ import annotations

from typing import Tuple

import torch

from rlpyt_tpu_torch.replay.base import BaseReplayBuffer, SamplesFromReplay, \
    SamplesToBuffer, ShardRows, local_draw


def stratified_idxs(flat: torch.Tensor, u: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse-CDF draws over the priority mass ``flat`` [N] (>= 0) from
    uniforms ``u`` [b] in [0, 1): draw i falls in stratum i of b equal
    shares of the total.  Returns (int64 indices [b], the total mass)."""
    b = u.shape[0]
    cdf = torch.cumsum(flat, dim=0)
    total = cdf[-1]
    targets = (torch.arange(b, device=flat.device) + u) * (total / b)
    idx = torch.searchsorted(cdf, targets, right=True)
    return torch.clamp(idx, max=flat.shape[0] - 1), total


def importance_weights(flat: torch.Tensor, idx: torch.Tensor,
                       total: torch.Tensor, beta: float) -> torch.Tensor:
    """(1 / (n_valid * P(idx)))^beta, normalised by the largest weight."""
    n_valid = torch.clamp((flat > 0).sum(), min=1).to(torch.float32)
    probs = flat[idx] / torch.clamp(total, min=1e-12)
    w = (1.0 / (n_valid * torch.clamp(probs, min=1e-12))) ** beta
    return w / torch.clamp(w.max(), min=1e-12)


class PrioritizedReplayBuffer(BaseReplayBuffer):
    state_attrs = BaseReplayBuffer.state_attrs + ("priorities",
                                                  "max_priority")

    def __init__(self, *args, alpha: float = 0.6, beta: float = 0.4,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.alpha = alpha
        self.beta = beta

    def init(self, example: SamplesToBuffer):
        super().init(example)
        self.priorities = torch.zeros((self.size_T, self.B),
                                      device=self.device)   # p^alpha
        self.max_priority = torch.ones((), device=self.device)  # before alpha

    def append(self, samples: SamplesToBuffer):
        """New rows take the largest priority so far, stored as p^alpha."""
        t0 = self.t
        super().append(samples)
        self.priorities[t0:t0 + self.sample_T] = \
            self.max_priority ** self.alpha

    def _masked_priorities(self) -> torch.Tensor:
        """Priorities with the guard zones around the cursor zeroed, so
        that no invalid row is drawn."""
        base, span = self.valid_window()
        rows = torch.arange(self.size_T, device=self.device)
        offset = (rows - base) % self.size_T
        valid = (offset >= self.off_forward) & (
            offset < span - self.off_backward)
        return torch.where(valid[:, None], self.priorities, 0.0)

    def sample_idxs(self, batch_size: int, generator: torch.Generator):
        """Stratified draws of ``batch_size`` (t, b) pairs.  Returns
        (t_idx, b_idx, is_weights) on the buffer's device."""
        u = torch.rand((batch_size,), generator=generator,
                       device=generator.device).to(self.device)
        return self.idxs_from_uniforms(u)

    def idxs_from_uniforms(self, u: torch.Tensor):
        flat = self._masked_priorities().reshape(-1)
        flat_idx, total = stratified_idxs(flat, u)
        w = importance_weights(flat, flat_idx, total, self.beta)
        return flat_idx // self.B, flat_idx % self.B, w

    def sample(self, batch_size: int, generator: torch.Generator
               ) -> SamplesFromReplay:
        t_idx, b_idx, w, indices = local_draw(
            self.shard, self.lanes, *self.sample_idxs(batch_size, generator))
        return self.extract_batch(t_idx, b_idx, w, indices)

    def update_priorities(self, indices, priorities: torch.Tensor):
        """Write back the update's priorities (|TD error| or KL) at the
        sampled ``indices`` = (t_idx, b_idx).  Under a shard
        (``ShardRows``), every rank's priorities of its rows are gathered
        first, so each rank's copy of the table takes the whole draw's."""
        if isinstance(indices, ShardRows):
            priorities = self.shard.gather_rows(priorities, indices.rows,
                                                indices.t_idx.shape[0])
        t_idx, b_idx = indices[:2]
        p = torch.clamp(priorities, min=1e-6)
        self.priorities[t_idx, b_idx] = p ** self.alpha
        self.max_priority = torch.maximum(self.max_priority, p.max())
