"""Uniform replay (port of rlpyt_tpu/replay/uniform.py)."""
from __future__ import annotations

import torch

from rlpyt_tpu_torch.replay.base import BaseReplayBuffer, SamplesFromReplay, \
    local_draw


class UniformReplayBuffer(BaseReplayBuffer):
    def sample(self, batch_size: int, generator: torch.Generator
               ) -> SamplesFromReplay:
        t_idx, b_idx, indices = local_draw(
            self.shard, self.lanes, *self.sample_idxs(batch_size, generator))
        return self.extract_batch(t_idx, b_idx, indices=indices)
