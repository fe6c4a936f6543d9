"""Uniform replay (port of rlpyt_tpu/replay/uniform.py)."""
from __future__ import annotations

import torch

from rlpyt_tpu_torch.replay.base import BaseReplayBuffer, SamplesFromReplay


class UniformReplayBuffer(BaseReplayBuffer):
    def sample(self, batch_size: int, generator: torch.Generator
               ) -> SamplesFromReplay:
        return self.extract_batch(*self.sample_idxs(batch_size, generator))
