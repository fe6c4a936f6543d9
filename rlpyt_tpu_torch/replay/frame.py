"""Frame-compressed replay (port of rlpyt_tpu/replay/frame.py:
FrameReplayMixin, UniformFrameReplayBuffer, PrioritizedFrameReplayBuffer).

A K-frame stacked observation [K, H, W] shares K-1 frames with the
previous step, so only the newest frame is stored, as one raw H*W uint8
row per (t, b).  Sampling rebuilds the agent stack at t and the target
stack at t+n from one union window of K+n rows, zeroing the frames that
lie across an episode boundary; the CUDA frame-gather kernel
(ops/frame_gather.py) does that copy.  Rows are not space-to-depth
blocked at insert: the port's first conv reads NCHW frames directly.
"""
from __future__ import annotations

import torch

from rlpyt_tpu_torch.ops.frame_gather import gather_frame_stacks
from rlpyt_tpu_torch.replay.base import SamplesToBuffer
from rlpyt_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from rlpyt_tpu_torch.replay.uniform import UniformReplayBuffer


class FrameReplayMixin:
    """Compose left of a replay class: strips stacks to their newest
    frame at insert and rebuilds them at sample."""

    def __init__(self, *args, frames_per_obs: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        self.frames_per_obs = frames_per_obs
        # Stack reconstruction reads K-1 rows before the sampled one.
        self.off_forward = max(self.off_forward, frames_per_obs - 1)

    def init(self, example: SamplesToBuffer):
        """``example.observation``: one [K, H, W] stack."""
        self._frame_hw = tuple(example.observation.shape[-2:])
        super().init(example._replace(observation=example.observation[-1]))

    def append(self, samples: SamplesToBuffer):
        super().append(samples._replace(
            observation=samples.observation[:, :, -1]))

    def _stack_masks(self, dones_u: torch.Tensor, starts):
        """Validity masks from the union's done rows ``dones_u``
        [batch, U-1] (done at union rows 0..U-2).  A frame at lag j > 0
        behind its stack's newest frame is zeroed when a done lies
        between it and the newest frame: a reverse cumulative any."""
        K = self.frames_per_obs
        ones = torch.ones((dones_u.shape[0], 1), dtype=torch.bool,
                          device=dones_u.device)
        masks = []
        for s in starts:
            seg = dones_u[:, s:s + K - 1].to(torch.int32)
            suffix_any = seg.flip(1).cumsum(1).flip(1) > 0
            masks.append(torch.cat([~suffix_any, ones], dim=1))
        return masks

    def _obs_pair_at(self, t_idx, b_idx):
        """(obs_t, obs_{t+n}) as [batch, K, H, W] uint8 stacks."""
        K, n = self.frames_per_obs, self.n_step
        U = K + n
        start = (t_idx - (K - 1)) % self.size_T
        rows_u = (start[:, None]
                  + torch.arange(U - 1, device=t_idx.device)) % self.size_T
        dones_u = self.data.done[rows_u, b_idx[:, None]]      # [batch, U-1]
        mask_a, mask_t = self._stack_masks(dones_u, (0, n))
        rows_a, rows_t = gather_frame_stacks(
            self.data.observation, start, b_idx.to(start.dtype), mask_a,
            mask_t, K=K, n_step=n)
        shape = (t_idx.shape[0], K) + self._frame_hw
        return rows_a.view(shape), rows_t.view(shape)


class UniformFrameReplayBuffer(FrameReplayMixin, UniformReplayBuffer):
    """Uniform replay over frame-compressed observations."""


class PrioritizedFrameReplayBuffer(FrameReplayMixin, PrioritizedReplayBuffer):
    """Prioritized replay over frame-compressed observations."""
