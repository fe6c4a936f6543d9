"""Synthetic frame source with Atari geometry (the port's own copy of
``bench_atari.py:make_env``).

Each frame is a pure function of a global frame counter ``t``, so
consecutive K-frame stacks share K-1 frames and episode boundaries zero
the stack exactly as the ALE path's frame stacking does.  That exercises
the frame-compressed replay's reconstruction and masking for real while
costing no host round trip.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rlpyt_tpu_torch.envs.base import Env, EnvStep
from rlpyt_tpu_torch.spaces import IntBox

H, W, K = 104, 80, 4
N_ACTIONS = 6   # ALE Pong action-set size
EP_LEN = 2000   # episodes live on [k*EP_LEN, (k+1)*EP_LEN)


class State(NamedTuple):
    t: torch.Tensor   # [B] int64 global frame counter


class SyntheticAtariEnv(Env):
    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.base = torch.as_tensor(
            np.random.RandomState(0).randint(0, 256, (H, W), np.int32),
            dtype=torch.int64, device=self.device)
        self._lags = torch.arange(K - 1, -1, -1, device=self.device)

    @property
    def observation_space(self):
        return IntBox(0, 256, (K, H, W), torch.uint8)

    @property
    def action_space(self):
        return IntBox(0, N_ACTIONS)

    def stack_at(self, t: torch.Tensor) -> torch.Tensor:
        """[B] counters -> [B, K, H, W] uint8 stacks, oldest frame first,
        zeroed before each lane's episode start."""
        ts = t[:, None] - self._lags                          # [B, K]
        scale = (ts % 251 + 3)[:, :, None, None]
        frames = ((self.base * scale + ts[:, :, None, None] * 13)
                  & 0xFF).to(torch.uint8)
        valid = ts >= (t - t % EP_LEN)[:, None]
        return frames * valid[:, :, None, None].to(torch.uint8)

    def reset_batch(self, n, generator):
        t0 = torch.randint(0, 1000, (n,), generator=generator,
                           device=generator.device).to(self.device) * EP_LEN
        return State(t0), self.stack_at(t0)

    def step_batch(self, state, action, generator=None):
        """Deterministic: draws nothing from ``generator``."""
        t = state.t + 1
        reward = (action == t % N_ACTIONS).to(torch.float32)
        done = t % EP_LEN == 0
        return State(t), EnvStep(self.stack_at(t), reward, done, {})
