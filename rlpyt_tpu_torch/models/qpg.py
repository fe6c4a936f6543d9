"""Q-value policy-gradient models (port of rlpyt_tpu/models/qpg.py:
MuMlpModel, QofMuMlpModel, PiMlpModel, VMlpModel).

Each is one MLP, ``mlp`` (the flax tree's MlpModel_0).  Observations may
have [], [B] or [T, B] leading dims and one feature dim.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from rlpyt_tpu_torch.models.mlp import MlpModel
from rlpyt_tpu_torch.struct import infer_leading_dims, restore_leading_dims


def _flat_obs(observation: torch.Tensor):
    lead_dim, T, B, _ = infer_leading_dims(observation, 1)
    return lead_dim, T, B, observation.reshape(
        T * B, observation.shape[-1]).to(torch.float32)


class MuMlpModel(nn.Module):
    """Deterministic policy output_max * tanh(mlp(s)) (DDPG's and TD3's
    actor)."""

    def __init__(self, observation_shape: Tuple[int, ...], action_size: int,
                 hidden_sizes: Sequence[int] = (256, 256),
                 output_max: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.output_max = output_max
        self.mlp = MlpModel(math.prod(observation_shape), hidden_sizes,
                            action_size, compute_dtype=compute_dtype)

    def forward(self, observation, prev_action=None, prev_reward=None):
        lead_dim, T, B, obs = _flat_obs(observation)
        mu = self.output_max * torch.tanh(self.mlp(obs))
        return restore_leading_dims(mu, lead_dim, T, B)


class QofMuMlpModel(nn.Module):
    """Q(s, a) on [s, a] (the critic of DDPG, TD3 and SAC)."""

    def __init__(self, observation_shape: Tuple[int, ...], action_size: int,
                 hidden_sizes: Sequence[int] = (256, 256),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = MlpModel(math.prod(observation_shape) + action_size,
                            hidden_sizes, 1, compute_dtype=compute_dtype)

    def forward(self, observation, action, prev_action=None,
                prev_reward=None):
        lead_dim, T, B, obs = _flat_obs(observation)
        act = action.reshape(T * B, action.shape[-1]).to(torch.float32)
        q = self.mlp(torch.cat([obs, act], dim=-1))[..., 0]
        return restore_leading_dims(q, lead_dim, T, B)


class PiMlpModel(nn.Module):
    """SAC's policy: (mu, log_std) of the Gaussian before the squash."""

    def __init__(self, observation_shape: Tuple[int, ...], action_size: int,
                 hidden_sizes: Sequence[int] = (256, 256),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = MlpModel(math.prod(observation_shape), hidden_sizes,
                            2 * action_size, compute_dtype=compute_dtype)

    def forward(self, observation, prev_action=None, prev_reward=None):
        lead_dim, T, B, obs = _flat_obs(observation)
        mu, log_std = torch.chunk(self.mlp(obs), 2, dim=-1)
        return restore_leading_dims((mu, log_std), lead_dim, T, B)


class VMlpModel(nn.Module):
    """State value V(s) (the original SAC's V network; the SAC here, as
    the reference's, uses the twin-Q form without it)."""

    def __init__(self, observation_shape: Tuple[int, ...],
                 hidden_sizes: Sequence[int] = (256, 256),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = MlpModel(math.prod(observation_shape), hidden_sizes, 1,
                            compute_dtype=compute_dtype)

    def forward(self, observation, prev_action=None, prev_reward=None):
        lead_dim, T, B, obs = _flat_obs(observation)
        return restore_leading_dims(self.mlp(obs)[..., 0], lead_dim, T, B)
