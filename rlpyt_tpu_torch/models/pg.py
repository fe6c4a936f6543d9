"""Policy-gradient models (port of rlpyt_tpu/models/pg.py: AtariFfModel,
AtariLstmModel, MujocoFfModel, MujocoLstmModel).

Submodule names are what the weight bridge (params.py) maps the flax
tree onto: ``conv`` (Conv2dModel_0), ``fc`` (MlpModel_0), ``lstm``
(LstmCore_0), ``pi`` (Dense_0) and ``value`` (Dense_1); the Gaussian
models add ``log_std``, the feedforward one's value MLP ``value_mlp``
(MlpModel_1) and its observation statistics ``obs_norm``
(norm_stats/RunningMeanStd_0).  Observations
may have [], [B] or [T, B] leading dims.  The JAX ``lstm_impl`` switch is
not carried over: ``LstmCore`` runs the CUDA kernels on the card and
their plain versions on the CPU.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rlpyt_tpu_torch.models.conv import Conv2dModel
from rlpyt_tpu_torch.models.dqn import (
    ATARI_CHANNELS,
    ATARI_KERNELS,
    ATARI_PADDINGS,
    ATARI_STRIDES,
)
from rlpyt_tpu_torch.models.mlp import MlpModel, lecun_normal_
from rlpyt_tpu_torch.models.rnn import LstmCore, RnnState
from rlpyt_tpu_torch.models.running_norm import RunningMeanStd
from rlpyt_tpu_torch.struct import infer_leading_dims, restore_leading_dims


def dense(n_in: int, n_out: int) -> nn.Linear:
    """A flax ``nn.Dense``: lecun-normal kernel, zero bias."""
    layer = nn.Linear(n_in, n_out)
    lecun_normal_(layer.weight, n_in)
    nn.init.zeros_(layer.bias)
    return layer


class _AtariTrunk(nn.Module):
    """Conv trunk and fc layers shared by both models."""

    def __init__(self, image_shape: Tuple[int, int, int],
                 fc_sizes: Sequence[int], channels: Sequence[int],
                 kernel_sizes: Sequence[int], strides: Sequence[int],
                 paddings: Sequence[int], obs_divisor: float,
                 compute_dtype: torch.dtype):
        super().__init__()
        c, h, w = image_shape
        self.conv = Conv2dModel(c, channels, kernel_sizes, strides, paddings,
                                compute_dtype=compute_dtype,
                                input_scale=1.0 / obs_divisor)
        n_feat = Conv2dModel.conv_out_size(channels, kernel_sizes, strides,
                                           paddings, h, w)
        self.fc = MlpModel(n_feat, fc_sizes, compute_dtype=compute_dtype)
        self.n_out = list(fc_sizes)[-1] if fc_sizes else n_feat

    def features(self, observation):
        """(lead_dim, T, B, [T*B, n_out] float32 features)."""
        lead_dim, T, B, img_shape = infer_leading_dims(observation, 3)
        x = self.conv(observation.reshape((T * B,) + img_shape))
        return lead_dim, T, B, self.fc(x.flatten(1))


class AtariFfModel(_AtariTrunk):
    """Conv trunk -> fc -> pi logits and V."""

    def __init__(self, image_shape: Tuple[int, int, int], n_actions: int,
                 fc_sizes: Sequence[int] = (512,),
                 channels: Sequence[int] = ATARI_CHANNELS,
                 kernel_sizes: Sequence[int] = ATARI_KERNELS,
                 strides: Sequence[int] = ATARI_STRIDES,
                 paddings: Sequence[int] = ATARI_PADDINGS,
                 obs_divisor: float = 255.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(image_shape, fc_sizes, channels, kernel_sizes,
                         strides, paddings, obs_divisor, compute_dtype)
        self.pi = dense(self.n_out, n_actions)
        self.value = dense(self.n_out, 1)

    def forward(self, observation, prev_action=None, prev_reward=None):
        """Returns (pi_logits [..., A], v [...]), float32."""
        lead_dim, T, B, x = self.features(observation)
        return restore_leading_dims((self.pi(x), self.value(x)[..., 0]),
                                    lead_dim, T, B)


class AtariLstmModel(_AtariTrunk):
    """Conv trunk -> fc -> LSTM over [features, one-hot prev action, prev
    reward] -> pi logits and V.  ``forward(obs, prev_action, prev_reward,
    rnn_state, done=None)`` returns (pi_logits, v, next_rnn_state);
    ``done`` [T, B] resets the state before each step of a training
    window."""

    def __init__(self, image_shape: Tuple[int, int, int], n_actions: int,
                 fc_sizes: Sequence[int] = (512,), lstm_size: int = 512,
                 channels: Sequence[int] = ATARI_CHANNELS,
                 kernel_sizes: Sequence[int] = ATARI_KERNELS,
                 strides: Sequence[int] = ATARI_STRIDES,
                 paddings: Sequence[int] = ATARI_PADDINGS,
                 obs_divisor: float = 255.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(image_shape, fc_sizes, channels, kernel_sizes,
                         strides, paddings, obs_divisor, compute_dtype)
        self.n_actions = n_actions
        self.lstm = LstmCore(self.n_out + n_actions + 1, lstm_size)
        self.pi = dense(lstm_size, n_actions)
        self.value = dense(lstm_size, 1)

    def forward(self, observation, prev_action, prev_reward,
                rnn_state: RnnState, done=None):
        lead_dim, T, B, x = self.features(observation)
        x = x.flatten(1).unflatten(0, (T, B))
        pa = F.one_hot(prev_action.reshape(T, B).long(),
                       self.n_actions).to(x.dtype)
        pr = prev_reward.reshape(T, B, 1).to(x.dtype)
        done_tb = (torch.zeros((T, B), dtype=torch.bool, device=x.device)
                   if done is None else done.reshape(T, B))
        y, next_state = self.lstm(torch.cat([x, pa, pr], dim=-1), done_tb,
                                  rnn_state)
        y = y.flatten(0, 1)
        pi, v = restore_leading_dims((self.pi(y), self.value(y)[..., 0]),
                                     lead_dim, T, B)
        return pi, v, next_state


def _broadcast(log_std: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """log_std broadcast to mu's shape as a new tensor: an ``expand``
    view of the parameter would keep requires_grad under no_grad, and a
    collector that stores it would carry the graph into its buffers."""
    return log_std + torch.zeros_like(mu)


class MujocoFfModel(nn.Module):
    """MLP -> Gaussian mu, a state-independent log_std, and a separate
    MLP -> V.  With ``normalize_observation``, observations go through
    ``RunningMeanStd``, whose moments are never folded in, as in the JAX
    package (see models/running_norm.py).  Returns (mu, log_std, v)."""

    def __init__(self, observation_shape: Tuple[int, ...], action_size: int,
                 hidden_sizes: Sequence[int] = (64, 64),
                 init_log_std: float = 0.0,
                 normalize_observation: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        n_obs = math.prod(observation_shape)
        self.obs_norm = (RunningMeanStd(n_obs) if normalize_observation
                         else None)
        self.fc = MlpModel(n_obs, hidden_sizes, compute_dtype=compute_dtype)
        n_out = list(hidden_sizes)[-1] if hidden_sizes else n_obs
        self.pi = dense(n_out, action_size)
        self.value_mlp = MlpModel(n_obs, hidden_sizes, 1,
                                  compute_dtype=compute_dtype)
        self.log_std = nn.Parameter(torch.full((action_size,),
                                               float(init_log_std)))

    def forward(self, observation, prev_action=None, prev_reward=None):
        lead_dim, T, B, _ = infer_leading_dims(observation, 1)
        obs = observation.reshape(T * B, observation.shape[-1])
        if self.obs_norm is not None:
            obs = self.obs_norm(obs)
        obs = obs.to(torch.float32)
        mu = self.pi(self.fc(obs))
        v = self.value_mlp(obs)[..., 0]
        return restore_leading_dims((mu, _broadcast(self.log_std, mu), v),
                                    lead_dim, T, B)


class MujocoLstmModel(nn.Module):
    """MLP -> LSTM over [features, prev action, prev reward] -> Gaussian
    mu and V, with a state-independent log_std.  ``forward(obs,
    prev_action, prev_reward, rnn_state, done=None)`` returns (mu,
    log_std, v, next_rnn_state); ``done`` [T, B] resets the state before
    each step of a training window."""

    def __init__(self, observation_shape: Tuple[int, ...], action_size: int,
                 hidden_sizes: Sequence[int] = (256,), lstm_size: int = 256,
                 init_log_std: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        n_obs = math.prod(observation_shape)
        self.fc = MlpModel(n_obs, hidden_sizes, compute_dtype=compute_dtype)
        n_out = list(hidden_sizes)[-1] if hidden_sizes else n_obs
        self.lstm = LstmCore(n_out + action_size + 1, lstm_size)
        self.pi = dense(lstm_size, action_size)
        self.value = dense(lstm_size, 1)
        self.log_std = nn.Parameter(torch.full((action_size,),
                                               float(init_log_std)))

    def forward(self, observation, prev_action, prev_reward,
                rnn_state: RnnState, done=None):
        lead_dim, T, B, _ = infer_leading_dims(observation, 1)
        x = self.fc(observation.reshape(T, B, observation.shape[-1])
                    .to(torch.float32))
        pa = prev_action.reshape(T, B, prev_action.shape[-1]).to(x.dtype)
        pr = prev_reward.reshape(T, B, 1).to(x.dtype)
        done_tb = (torch.zeros((T, B), dtype=torch.bool, device=x.device)
                   if done is None else done.reshape(T, B))
        y, next_state = self.lstm(torch.cat([x, pa, pr], dim=-1), done_tb,
                                  rnn_state)
        y = y.flatten(0, 1)
        mu = self.pi(y)
        v = self.value(y)[..., 0]
        mu, log_std, v = restore_leading_dims(
            (mu, _broadcast(self.log_std, mu), v), lead_dim, T, B)
        return mu, log_std, v, next_state
