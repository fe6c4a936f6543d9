"""DQN-family models (port of rlpyt_tpu/models/dqn.py: DuelingHead,
DistributionalDuelingHead, AtariDqnModel, AtariCatDqnModel,
AtariR2d1Model, DqnMlpModel, R2d1MlpModel; AtariR2d1Model also takes
IMPALA's residual trunk, which the JAX package does not have).

Accept observations with [], [B] or [T,B] leading dims.  The Atari
models take uint8 images in [C, H, W] layout, scaled by 1/``obs_divisor``
inside the model; the MLP models take vectors of ``input_size`` (or, for
``DqnMlpModel``, a dict of vectors whose sizes sum to it).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rlpyt_tpu_torch.models.conv import Conv2dModel
from rlpyt_tpu_torch.models.mlp import MlpModel
from rlpyt_tpu_torch.models.resnet import (
    IMPALA_BLOCKS,
    IMPALA_CHANNELS,
    IMPALA_FEATURES,
    ImpalaResNet,
)
from rlpyt_tpu_torch.models.rnn import LstmCore, RnnState
from rlpyt_tpu_torch.struct import (
    infer_leading_dims,
    infer_leading_dims_tree,
    restore_leading_dims,
)
from rlpyt_tpu_torch.utils import profiling

# Nature-CNN geometry as rlpyt adapts it to 104x80 frames.
ATARI_CHANNELS = (32, 64, 64)
ATARI_KERNELS = (8, 4, 3)
ATARI_STRIDES = (4, 2, 1)
ATARI_PADDINGS = (0, 1, 1)


class DuelingHead(nn.Module):
    """V + A streams with mean-advantage subtraction, in float32 (each
    stream's MLP casts its output back).  ``adv`` and ``val`` are the
    JAX head's ``MlpModel_0`` and ``MlpModel_1``."""

    def __init__(self, input_size: int, hidden_sizes: Sequence[int],
                 output_size: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.adv = MlpModel(input_size, hidden_sizes, output_size,
                            compute_dtype=compute_dtype)
        self.val = MlpModel(input_size, hidden_sizes, 1,
                            compute_dtype=compute_dtype)

    def forward(self, x):
        adv = self.adv(x)
        return self.val(x) + adv - adv.mean(dim=-1, keepdim=True)


class DistributionalDuelingHead(nn.Module):
    """Dueling over atoms: [N, A, n_atoms] logits, the advantage mean
    taken over actions.  ``adv`` and ``val`` are the JAX head's
    ``MlpModel_0`` and ``MlpModel_1``."""

    def __init__(self, input_size: int, hidden_sizes: Sequence[int],
                 output_size: int, n_atoms: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.output_size = output_size
        self.n_atoms = n_atoms
        self.adv = MlpModel(input_size, hidden_sizes, output_size * n_atoms,
                            compute_dtype=compute_dtype)
        self.val = MlpModel(input_size, hidden_sizes, n_atoms,
                            compute_dtype=compute_dtype)

    def forward(self, x):
        adv = self.adv(x).reshape(x.shape[:-1]
                                  + (self.output_size, self.n_atoms))
        val = self.val(x).reshape(x.shape[:-1] + (1, self.n_atoms))
        return val + adv - adv.mean(dim=-2, keepdim=True)


class AtariDqnModel(nn.Module):
    """Conv trunk -> (dueling) Q head.  Submodule names (``conv.convs.i``,
    ``head.layers.i``, ``head.{adv,val}.layers.i``) are what the weight
    bridge (params.py) maps the flax tree onto."""

    def __init__(self, image_shape: Tuple[int, int, int], n_actions: int,
                 fc_sizes: Sequence[int] = (512,), dueling: bool = False,
                 channels: Sequence[int] = ATARI_CHANNELS,
                 kernel_sizes: Sequence[int] = ATARI_KERNELS,
                 strides: Sequence[int] = ATARI_STRIDES,
                 paddings: Sequence[int] = ATARI_PADDINGS,
                 obs_divisor: float = 255.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        c, h, w = image_shape
        self.conv = Conv2dModel(c, channels, kernel_sizes, strides, paddings,
                                compute_dtype=compute_dtype,
                                input_scale=1.0 / obs_divisor)
        n_feat = Conv2dModel.conv_out_size(channels, kernel_sizes, strides,
                                           paddings, h, w)
        if dueling:
            self.head = DuelingHead(n_feat, fc_sizes, n_actions,
                                    compute_dtype)
        else:
            self.head = MlpModel(n_feat, fc_sizes, n_actions,
                                 compute_dtype=compute_dtype)

    def forward(self, observation, prev_action=None, prev_reward=None):
        lead_dim, T, B, img_shape = infer_leading_dims(observation, 3)
        x = self.conv(observation.reshape((T * B,) + img_shape))
        q = self.head(x.flatten(1))
        return restore_leading_dims(q, lead_dim, T, B)


class AtariCatDqnModel(nn.Module):
    """Distributional (C51) model: conv trunk -> (dueling) head ->
    softmax over atoms, [..., A, n_atoms] probabilities.  Both heads cast
    their logits back to float32 (as the JAX heads do), so the softmax
    runs in float32 under any compute dtype."""

    def __init__(self, image_shape: Tuple[int, int, int], n_actions: int,
                 n_atoms: int = 51, fc_sizes: Sequence[int] = (512,),
                 dueling: bool = False,
                 channels: Sequence[int] = ATARI_CHANNELS,
                 kernel_sizes: Sequence[int] = ATARI_KERNELS,
                 strides: Sequence[int] = ATARI_STRIDES,
                 paddings: Sequence[int] = ATARI_PADDINGS,
                 obs_divisor: float = 255.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        c, h, w = image_shape
        self.n_actions = n_actions
        self.n_atoms = n_atoms
        self.conv = Conv2dModel(c, channels, kernel_sizes, strides, paddings,
                                compute_dtype=compute_dtype,
                                input_scale=1.0 / obs_divisor)
        n_feat = Conv2dModel.conv_out_size(channels, kernel_sizes, strides,
                                           paddings, h, w)
        if dueling:
            self.head = DistributionalDuelingHead(
                n_feat, fc_sizes, n_actions, n_atoms, compute_dtype)
        else:
            self.head = MlpModel(n_feat, fc_sizes, n_actions * n_atoms,
                                 compute_dtype=compute_dtype)

    def forward(self, observation, prev_action=None, prev_reward=None):
        lead_dim, T, B, img_shape = infer_leading_dims(observation, 3)
        x = self.conv(observation.reshape((T * B,) + img_shape))
        logits = self.head(x.flatten(1))
        logits = logits.reshape(T * B, self.n_actions, self.n_atoms)
        return restore_leading_dims(F.softmax(logits, dim=-1), lead_dim, T, B)


class AtariR2d1Model(nn.Module):
    """Conv trunk -> LSTM (with one-hot prev action and prev reward) ->
    (dueling) Q.  ``forward(obs, prev_action, prev_reward, rnn_state,
    done=None)`` returns (q, next_rnn_state); ``done`` ([T, B] or [B])
    resets the state at episode starts inside a training window.

    ``trunk``: ``"nature"``, the Nature CNN of ``channels``,
    ``kernel_sizes``, ``strides`` and ``paddings`` (the JAX model's), or
    ``"resnet"``, IMPALA's residual trunk (``resnet.py``) of ``channels``
    (IMPALA's 16, 32, 32 by default), ``blocks`` residual blocks a
    section and ``feature_size`` features.  Either is ``conv``.

    The LSTM input is built in the compute dtype, as the JAX model builds
    it (``dqn.py:211-214``): under bf16 the prev reward is rounded to
    bf16 before the float32 LSTM.

    While a recorder is on (``utils/profiling.py``), each trunk forward
    is span ``model.trunk``, its backward span ``model.trunk_bwd``, and
    counter ``model.trunk`` counts its calls by (gradient on, frames)."""

    def __init__(self, image_shape: Tuple[int, int, int], n_actions: int,
                 fc_sizes: Sequence[int] = (512,), lstm_size: int = 512,
                 dueling: bool = True,
                 channels: Optional[Sequence[int]] = None,
                 kernel_sizes: Sequence[int] = ATARI_KERNELS,
                 strides: Sequence[int] = ATARI_STRIDES,
                 paddings: Sequence[int] = ATARI_PADDINGS,
                 obs_divisor: float = 255.0,
                 compute_dtype: torch.dtype = torch.float32,
                 trunk: str = "nature", blocks: int = IMPALA_BLOCKS,
                 feature_size: int = IMPALA_FEATURES):
        super().__init__()
        c, h, w = image_shape
        self.n_actions = n_actions
        if trunk == "nature":
            channels = channels or ATARI_CHANNELS
            self.conv = Conv2dModel(c, channels, kernel_sizes, strides,
                                    paddings, compute_dtype=compute_dtype,
                                    input_scale=1.0 / obs_divisor)
            n_feat = Conv2dModel.conv_out_size(channels, kernel_sizes,
                                               strides, paddings, h, w)
        elif trunk == "resnet":
            self.conv = ImpalaResNet(image_shape,
                                     channels or IMPALA_CHANNELS, blocks,
                                     feature_size, obs_divisor,
                                     compute_dtype)
            n_feat = feature_size
        else:
            raise ValueError(f"trunk {trunk!r}: 'nature' or 'resnet'")
        self.lstm = LstmCore(n_feat + n_actions + 1, lstm_size)
        if dueling:
            self.head = DuelingHead(lstm_size, fc_sizes, n_actions,
                                    compute_dtype)
        else:
            self.head = MlpModel(lstm_size, fc_sizes, n_actions,
                                 compute_dtype=compute_dtype)

    def forward(self, observation, prev_action, prev_reward,
                rnn_state: RnnState, done=None):
        lead_dim, T, B, _ = infer_leading_dims(observation, 3)
        lstm_in = self.lstm_input(observation, prev_action, prev_reward)
        done_tb = (torch.zeros((T, B), dtype=torch.bool,
                               device=lstm_in.device)
                   if done is None else done.reshape(T, B))
        y, next_state = self.lstm(lstm_in, done_tb, rnn_state)
        q = self.head(y.flatten(0, 1))
        return restore_leading_dims(q, lead_dim, T, B), next_state

    def lstm_input(self, observation, prev_action, prev_reward):
        """The LSTM's input [T, B, F]: the trunk's features, the one-hot
        previous action and the previous reward."""
        _, T, B, img_shape = infer_leading_dims(observation, 3)
        x = self._trunk(observation.reshape((T * B,) + img_shape))
        x = x.flatten(1).unflatten(0, (T, B))
        pa = F.one_hot(prev_action.reshape(T, B).long(),
                       self.n_actions).to(x.dtype)
        pr = prev_reward.reshape(T, B, 1).to(x.dtype)
        return torch.cat([x, pa, pr], dim=-1)

    def _trunk(self, frames):
        if profiling.active() is None:
            return self.conv(frames)
        grad = torch.is_grad_enabled()
        profiling.count("model.trunk", (grad, frames.shape[0]))
        with profiling.span("model.trunk"):
            x = self.conv(frames)
        return profiling.backward_span(x, list(self.conv.parameters()),
                                       "model.trunk_bwd")


class DqnMlpModel(nn.Module):
    """MLP (or dueling) Q-network for vector observations.  A dict
    observation is flattened leaf by leaf and concatenated in sorted-key
    order (``infer_leading_dims_tree``), as the JAX model does.  ``head``
    is the JAX model's ``MlpModel_0`` or ``DuelingHead_0``."""

    def __init__(self, input_size: int, n_actions: int,
                 hidden_sizes: Sequence[int] = (256, 256),
                 dueling: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if dueling:
            self.head = DuelingHead(input_size, hidden_sizes, n_actions,
                                    compute_dtype)
        else:
            self.head = MlpModel(input_size, hidden_sizes, n_actions,
                                 compute_dtype=compute_dtype)

    def forward(self, observation, prev_action=None, prev_reward=None):
        lead_dim, T, B, x = infer_leading_dims_tree(observation, 1)
        return restore_leading_dims(self.head(x), lead_dim, T, B)


class R2d1MlpModel(nn.Module):
    """MLP -> LSTM (with one-hot prev action and prev reward) ->
    (dueling) Q for vector observations, the small analogue of
    AtariR2d1Model.  ``mlp``, ``lstm`` and ``head`` are the JAX model's
    ``MlpModel_0``, ``LstmCore_0`` and ``MlpModel_1`` (or
    ``DuelingHead_0``)."""

    def __init__(self, input_size: int, n_actions: int,
                 hidden_sizes: Sequence[int] = (64,), lstm_size: int = 64,
                 dueling: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_actions = n_actions
        self.mlp = MlpModel(input_size, hidden_sizes,
                            compute_dtype=compute_dtype)
        self.lstm = LstmCore(hidden_sizes[-1] + n_actions + 1, lstm_size)
        if dueling:
            self.head = DuelingHead(lstm_size, hidden_sizes, n_actions,
                                    compute_dtype)
        else:
            self.head = MlpModel(lstm_size, hidden_sizes, n_actions,
                                 compute_dtype=compute_dtype)

    def forward(self, observation, prev_action, prev_reward,
                rnn_state: RnnState, done=None):
        lead_dim, T, B, _ = infer_leading_dims(observation, 1)
        lstm_in = self.lstm_input(observation, prev_action, prev_reward)
        done_tb = (torch.zeros((T, B), dtype=torch.bool,
                               device=lstm_in.device)
                   if done is None else done.reshape(T, B))
        y, next_state = self.lstm(lstm_in, done_tb, rnn_state)
        q = self.head(y.flatten(0, 1))
        return restore_leading_dims(q, lead_dim, T, B), next_state

    def lstm_input(self, observation, prev_action, prev_reward):
        """The LSTM's input [T, B, F]: the MLP's features, the one-hot
        previous action and the previous reward."""
        _, T, B, obs_shape = infer_leading_dims(observation, 1)
        x = self.mlp(observation.reshape(T, B, obs_shape[0])
                     .to(torch.float32))
        pa = F.one_hot(prev_action.reshape(T, B).long(),
                       self.n_actions).to(x.dtype)
        pr = prev_reward.reshape(T, B, 1).to(x.dtype)
        return torch.cat([x, pa, pr], dim=-1)
