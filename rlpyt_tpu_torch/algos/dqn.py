"""DQN (port of rlpyt_tpu/algos/dqn.py) on uniform or prioritized
replay of flat observations or, with ``frame_buffer=True``, of
frame-compressed stacks.

Per iteration: append the [T, B] batch to replay, then, once
``min_steps_learn`` env steps have been taken, ``updates_per_optimize``
updates of sample -> TD loss -> grad -> clip -> optimizer step -> target
rule -> priority write-back (prioritized replay only).  The optimizer is
``algos/base.py:make_optimizer``'s: Adam (eps 0.01 / batch_size unless
``optim_kwargs`` names one) or RMSprop (decay, eps and ``centered`` from
``optim_kwargs``), after clip-by-global-norm.
"""
from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import torch

from rlpyt_tpu_torch.algos.base import RlAlgorithm, make_optimizer
from rlpyt_tpu_torch.ops.value import huber_loss, polyak_update
from rlpyt_tpu_torch.replay.base import SamplesFromReplay, SamplesToBuffer
from rlpyt_tpu_torch.replay.frame import (
    PrioritizedFrameReplayBuffer,
    UniformFrameReplayBuffer,
)
from rlpyt_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from rlpyt_tpu_torch.replay.uniform import UniformReplayBuffer
from rlpyt_tpu_torch.struct import select_at_indexes, tree_map, valid_mean


class OptInfo(NamedTuple):
    loss: torch.Tensor
    grad_norm: torch.Tensor
    td_abs_err: torch.Tensor


class DQN(RlAlgorithm):
    def __init__(
        self,
        discount: float = 0.99,
        batch_size: int = 32,
        min_steps_learn: int = int(5e4),
        delta_clip: float = 1.0,
        replay_size: int = int(1e6),
        replay_ratio: float = 8.0,
        target_update_interval: int = 312,
        target_update_tau: float = 1.0,
        n_step_return: int = 1,
        learning_rate: float = 2.5e-4,
        clip_grad_norm: float = 10.0,
        double_dqn: bool = False,
        prioritized_replay: bool = False,
        pri_alpha: float = 0.6,
        pri_beta: float = 0.4,
        frame_buffer: bool = False,
        frames_per_obs: int = 4,
        optim: str = "adam",
        optim_kwargs: Optional[dict] = None,
    ):
        self.discount = discount
        self.batch_size = batch_size
        self.min_steps_learn = min_steps_learn
        self.delta_clip = delta_clip
        self.replay_size = replay_size
        self.replay_ratio = replay_ratio
        self.target_update_interval = target_update_interval
        self.target_update_tau = target_update_tau
        self.n_step = n_step_return
        self.learning_rate = learning_rate
        self.clip_grad_norm = clip_grad_norm
        self.double_dqn = double_dqn
        self.prioritized_replay = prioritized_replay
        self.pri_alpha = pri_alpha
        self.pri_beta = pri_beta
        self.frame_buffer = frame_buffer
        self.frames_per_obs = frames_per_obs
        self.optim = optim
        self.optim_kwargs = dict(optim_kwargs or {})

    def initialize(self, agent, batch_spec, example_obs, generator,
                   n_itr: int = 1):
        """Target network, optimizer and replay.  ``example_obs``: one
        [B, ...] batch of observations ([B, K, H, W] frame stacks under
        ``frame_buffer``)."""
        self.agent = agent
        self.model = agent.model
        self.target_model = copy.deepcopy(agent.model)
        self.target_model.requires_grad_(False)
        self.generator = generator
        self.updates_per_optimize = max(
            1, int(self.replay_ratio * batch_spec.size / self.batch_size))
        okw = dict(self.optim_kwargs)
        if self.optim == "adam":   # rlpyt's Adam epsilon, 0.01 / batch_size
            okw.setdefault("eps", 0.01 / self.batch_size)
        self.optimizer = make_optimizer(
            self.model.parameters(), self.learning_rate,
            self.clip_grad_norm, self.optim, **okw)
        self.update_counter = 0
        # The reference's table: (uniform | prioritized) x (flat | frame).
        kwargs = dict(size=self.replay_size, B=batch_spec.B,
                      sample_T=batch_spec.T, discount=self.discount,
                      n_step_return=self.n_step, device=agent.device)
        if self.prioritized_replay:
            kwargs.update(alpha=self.pri_alpha, beta=self.pri_beta)
        if self.frame_buffer:
            kwargs.update(frames_per_obs=self.frames_per_obs)
            ReplayCls = (PrioritizedFrameReplayBuffer
                         if self.prioritized_replay
                         else UniformFrameReplayBuffer)
        else:
            ReplayCls = (PrioritizedReplayBuffer if self.prioritized_replay
                         else UniformReplayBuffer)
        self.replay = ReplayCls(**kwargs)
        space = agent.env_spaces.action
        dev = agent.device
        self.replay.init(SamplesToBuffer(
            observation=tree_map(lambda x: x[0], example_obs),
            action=space.null_value(dev),
            reward=torch.zeros((), device=dev),
            done=torch.zeros((), dtype=torch.bool, device=dev),
            timeout=torch.zeros((), dtype=torch.bool, device=dev)))

    def samples_to_buffer(self, samples) -> SamplesToBuffer:
        timeout = samples.env_info.get("timeout",
                                       torch.zeros_like(samples.done))
        return SamplesToBuffer(samples.observation, samples.action,
                               samples.reward, samples.done, timeout)

    def loss(self, batch: SamplesFromReplay):
        """TD loss; returns (scalar loss, |delta| per sample: the
        priorities under prioritized replay)."""
        qs = self.agent.q(*batch.agent_inputs)
        q = select_at_indexes(batch.action, qs)
        with torch.no_grad():
            target_qs = self.target_model(*batch.target_inputs)
            if self.double_dqn:
                next_a = torch.argmax(self.agent.q(*batch.target_inputs), -1)
                next_q = select_at_indexes(next_a, target_qs)
            else:
                next_q = target_qs.max(-1).values
            disc = self.discount ** self.n_step
            y = batch.return_ + disc * (
                1.0 - batch.done_n.to(torch.float32)) * next_q
        delta = y - q
        losses = huber_loss(delta, self.delta_clip)
        # Time-limit truncations have no valid bootstrap obs: mask them.
        valid = 1.0 - batch.timeout_n.to(torch.float32)
        losses = losses * batch.is_weights * valid
        td_abs = delta.detach().abs() * valid
        return valid_mean(losses, valid), td_abs

    def update(self, batch: SamplesFromReplay) -> OptInfo:
        """One gradient step on ``batch``, the target rule and, under
        prioritized replay, the priority write-back."""
        loss, td_abs = self.loss(batch)
        self.optimizer.zero_grad()
        loss.backward()
        grad_norm = self.optimizer.step()
        self.update_counter += 1
        if self.target_update_tau < 1.0:
            polyak_update(self.target_model, self.model,
                          self.target_update_tau)
        elif self.update_counter % self.target_update_interval == 0:
            polyak_update(self.target_model, self.model, 1.0)
        if self.prioritized_replay:
            self.replay.update_priorities(batch.indices, td_abs)
        return OptInfo(loss.detach(), grad_norm, td_abs.mean())

    def optimize(self, samples, rollout_state) -> OptInfo:
        """Append, then maybe ``updates_per_optimize`` updates.  Returns
        the mean OptInfo as device scalars (zeros before learning
        starts, as the JAX package reports)."""
        self.replay.append(self.samples_to_buffer(samples))
        if rollout_state.cum_steps < self.min_steps_learn:
            zero = torch.zeros((), device=self.agent.device)
            return OptInfo(zero, zero, zero)
        infos = []
        for _ in range(self.updates_per_optimize):
            batch = self.replay.sample(self.batch_size, self.generator)
            infos.append(self.update(batch))
        return OptInfo(*(torch.stack(x).mean() for x in zip(*infos)))
